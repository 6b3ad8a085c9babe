"""Node groups of the ViT, its cost model and the OTO facade
(``quantized_vit_tpu/graph``, the ViT branch)."""

from .builders import mark_unprunable, vit_node_groups
from .costs import vit_cost_report
from .oto import OTO

__all__ = ["mark_unprunable", "vit_node_groups", "vit_cost_report", "OTO"]
