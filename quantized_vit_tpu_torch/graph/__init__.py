"""Node groups of the ViT and the OTO facade (``quantized_vit_tpu/graph``,
the ViT branch)."""

from .builders import mark_unprunable, vit_node_groups
from .oto import OTO

__all__ = ["mark_unprunable", "vit_node_groups", "OTO"]
