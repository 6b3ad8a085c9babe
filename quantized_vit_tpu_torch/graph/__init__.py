"""Node groups of the ViT and UltraNet, their cost models and the OTO
facade (``quantized_vit_tpu/graph``, the ViT and UltraNet branches)."""

from .builders import mark_unprunable, ultranet_node_groups, vit_node_groups
from .costs import ultranet_cost_report, vit_cost_report
from .oto import OTO

__all__ = ["mark_unprunable", "ultranet_node_groups", "vit_node_groups",
           "ultranet_cost_report", "vit_cost_report", "OTO"]
