"""GETA joint quantization + structured pruning over flax-path params
trees (``quantized_vit_tpu/opt``: groups, importance, GETA, checkpoints).
HESSO and HESSO-CRIC are not ported yet (ROADMAP.md A8)."""

from .checkpoint import load_checkpoint, save_checkpoint, scan_checkpoint
from .geta import GETA, GETAConfig
from .groups import (NodeGroup, ParamEntry, Transform, get_path,
                     group_mask_for_param, group_matrix, has_path, set_path)
from .importance import DEFAULT_CRITERIA, combine_importance_scores

__all__ = ["load_checkpoint", "save_checkpoint", "scan_checkpoint", "GETA",
           "GETAConfig", "NodeGroup", "ParamEntry", "Transform", "get_path",
           "group_mask_for_param", "group_matrix", "has_path", "set_path",
           "DEFAULT_CRITERIA", "combine_importance_scores"]
