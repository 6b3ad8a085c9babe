"""GETA joint quantization + structured pruning, and the pruning-only
HESSO and HESSO-CRIC, over flax-path params trees (``quantized_vit_tpu/
opt``: groups, importance, the optimizers, checkpoints)."""

from .checkpoint import load_checkpoint, save_checkpoint, scan_checkpoint
from .geta import GETA, GETAConfig
from .groups import (NodeGroup, ParamEntry, Transform, get_path,
                     group_mask_for_param, group_matrix, has_path, set_path)
from .hesso import HESSO, HESSOConfig
from .hesso_cric import HESSOCRIC, HESSOCRICConfig
from .importance import DEFAULT_CRITERIA, combine_importance_scores

__all__ = ["load_checkpoint", "save_checkpoint", "scan_checkpoint", "GETA",
           "GETAConfig", "HESSO", "HESSOConfig", "HESSOCRIC",
           "HESSOCRICConfig", "NodeGroup", "ParamEntry", "Transform",
           "get_path", "group_mask_for_param", "group_matrix", "has_path",
           "set_path", "DEFAULT_CRITERIA", "combine_importance_scores"]
