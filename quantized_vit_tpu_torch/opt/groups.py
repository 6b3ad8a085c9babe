"""Node-group metadata and tensor <-> group-space transforms over a params
tree with flax's paths and layouts (``quantized_vit_tpu/opt/groups.py``).

Every :class:`NodeGroup` carries (param path, Transform) entries saying how
each tensor maps onto its pruning groups. Kernels are [in..., out] (flax),
so the reference's out-axis grouping is OUT (``moveaxis(-1, 0)``) and its
TRANSPOSE is IN.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class Transform(enum.Enum):
    """How a param tensor maps onto its node group's pruning groups."""

    NO_PRUNE = "no_prune"      # quant scalars d/q_m/t: never touched
    OUT = "out"                # group by the last (output) axis
    IN = "in"                  # group by the first (input) axis
    ACCESSORY = "accessory"    # 1-D per-channel params (bias, LN scale)
    QKV_HEADS = "qkv_heads"    # fused qkv [in, 3*H*hd] grouped by head
    HEADS = "heads"            # [in, H*hd] grouped by head


@dataclasses.dataclass(frozen=True)
class ParamEntry:
    """One parameter's membership in a node group; ``path`` is the
    '/'-joined key path of the leaf in the params tree."""

    path: str
    transform: Transform


@dataclasses.dataclass
class NodeGroup:
    """Parameters sharing one structured-pruning decision; ``num_groups``
    is the pruning granularity (out channels, or heads)."""

    id: str
    entries: List[ParamEntry]
    num_groups: int
    num_heads: int = 1           # for QKV_HEADS: H (head_dim = out/(3*H))
    is_prunable: bool = True
    is_auxiliary: bool = False
    auxiliary_ngs: Tuple[Tuple[str, int], ...] = ()


# ---------------------------------------------------------------------------
# tree path access
# ---------------------------------------------------------------------------


def get_path(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def set_path(tree, path: str, value):
    """Functional set: a new tree (new dicts along ``path``) with the leaf
    at ``path`` replaced."""
    keys = path.split("/")

    def rec(node, i):
        out = dict(node)
        if i == len(keys) - 1:
            out[keys[i]] = value
        else:
            out[keys[i]] = rec(node[keys[i]], i + 1)
        return out

    return rec(tree, 0)


def has_path(tree, path: str) -> bool:
    node = tree
    for k in path.split("/"):
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    return True


# ---------------------------------------------------------------------------
# group-space views
# ---------------------------------------------------------------------------


def group_matrix(param: torch.Tensor, transform: Transform, num_groups: int,
                 num_heads: int = 1) -> Optional[torch.Tensor]:
    """``param`` as [num_groups, -1] in group-major order, or None for
    NO_PRUNE."""
    if transform == Transform.NO_PRUNE:
        return None
    if transform in (Transform.ACCESSORY, Transform.IN):
        return param.reshape(num_groups, -1)
    if transform == Transform.OUT:
        return torch.movedim(param, -1, 0).reshape(num_groups, -1)
    if transform == Transform.QKV_HEADS:
        h = num_heads
        if param.ndim == 1:  # bias [3*H*hd]
            hd = param.shape[0] // (3 * h)
            return param.reshape(3, h, hd).permute(1, 0, 2).reshape(h, -1)
        in_dim = param.shape[0]
        hd = param.shape[-1] // (3 * h)
        # [in, 3, H, hd] -> [H, 3, hd, in] -> [H, 3*hd*in]
        return (param.reshape(in_dim, 3, h, hd).permute(2, 1, 3, 0)
                .reshape(h, -1))
    if transform == Transform.HEADS:
        h = num_heads
        if param.ndim == 1:
            return param.reshape(h, -1)
        in_dim = param.shape[0]
        return param.reshape(in_dim, h, -1).permute(1, 2, 0).reshape(h, -1)
    raise ValueError(f"unhandled transform {transform}")


def group_mask_for_param(mask: torch.Tensor, transform: Transform,
                         param_shape: Sequence[int],
                         num_heads: int = 1) -> Optional[torch.Tensor]:
    """A per-group {0,1} mask expanded to broadcast against ``param``."""
    ndim = len(param_shape)
    if transform == Transform.NO_PRUNE:
        return None
    if transform == Transform.ACCESSORY:
        reps = int(np.prod(param_shape)) // mask.shape[0]
        return torch.repeat_interleave(mask, reps).reshape(tuple(param_shape))
    if transform == Transform.OUT:
        # num_groups may be coarser than the axis: each group covers a
        # contiguous run of axis_size/num_groups channels
        run = param_shape[-1] // mask.shape[0]
        m = torch.repeat_interleave(mask, run) if run > 1 else mask
        return m.reshape((1,) * (ndim - 1) + (param_shape[-1],))
    if transform == Transform.IN:
        run = param_shape[0] // mask.shape[0]
        m = torch.repeat_interleave(mask, run) if run > 1 else mask
        return m.reshape((param_shape[0],) + (1,) * (ndim - 1))
    if transform == Transform.QKV_HEADS:
        h = mask.shape[0]
        out = param_shape[-1]
        hd = out // (3 * h)
        m = torch.repeat_interleave(mask, hd).repeat(3)  # (c, h, d) order
        return m.reshape((1,) * (ndim - 1) + (out,))
    if transform == Transform.HEADS:
        h = mask.shape[0]
        out = param_shape[-1]
        m = torch.repeat_interleave(mask, out // h)
        return m.reshape((1,) * (ndim - 1) + (out,))
    raise ValueError(f"unhandled transform {transform}")


def kept_indices_for_axis(kept_groups: np.ndarray, transform: Transform,
                          axis_size: int, num_heads: int = 1,
                          num_groups: Optional[int] = None) -> np.ndarray:
    """Kept group indices -> kept indices along the pruned axis (head
    groups expand to head_dim runs; coarse OUT/IN groups to contiguous
    axis_size/num_groups runs when ``num_groups`` is given)."""
    kept_groups = np.asarray(kept_groups)
    if transform in (Transform.OUT, Transform.IN, Transform.ACCESSORY):
        run = axis_size // num_groups if num_groups else 1
        if run > 1:
            return np.concatenate(
                [g * run + np.arange(run) for g in kept_groups]
            ) if len(kept_groups) else kept_groups
        return kept_groups
    if transform == Transform.QKV_HEADS:
        if len(kept_groups) == 0:
            return kept_groups.astype(np.int64)
        hd = axis_size // (3 * num_heads)
        return np.concatenate([c * num_heads * hd + h * hd + np.arange(hd)
                               for c in range(3) for h in kept_groups])
    if transform == Transform.HEADS:
        if len(kept_groups) == 0:
            return kept_groups.astype(np.int64)
        hd = axis_size // num_heads
        return np.concatenate([h * hd + np.arange(hd) for h in kept_groups])
    raise ValueError(f"unhandled transform {transform}")


def group_sq_norms(group: NodeGroup, tree) -> torch.Tensor:
    """Per-group squared L2 norms summed over the group's entries."""
    total = None
    for e in group.entries:
        if e.transform == Transform.NO_PRUNE:
            continue
        m = group_matrix(get_path(tree, e.path), e.transform,
                         group.num_groups, group.num_heads)
        sq = torch.sum(torch.square(m.to(torch.float32)), dim=1)
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((group.num_groups,))
    return total


def group_cols(group: NodeGroup, tree) -> int:
    """Total columns across the entries' group matrices (the reference's
    ``group_cost``)."""
    cols = 0
    for e in group.entries:
        if e.transform == Transform.NO_PRUNE:
            continue
        shape = get_path(tree, e.path).shape
        cols += int(np.prod(shape)) // group.num_groups
    return max(cols, 1)
