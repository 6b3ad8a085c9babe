"""Subnet materialization for the ViT (port of
``quantized_vit_tpu/compress/subnet.py:38-141``): slice a group-sparse
params tree into a dense sub-network and a config with per-block widths.

Redundant groups are found by a zero-norm scan in group space; each
block's qkv out rows follow its kept heads, proj's in-dim the same heads,
fc1's out rows the kept hidden units and fc2's in-dim the same units. The
residual stream and the head are unprunable. The other model families'
subnets are not ported (ROADMAP.md, modules to port, 'Other model
families, interop, auto-discovery'); UltraNet's layer table comes with
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from ..models.vit import ViTConfig
from ..opt.groups import (NodeGroup, Transform, get_path, group_sq_norms,
                          has_path, kept_indices_for_axis, set_path)


def kept_groups(group: NodeGroup, params, tol: float = 0.0) -> np.ndarray:
    """Indices of non-zero (kept) groups by L2-norm scan (zero norm =>
    redundant)."""
    norms = torch.sqrt(group_sq_norms(group, params)).cpu().numpy()
    return np.nonzero(norms > tol)[0]


def _kept_nonempty(group: NodeGroup, params) -> np.ndarray:
    """:func:`kept_groups`, but never empty: a block whose groups all went
    to zero keeps one (all-zero) group, so the architecture stays
    well-formed and the forward is unchanged."""
    kept = kept_groups(group, params)
    return kept if len(kept) else np.arange(1)


def _take(arr, idx: np.ndarray, axis: int):
    return torch.index_select(
        arr, axis % arr.ndim,
        torch.as_tensor(np.asarray(idx, np.int64), device=arr.device))


def _slice_layer_out(params, layer: str, idx: np.ndarray):
    """Slice a Dense/Conv layer's out-dim (kernel last axis + bias)."""
    params = set_path(params, f"{layer}/kernel",
                      _take(get_path(params, f"{layer}/kernel"), idx, -1))
    if has_path(params, f"{layer}/bias"):
        params = set_path(params, f"{layer}/bias",
                          _take(get_path(params, f"{layer}/bias"), idx, 0))
    return params


def _slice_layer_in(params, layer: str, idx: np.ndarray, axis: int = 0):
    """Slice a layer's in-dim (kernel first axis for Dense, axis 2 for
    conv HWIO)."""
    k = get_path(params, f"{layer}/kernel")
    ax = axis if k.ndim == 2 else 2
    return set_path(params, f"{layer}/kernel", _take(k, idx, ax))


def construct_subnet_vit(cfg: ViTConfig, params,
                         groups: Sequence[NodeGroup]
                         ) -> Tuple[ViTConfig, Any]:
    """Physically slice a group-sparse ViT into a dense sub-network:
    (config with ``heads_per_block`` and ``hidden_per_block``, params).
    Per-block head counts come from the param shapes, so a compressed
    model compresses again."""
    by_id = {g.id: g for g in groups}
    heads_pb: List[int] = []
    hidden_pb: List[int] = []
    head_dim = cfg.embed_dim // cfg.num_heads

    for i in range(cfg.depth):
        attn_g = by_id.get(f"blocks_{i}/attn")
        qkv = f"blocks_{i}/attn/qkv"
        out_dim = get_path(params, f"{qkv}/kernel").shape[-1]
        heads_i = out_dim // (3 * head_dim)
        if attn_g is not None and attn_g.is_prunable:
            kept_h = _kept_nonempty(attn_g, params)
        else:
            kept_h = np.arange(heads_i)
        heads_pb.append(len(kept_h))
        out_idx = kept_indices_for_axis(kept_h, Transform.QKV_HEADS,
                                        out_dim, heads_i)
        params = _slice_layer_out(params, qkv, out_idx)
        in_dim = get_path(params, f"blocks_{i}/attn/proj/kernel").shape[0]
        in_idx = kept_indices_for_axis(kept_h, Transform.HEADS, in_dim,
                                       heads_i)
        params = _slice_layer_in(params, f"blocks_{i}/attn/proj", in_idx)

        mlp_g = by_id.get(f"blocks_{i}/mlp")
        if mlp_g is not None and mlp_g.is_prunable:
            kept_m = _kept_nonempty(mlp_g, params)
        else:
            kept_m = np.arange(int(cfg.embed_dim * cfg.mlp_ratio))
        hidden_pb.append(len(kept_m))
        params = _slice_layer_out(params, f"blocks_{i}/mlp/fc1", kept_m)
        params = _slice_layer_in(params, f"blocks_{i}/mlp/fc2", kept_m)

    new_cfg = dataclasses.replace(cfg, heads_per_block=tuple(heads_pb),
                                  hidden_per_block=tuple(hidden_pb))
    return new_cfg, params
