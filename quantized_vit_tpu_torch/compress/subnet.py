"""Subnet materialization for the ViT (port of
``quantized_vit_tpu/compress/subnet.py:38-141``): slice a group-sparse
params tree into a dense sub-network and a config with per-block widths.

Redundant groups are found by a zero-norm scan in group space; each
block's qkv out rows follow its kept heads, proj's in-dim the same heads,
fc1's out rows the kept hidden units and fc2's in-dim the same units. The
residual stream and the head are unprunable. UltraNet's subnet
(``construct_subnet_ultranet``, ``compress/subnet.py:278``) slices each
conv's out-channels, its BN's params and running statistics, and the next
conv's in-dim. The other model families' subnets are not ported
(ROADMAP.md, modules to port, 'Other model families, interop,
auto-discovery').
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.ultranet import ULTRANET_LAYERS
from ..models.vit import ViTConfig
from ..opt.groups import (NodeGroup, Transform, get_path, group_sq_norms,
                          has_path, kept_indices_for_axis, set_path)


def kept_groups(group: NodeGroup, params, tol: float = 0.0) -> np.ndarray:
    """Indices of non-zero (kept) groups by L2-norm scan (zero norm =>
    redundant)."""
    norms = torch.sqrt(group_sq_norms(group, params)).detach().cpu().numpy()
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


def construct_subnet_ultranet(params, groups: Sequence[NodeGroup],
                              batch_stats: Optional[Any] = None
                              ) -> Tuple[Tuple[int, ...], Any,
                                         Optional[Any]]:
    """Slice UltraNet's conv channels: conv_i's out-dim, bn_i's scale,
    bias and running statistics, and conv_{i+1}'s in-dim. Returns
    (per-conv widths, params, batch_stats)."""
    by_id = {g.id: g for g in groups}
    n = len(ULTRANET_LAYERS)
    channels: List[int] = []
    prev_idx = None
    for i in range(n + 1):
        if prev_idx is not None:
            params = _slice_layer_in(params, f"conv_{i}", prev_idx)
        if i == n:
            break
        g = by_id.get(f"conv_{i}")
        feat = get_path(params, f"conv_{i}/kernel").shape[-1]
        idx = (_kept_nonempty(g, params) if g is not None and g.is_prunable
               else np.arange(feat))
        channels.append(len(idx))
        params = _slice_layer_out(params, f"conv_{i}", idx)
        for nm in ("scale", "bias"):
            if has_path(params, f"bn_{i}/{nm}"):
                params = set_path(params, f"bn_{i}/{nm}", _take(
                    get_path(params, f"bn_{i}/{nm}"), idx, 0))
        if batch_stats is not None:
            for nm in ("mean", "var"):
                if has_path(batch_stats, f"bn_{i}/{nm}"):
                    batch_stats = set_path(batch_stats, f"bn_{i}/{nm}", _take(
                        get_path(batch_stats, f"bn_{i}/{nm}"), idx, 0))
        prev_idx = idx
    return tuple(channels), params, batch_stats
