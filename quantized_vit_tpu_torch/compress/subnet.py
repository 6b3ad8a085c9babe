"""Subnet materialization for the ViT (port of
``quantized_vit_tpu/compress/subnet.py:38-141``): slice a group-sparse
params tree into a dense sub-network and a config with per-block widths.

Redundant groups are found by a zero-norm scan in group space; each
block's qkv out rows follow its kept heads, proj's in-dim the same heads,
fc1's out rows the kept hidden units and fc2's in-dim the same units. The
residual stream and the head are unprunable. UltraNet's subnet
(``construct_subnet_ultranet``, ``compress/subnet.py:278``) slices each
conv's out-channels, its BN's params and running statistics, and the next
conv's in-dim. The other families (``compress/subnet.py:143-277``,
``:323-465``): ResNet (each stage's stream and each block's conv1, BN
running statistics sliced with their conv), MobileNet (a depthwise
kernel's channels with its producer's), the separate-q/k/v Transformer
(q, k, v and proj's in-dim by kept kv heads, ``heads_per_block`` counted
in query heads; SwiGLU's gate rows with fc1's) and the conv autoencoder
(whole GroupNorm groups; a U-Net concat's in-dim is the kept channels of
both its segments, the second offset by the first's original width).
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


def _kept_or_all(by_id, params, gid: str, full: int) -> np.ndarray:
    """The kept groups of the prunable group ``gid``, else all ``full``."""
    g = by_id.get(gid)
    if g is not None and g.is_prunable:
        return _kept_nonempty(g, params)
    return np.arange(full)


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
        qkv = f"blocks_{i}/attn/qkv"
        out_dim = get_path(params, f"{qkv}/kernel").shape[-1]
        heads_i = out_dim // (3 * head_dim)
        kept_h = _kept_or_all(by_id, params, f"blocks_{i}/attn", heads_i)
        heads_pb.append(len(kept_h))
        out_idx = kept_indices_for_axis(kept_h, Transform.QKV_HEADS,
                                        out_dim, heads_i)
        params = _slice_layer_out(params, qkv, out_idx)
        in_dim = get_path(params, f"blocks_{i}/attn/proj/kernel").shape[0]
        in_idx = kept_indices_for_axis(kept_h, Transform.HEADS, in_dim,
                                       heads_i)
        params = _slice_layer_in(params, f"blocks_{i}/attn/proj", in_idx)

        kept_m = _kept_or_all(by_id, params, f"blocks_{i}/mlp",
                              int(cfg.embed_dim * cfg.mlp_ratio))
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
        feat = get_path(params, f"conv_{i}/kernel").shape[-1]
        idx = _kept_or_all(by_id, params, f"conv_{i}", feat)
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


def _slice_bn(tree, bn: str, idx: np.ndarray):
    """Slice a BatchNorm's scale/bias (a params tree) or running mean/var
    (a ``batch_stats`` tree) by the kept channels."""
    for nm in ("scale", "bias", "mean", "var"):
        if tree is not None and has_path(tree, f"{bn}/{nm}"):
            tree = set_path(tree, f"{bn}/{nm}",
                            _take(get_path(tree, f"{bn}/{nm}"), idx, 0))
    return tree


def construct_subnet_resnet(cfg, params, groups: Sequence[NodeGroup],
                            batch_stats: Optional[Any] = None):
    """Slice a group-sparse ResNet into a dense subnet. In-dims: conv2 <-
    its block's conv1 group; a stage's first block's conv1 and
    downsample conv <- the previous stage's stream (stage 0: its own,
    which holds the stem); later blocks' conv1 <- their stage's stream;
    the head <- the last stream. Returns (config with ``widths``,
    ``stem_width`` and ``inner_widths``, params, batch_stats)."""
    by_id = {g.id: g for g in groups}
    stream_kept = [_kept_or_all(by_id, params, f"stream_{s}", w)
                   for s, w in enumerate(cfg.widths)]
    new_widths = tuple(len(k) for k in stream_kept)
    inner: List[List[int]] = []

    params = _slice_layer_out(params, "stem_conv", stream_kept[0])
    params = _slice_bn(params, "stem_bn", stream_kept[0])
    batch_stats = _slice_bn(batch_stats, "stem_bn", stream_kept[0])
    for s, n_blocks in enumerate(cfg.stage_sizes):
        inner.append([])
        in_stream = stream_kept[s - 1] if s > 0 else stream_kept[0]
        for b in range(n_blocks):
            blk = f"stage{s}_block{b}"
            blk_in = in_stream if b == 0 else stream_kept[s]
            kept_inner = _kept_or_all(by_id, params, blk,
                                      cfg.block_inner(s, b))
            inner[-1].append(len(kept_inner))
            params = _slice_layer_in(params, f"{blk}/conv1", blk_in)
            params = _slice_layer_out(params, f"{blk}/conv1", kept_inner)
            params = _slice_bn(params, f"{blk}/bn1", kept_inner)
            batch_stats = _slice_bn(batch_stats, f"{blk}/bn1", kept_inner)
            params = _slice_layer_in(params, f"{blk}/conv2", kept_inner)
            params = _slice_layer_out(params, f"{blk}/conv2", stream_kept[s])
            params = _slice_bn(params, f"{blk}/bn2", stream_kept[s])
            batch_stats = _slice_bn(batch_stats, f"{blk}/bn2", stream_kept[s])
            if has_path(params, f"{blk}/down_conv/kernel"):
                params = _slice_layer_in(params, f"{blk}/down_conv", blk_in)
                params = _slice_layer_out(params, f"{blk}/down_conv",
                                          stream_kept[s])
                params = _slice_bn(params, f"{blk}/down_bn", stream_kept[s])
                batch_stats = _slice_bn(batch_stats, f"{blk}/down_bn",
                                        stream_kept[s])
    params = _slice_layer_in(params, "head", stream_kept[-1])

    new_cfg = dataclasses.replace(
        cfg, widths=new_widths, stem_width=new_widths[0],
        inner_widths=tuple(tuple(x) for x in inner))
    return new_cfg, params, batch_stats


def construct_subnet_mobilenet(cfg, params, groups: Sequence[NodeGroup],
                               batch_stats: Optional[Any] = None):
    """Slice a group-sparse MobileNet into a dense subnet: group i's kept
    channels cut the producing conv's out-dim and BN, the next depthwise
    kernel's channel axis and its BN, and the next pointwise conv's
    in-dim; the head's in-dim follows the last pointwise group. Returns
    (config, params, batch_stats)."""
    by_id = {g.id: g for g in groups}

    def slice_channel_group(producer, bn, dw_idx, idx):
        nonlocal params, batch_stats
        params = _slice_layer_out(params, producer, idx)
        params = _slice_bn(params, bn, idx)
        batch_stats = _slice_bn(batch_stats, bn, idx)
        if dw_idx is not None:
            params = _slice_layer_out(params, f"dw_{dw_idx}", idx)
            params = _slice_bn(params, f"dw_bn_{dw_idx}", idx)
            batch_stats = _slice_bn(batch_stats, f"dw_bn_{dw_idx}", idx)

    n = len(cfg.widths)
    stem_kept = _kept_or_all(by_id, params, "stem", cfg.stem_width)
    slice_channel_group("stem_conv", "stem_bn", 0, stem_kept)
    params = _slice_layer_in(params, "pw_0", stem_kept)
    pw_kept = []
    for i in range(n):
        idx = _kept_or_all(by_id, params, f"pw_{i}", cfg.widths[i])
        pw_kept.append(idx)
        nxt = i + 1 if i + 1 < n else None
        slice_channel_group(f"pw_{i}", f"pw_bn_{i}", nxt, idx)
        if nxt is not None:
            params = _slice_layer_in(params, f"pw_{nxt}", idx)
    params = _slice_layer_in(params, "head", pw_kept[-1])

    new_cfg = dataclasses.replace(cfg, stem_width=len(stem_kept),
                                  widths=tuple(len(k) for k in pw_kept))
    return new_cfg, params, batch_stats


def construct_subnet_transformer(cfg, params, groups: Sequence[NodeGroup]):
    """Slice a group-sparse separate-q/k/v encoder. Per block q, k and v
    keep the same kv heads (q each kept kv head's q_per_kv * head_dim
    run, k and v its head_dim run), proj's in-dim follows q, fc1's
    kept hidden units cut fc1's (and SwiGLU's gate's) out-rows and fc2's
    in-dim. Returns (config with ``heads_per_block`` in query heads and
    ``hidden_per_block``, params)."""
    by_id = {g.id: g for g in groups}
    heads_pb: List[int] = []
    hidden_pb: List[int] = []
    g_ratio = cfg.num_heads // cfg.kv_heads
    head_dim = cfg.embed_dim // cfg.num_heads
    for i in range(cfg.depth):
        kv_i = get_path(
            params, f"blocks_{i}/attn/k/kernel").shape[-1] // head_dim
        kept_h = _kept_or_all(by_id, params, f"blocks_{i}/attn", kv_i)
        heads_pb.append(len(kept_h) * g_ratio)
        for nm in ("q", "k", "v"):
            layer = f"blocks_{i}/attn/{nm}"
            out_dim = get_path(params, f"{layer}/kernel").shape[-1]
            params = _slice_layer_out(params, layer, kept_indices_for_axis(
                kept_h, Transform.HEADS, out_dim, kv_i))
        in_dim = get_path(params, f"blocks_{i}/attn/proj/kernel").shape[0]
        params = _slice_layer_in(
            params, f"blocks_{i}/attn/proj",
            kept_indices_for_axis(kept_h, Transform.HEADS, in_dim, kv_i))

        kept_m = _kept_or_all(by_id, params, f"blocks_{i}/mlp",
                              int(cfg.embed_dim * cfg.mlp_ratio))
        hidden_pb.append(len(kept_m))
        params = _slice_layer_out(params, f"blocks_{i}/fc1", kept_m)
        if has_path(params, f"blocks_{i}/gate/kernel"):
            params = _slice_layer_out(params, f"blocks_{i}/gate", kept_m)
        params = _slice_layer_in(params, f"blocks_{i}/fc2", kept_m)

    new_cfg = dataclasses.replace(cfg, heads_per_block=tuple(heads_pb),
                                  hidden_per_block=tuple(hidden_pb))
    return new_cfg, params


def construct_subnet_autoencoder(cfg, params, groups: Sequence[NodeGroup]):
    """Slice a group-sparse ConvAutoencoder: kept norm groups expand to
    contiguous channel runs; each layer's in-dim follows the previous
    layer's kept channels, and a U-Net concat's in-dim is [kept(dec_i),
    decoder_widths[i] + kept(enc_mirror)]; the output conv's in-dim only.
    Returns (config with the kept widths and norm-group counts, params)."""
    by_id = {g.id: g for g in groups}
    enc_widths: List[int] = []
    dec_widths: List[int] = []
    enc_groups: List[int] = []
    dec_groups: List[int] = []
    prev_idx: Optional[np.ndarray] = None

    def process(layer: str, gn: str, norm_groups: int, p, prev_idx):
        width = get_path(p, f"{layer}/kernel").shape[-1]
        kg = _kept_or_all(by_id, p, layer, norm_groups)
        idx = kept_indices_for_axis(kg, Transform.OUT, width,
                                    num_groups=norm_groups)
        if prev_idx is not None:
            p = _slice_layer_in(p, layer, prev_idx)
        p = _slice_layer_out(p, layer, idx)
        for nm in ("scale", "bias"):
            if has_path(p, f"{gn}/{nm}"):
                p = set_path(p, f"{gn}/{nm}",
                             _take(get_path(p, f"{gn}/{nm}"), idx, 0))
        return p, idx, len(kg)

    enc_idx: List[np.ndarray] = []
    for i in range(len(cfg.widths)):
        params, prev_idx, n_kept = process(
            f"enc_{i}", f"enc_gn_{i}", cfg.enc_groups(i), params, prev_idx)
        enc_widths.append(len(prev_idx))
        enc_groups.append(n_kept)
        enc_idx.append(prev_idx)
    n_enc = len(cfg.widths)
    for i in range(len(cfg.decoder_widths)):
        params, prev_idx, n_kept = process(
            f"dec_{i}", f"dec_gn_{i}", cfg.dec_groups(i), params, prev_idx)
        dec_widths.append(len(prev_idx))
        dec_groups.append(n_kept)
        mirror = n_enc - 2 - i
        if cfg.skip_concat and mirror >= 0:
            # the concat's second segment starts at this stage's original
            # width
            prev_idx = np.concatenate([prev_idx, cfg.decoder_widths[i]
                                       + enc_idx[mirror]])
    params = _slice_layer_in(params, "out_conv", prev_idx)

    new_cfg = dataclasses.replace(
        cfg, widths=tuple(enc_widths), dec_widths=tuple(dec_widths),
        enc_norm_groups=tuple(enc_groups), dec_norm_groups=tuple(dec_groups))
    return new_cfg, params
