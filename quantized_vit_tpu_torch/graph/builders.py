"""Pruning-dependency node groups of the ViT (``quantized_vit_tpu/graph/
builders.py:vit_node_groups`` and ``mark_unprunable``), declared from the
config over flax's param paths:

- one residual-stream group of every tensor whose out-dim is the
  embedding dim (patch_embed.proj, cls_token, pos_embed, LayerNorms,
  attn.proj and mlp.fc2 outs, the final norm), unprunable;
- per block an attention group over the fused qkv at head granularity
  (Transform.QKV_HEADS) and an MLP hidden group over fc1's out rows;
- pre_logits and head, next to the output: unprunable;
- each quantized layer's d/q_m/t scalars ride along as NO_PRUNE entries.

UltraNet (``ultranet_node_groups``): per conv block a channel group (the
conv kernel's out-dim, BN scale/bias as ACCESSORY); the next conv's
in-dim follows at compression. The final 1x1 conv feeds the YOLO head:
unprunable.

The other model families' builders are not ported yet (ROADMAP.md,
modules to port, 'Other model families, interop, auto-discovery').
"""

from __future__ import annotations

from typing import List, Optional

from ..models.ultranet import ULTRANET_LAYERS, ULTRANET_OUT_CHANNELS
from ..models.vit import ViTConfig
from ..opt.groups import (NodeGroup, ParamEntry, Transform, get_path,
                          has_path)

_QUANT_NAMES = ("d_quant_wt", "q_m_wt", "t_quant_wt",
                "d_quant_act", "q_m_act", "t_quant_act")


def _layer_entries(params, layer: str, kernel_tf: Transform,
                   bias_tf: Transform = Transform.ACCESSORY,
                   with_quant: bool = True) -> List[ParamEntry]:
    out = [ParamEntry(f"{layer}/kernel", kernel_tf)]
    if has_path(params, f"{layer}/bias"):
        out.append(ParamEntry(f"{layer}/bias", bias_tf))
    if with_quant:
        for q in _QUANT_NAMES:
            if has_path(params, f"{layer}/{q}"):
                out.append(ParamEntry(f"{layer}/{q}", Transform.NO_PRUNE))
    return out


def _ln_entries(params, path: str) -> List[ParamEntry]:
    return [ParamEntry(f"{path}/{nm}", Transform.ACCESSORY)
            for nm in ("scale", "bias") if has_path(params, f"{path}/{nm}")]


def vit_node_groups(cfg: ViTConfig, params,
                    unprunable_extra: Optional[List[str]] = None
                    ) -> List[NodeGroup]:
    """Node groups of the VisionTransformer family."""
    unprunable_extra = set(unprunable_extra or [])
    groups: List[NodeGroup] = []

    stream: List[ParamEntry] = []
    stream += _layer_entries(params, "patch_embed/proj", Transform.OUT)
    stream.append(ParamEntry("cls_token", Transform.OUT))
    stream.append(ParamEntry("pos_embed", Transform.OUT))
    for i in range(cfg.depth):
        stream += _ln_entries(params, f"blocks_{i}/norm1")
        stream += _ln_entries(params, f"blocks_{i}/norm2")
        stream += _layer_entries(params, f"blocks_{i}/attn/proj",
                                 Transform.OUT)
        stream += _layer_entries(params, f"blocks_{i}/mlp/fc2", Transform.OUT)
    stream += _ln_entries(params, "norm")
    groups.append(NodeGroup(id="residual_stream", entries=stream,
                            num_groups=cfg.embed_dim, is_prunable=False))

    # per-block sizes from the param shapes (a compressed subnet groups
    # correctly)
    head_dim = cfg.embed_dim // cfg.num_heads
    for i in range(cfg.depth):
        qkv = f"blocks_{i}/attn/qkv"
        heads_i = get_path(params, f"{qkv}/kernel").shape[-1] // (
            3 * head_dim)
        groups.append(NodeGroup(
            id=f"blocks_{i}/attn",
            entries=[
                ParamEntry(f"{qkv}/kernel", Transform.QKV_HEADS),
                *([ParamEntry(f"{qkv}/bias", Transform.QKV_HEADS)]
                  if has_path(params, f"{qkv}/bias") else []),
                *[ParamEntry(f"{qkv}/{q}", Transform.NO_PRUNE)
                  for q in _QUANT_NAMES if has_path(params, f"{qkv}/{q}")],
            ],
            num_groups=heads_i, num_heads=heads_i,
            is_prunable=f"blocks_{i}/attn" not in unprunable_extra))
        groups.append(NodeGroup(
            id=f"blocks_{i}/mlp",
            entries=_layer_entries(params, f"blocks_{i}/mlp/fc1",
                                   Transform.OUT),
            num_groups=get_path(
                params, f"blocks_{i}/mlp/fc1/kernel").shape[-1],
            is_prunable=f"blocks_{i}/mlp" not in unprunable_extra))

    if has_path(params, "pre_logits"):
        groups.append(NodeGroup(
            id="pre_logits",
            entries=_layer_entries(params, "pre_logits", Transform.OUT),
            num_groups=cfg.representation_size or cfg.embed_dim,
            is_prunable=False))
    if has_path(params, "head"):
        groups.append(NodeGroup(
            id="head", entries=_layer_entries(params, "head", Transform.OUT),
            num_groups=cfg.num_classes, is_prunable=False))
    return groups


def ultranet_node_groups(params, batch_stats=None) -> List[NodeGroup]:
    """Channel groups of UltraNet: conv_i's out-channels with bn_i's
    scale/bias. The running statistics live in the ``batch_stats`` tree;
    compression slices them by the same kept indices."""
    groups: List[NodeGroup] = []
    n = len(ULTRANET_LAYERS)
    for i in range(n):
        # the width from the kernel, so a compressed subnet regroups
        feat = get_path(params, f"conv_{i}/kernel").shape[-1]
        entries = [ParamEntry(f"conv_{i}/kernel", Transform.OUT)]
        entries += [ParamEntry(f"bn_{i}/{nm}", Transform.ACCESSORY)
                    for nm in ("scale", "bias")
                    if has_path(params, f"bn_{i}/{nm}")]
        groups.append(NodeGroup(id=f"conv_{i}", entries=entries,
                                num_groups=feat, is_prunable=True))
    entries = [ParamEntry(f"conv_{n}/kernel", Transform.OUT)]
    if has_path(params, f"conv_{n}/bias"):
        entries.append(ParamEntry(f"conv_{n}/bias", Transform.ACCESSORY))
    groups.append(NodeGroup(id=f"conv_{n}", entries=entries,
                            num_groups=ULTRANET_OUT_CHANNELS,
                            is_prunable=False))
    return groups


def mark_unprunable(groups: List[NodeGroup], param_names: List[str]
                    ) -> List[NodeGroup]:
    """Disable pruning for every group with a param path containing one of
    ``param_names``."""
    for g in groups:
        if any(nm in e.path for e in g.entries for nm in param_names):
            g.is_prunable = False
    return groups
