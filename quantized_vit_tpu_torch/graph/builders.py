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

The other families (``builders.py:170-396``), each a case of the
reference's pruning-dependency partition that the ViT and UltraNet lack:
ResNet (a stage's residual additions are one connected component, so
every conv feeding them shares one decision), MobileNet (a depthwise conv
merges into its producer's group), the separate-q/k/v Transformer (one
head group over three projections, at kv-head granularity under GQA;
SwiGLU's gate and up share one decision), the conv autoencoder (groups of
whole GroupNorm groups; transposed convs prune their out-channels as a
conv), and LoRA layers (``lora_b`` prunes with its base, ``lora_a`` is
NO_PRUNE). Per-block sizes come from the param shapes, so a compressed
model regroups.
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


def lora_layer_entries(params, layer: str) -> List[ParamEntry]:
    """Entries of a LoraDense layer: the base kernel and ``lora_b`` prune
    their out-columns together, ``lora_a`` is NO_PRUNE, the bias rides as
    ACCESSORY."""
    out = [ParamEntry(f"{layer}/kernel", Transform.OUT),
           ParamEntry(f"{layer}/lora_b", Transform.OUT),
           ParamEntry(f"{layer}/lora_a", Transform.NO_PRUNE)]
    if has_path(params, f"{layer}/bias"):
        out.append(ParamEntry(f"{layer}/bias", Transform.ACCESSORY))
    return out


def lora_embedding_entries(params, layer: str) -> List[ParamEntry]:
    """Entries of a LoraEmbedding layer: the base table and ``lora_b``
    prune the feature axis together (last in flax's layout: OUT);
    ``lora_a`` is NO_PRUNE."""
    return [ParamEntry(f"{layer}/embedding", Transform.OUT),
            ParamEntry(f"{layer}/lora_b", Transform.OUT),
            ParamEntry(f"{layer}/lora_a", Transform.NO_PRUNE)]


def resnet_node_groups(cfg, params) -> List[NodeGroup]:
    """Node groups of the residual CNN: per stage one ``stream_{s}`` group
    of every conv feeding its skip sums (conv2 of each block, the stage's
    downsample conv, the stem in stage 0) with their BNs; per block a
    ``stage{s}_block{b}`` group of conv1's out-channels (conv2's in-dim
    follows at compression); the head, next to the output, unprunable."""
    groups: List[NodeGroup] = []
    for s, (n_blocks, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        stream: List[ParamEntry] = []
        if s == 0:
            stream += _layer_entries(params, "stem_conv", Transform.OUT)
            stream += _ln_entries(params, "stem_bn")
        for b in range(n_blocks):
            blk = f"stage{s}_block{b}"
            groups.append(NodeGroup(
                id=blk,
                entries=(_layer_entries(params, f"{blk}/conv1",
                                        Transform.OUT)
                         + _ln_entries(params, f"{blk}/bn1")),
                num_groups=cfg.block_inner(s, b), is_prunable=True))
            stream += _layer_entries(params, f"{blk}/conv2", Transform.OUT)
            stream += _ln_entries(params, f"{blk}/bn2")
            if has_path(params, f"{blk}/down_conv/kernel"):
                stream += _layer_entries(params, f"{blk}/down_conv",
                                         Transform.OUT)
                stream += _ln_entries(params, f"{blk}/down_bn")
        groups.append(NodeGroup(id=f"stream_{s}", entries=stream,
                                num_groups=width, is_prunable=True))
    groups.append(NodeGroup(
        id="head", entries=_layer_entries(params, "head", Transform.OUT),
        num_groups=cfg.num_classes, is_prunable=False))
    return groups


def mobilenet_node_groups(cfg, params) -> List[NodeGroup]:
    """Node groups of the depthwise-separable CNN: each group spans the
    producing conv's out-channels and BN, the next depthwise kernel's
    channel axis ([k, k, 1, C]: last, OUT) and its BN; the next pointwise
    conv's in-dim follows at compression. The head is unprunable."""
    groups: List[NodeGroup] = []
    n = len(cfg.widths)

    def channel_group(gid, producer, producer_bn, width, dw=None):
        entries = _layer_entries(params, producer, Transform.OUT)
        entries += _ln_entries(params, producer_bn)
        if dw is not None:
            entries += _layer_entries(params, f"dw_{dw}", Transform.OUT)
            entries += _ln_entries(params, f"dw_bn_{dw}")
        return NodeGroup(id=gid, entries=entries, num_groups=width,
                         is_prunable=True)

    groups.append(channel_group(
        "stem", "stem_conv", "stem_bn",
        get_path(params, "stem_conv/kernel").shape[-1], dw=0))
    for i in range(n):
        groups.append(channel_group(
            f"pw_{i}", f"pw_{i}", f"pw_bn_{i}",
            get_path(params, f"pw_{i}/kernel").shape[-1],
            dw=i + 1 if i + 1 < n else None))
    groups.append(NodeGroup(
        id="head", entries=_layer_entries(params, "head", Transform.OUT),
        num_groups=cfg.num_classes, is_prunable=False))
    return groups


def transformer_node_groups(cfg, params) -> List[NodeGroup]:
    """Node groups of the separate-q/k/v encoder: the residual stream
    (token and position embeddings, LayerNorms, proj and fc2 outs),
    unprunable; per block one head group over q, k and v together at
    kv-head granularity (a kv head with its whole query group; the kv
    count from the k kernel's shape, so a compressed model regroups),
    proj's in-dim following at compression; per block an MLP group over
    fc1's out-rows and, under SwiGLU, gate's; the head unprunable."""
    groups: List[NodeGroup] = []
    stream: List[ParamEntry] = [
        ParamEntry("embed/embedding", Transform.OUT),
        ParamEntry("pos_embed", Transform.OUT)]
    for i in range(cfg.depth):
        stream += _ln_entries(params, f"blocks_{i}/norm1")
        stream += _ln_entries(params, f"blocks_{i}/norm2")
        stream += _layer_entries(params, f"blocks_{i}/attn/proj",
                                 Transform.OUT)
        stream += _layer_entries(params, f"blocks_{i}/fc2", Transform.OUT)
    stream += _ln_entries(params, "norm")
    groups.append(NodeGroup(id="residual_stream", entries=stream,
                            num_groups=cfg.embed_dim, is_prunable=False))

    head_dim = cfg.embed_dim // cfg.num_heads
    for i in range(cfg.depth):
        kv_i = get_path(
            params, f"blocks_{i}/attn/k/kernel").shape[-1] // head_dim
        entries: List[ParamEntry] = []
        for nm in ("q", "k", "v"):
            layer = f"blocks_{i}/attn/{nm}"
            entries.append(ParamEntry(f"{layer}/kernel", Transform.HEADS))
            if has_path(params, f"{layer}/bias"):
                entries.append(ParamEntry(f"{layer}/bias", Transform.HEADS))
            entries += [ParamEntry(f"{layer}/{q}", Transform.NO_PRUNE)
                        for q in _QUANT_NAMES
                        if has_path(params, f"{layer}/{q}")]
        groups.append(NodeGroup(id=f"blocks_{i}/attn", entries=entries,
                                num_groups=kv_i, num_heads=kv_i,
                                is_prunable=True))
        mlp = _layer_entries(params, f"blocks_{i}/fc1", Transform.OUT)
        if has_path(params, f"blocks_{i}/gate"):
            mlp += _layer_entries(params, f"blocks_{i}/gate", Transform.OUT)
        groups.append(NodeGroup(
            id=f"blocks_{i}/mlp", entries=mlp,
            num_groups=get_path(params, f"blocks_{i}/fc1/kernel").shape[-1],
            is_prunable=True))

    if has_path(params, "head/kernel"):
        groups.append(NodeGroup(
            id="head", entries=_layer_entries(params, "head", Transform.OUT),
            num_groups=cfg.num_classes, is_prunable=False))
    return groups


def autoencoder_node_groups(cfg, params) -> List[NodeGroup]:
    """Node groups of the conv autoencoder: each conv (transposed or not)
    followed by a GroupNorm(G) prunes in units of whole norm groups
    (``num_groups`` G, each a contiguous run of C/G channels, OUT), the
    GroupNorm's scale and bias as ACCESSORY; each in-dim follows at
    compression. The output conv is unprunable."""

    def conv_group(layer: str, gn: str, norm_groups: int):
        entries = _layer_entries(params, layer, Transform.OUT)
        entries += _ln_entries(params, gn)
        return NodeGroup(id=layer, entries=entries, num_groups=norm_groups,
                         is_prunable=True)

    groups = [conv_group(f"enc_{i}", f"enc_gn_{i}", cfg.enc_groups(i))
              for i in range(len(cfg.widths))]
    groups += [conv_group(f"dec_{i}", f"dec_gn_{i}", cfg.dec_groups(i))
               for i in range(len(cfg.decoder_widths))]
    groups.append(NodeGroup(
        id="out_conv",
        entries=_layer_entries(params, "out_conv", Transform.OUT),
        num_groups=cfg.in_channels, is_prunable=False))
    return groups


def mark_unprunable(groups: List[NodeGroup], param_names: List[str]
                    ) -> List[NodeGroup]:
    """Disable pruning for every group with a param path containing one of
    ``param_names``."""
    for g in groups:
        if any(nm in e.path for e in g.entries for nm in param_names):
            g.is_prunable = False
    return groups
