"""Analytic cost model of a (possibly pruned) model: MACs, BOPs, params,
weight size and average bit width (port of
``quantized_vit_tpu/graph/costs.py``).

The walk is over the params tree itself (flax paths, torch tensors), so a
compressed subnet reports its reduced cost directly. A layer's bit widths
come from its learned quantizer scalars (32 where it has none); BOPs =
MACs x w_bit x a_bit. UltraNet's report (``ultranet_cost_report``) takes
its fixed DoReFa bit widths. Conv MACs are per output pixel (a depthwise
kernel [k, k, 1, C] costs k*k*C a pixel); a transposed conv applies its
whole kernel once per input pixel, so its MACs are counted at the input's
size; embeddings cost none.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.ultranet import ULTRANET_LAYERS
from ..models.vit import ViTConfig
from ..opt.groups import get_path, has_path

FLOAT_BITS = 32.0


def _leaf_sizes(tree, prefix="") -> Dict[str, int]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaf_sizes(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = int(np.prod(tuple(tree.shape)))
    return out


def _layer_bits(params, layer: str) -> Tuple[float, float]:
    """(w_bit, a_bit) from the layer's learned quant scalars, 32 if
    absent."""
    from ..quant.bitwidth import bit_width

    if not has_path(params, f"{layer}/d_quant_wt"):
        return FLOAT_BITS, FLOAT_BITS

    @torch.no_grad()
    def bits(kind):
        d = get_path(params, f"{layer}/d_quant_{kind}")
        q = get_path(params, f"{layer}/q_m_{kind}")
        t = (get_path(params, f"{layer}/t_quant_{kind}")
             if has_path(params, f"{layer}/t_quant_{kind}") else None)
        return float(bit_width(d, q, t).reshape(-1)[0])

    a_bit = (bits("act") if has_path(params, f"{layer}/d_quant_act")
             else FLOAT_BITS)
    return bits("wt"), a_bit


def _accumulate(report: Dict[str, Any], layer: str, macs: float,
                w_bit: float, a_bit: float, weight_numel: int):
    report["per_layer"][layer] = {
        "macs": macs, "bops": macs * w_bit * a_bit,
        "w_bit": w_bit, "a_bit": a_bit, "params": weight_numel,
    }
    report["total_macs"] += macs
    report["total_bops"] += macs * w_bit * a_bit
    report["quantized_weight_bits"] += weight_numel * w_bit


def _finish(report, params):
    sizes = _leaf_sizes(params)
    quant_names = ("d_quant", "q_m_", "t_quant")
    num_params = sum(v for k, v in sizes.items()
                     if not any(q in k for q in quant_names))
    counted = sum(report["per_layer"][lay]["params"]
                  for lay in report["per_layer"])
    # params outside quantized layers (LN, biases, embeddings) count at 32b
    report["num_params"] = num_params
    report["weight_size_bits"] = (
        report["quantized_weight_bits"] + (num_params - counted) * FLOAT_BITS)
    report["average_bit_width"] = (report["weight_size_bits"]
                                   / max(num_params, 1))
    del report["quantized_weight_bits"]
    return report


def vit_cost_report(cfg: ViTConfig, params) -> Dict[str, Any]:
    """Per-sample MACs/BOPs for a (possibly pruned) ViT params tree."""
    report = {"per_layer": {}, "total_macs": 0.0, "total_bops": 0.0,
              "quantized_weight_bits": 0.0}
    g = cfg.img_size // cfg.patch_size
    tokens = g * g + 1

    k = get_path(params, "patch_embed/proj/kernel")
    kh, kw, cin, cout = k.shape
    _accumulate(report, "patch_embed/proj", g * g * kh * kw * cin * cout,
                *_layer_bits(params, "patch_embed/proj"), k.numel())

    for i in range(cfg.depth):
        for name in (f"blocks_{i}/attn/qkv", f"blocks_{i}/attn/proj",
                     f"blocks_{i}/mlp/fc1", f"blocks_{i}/mlp/fc2"):
            kk = get_path(params, f"{name}/kernel")
            fin, fout = kk.shape
            _accumulate(report, name, tokens * fin * fout,
                        *_layer_bits(params, name), kk.numel())
        # the attention score and AV einsums: float, unquantized
        dim_per_comp = get_path(
            params, f"blocks_{i}/attn/qkv/kernel").shape[1] // 3
        _accumulate(report, f"blocks_{i}/attn/einsum",
                    2.0 * tokens * tokens * dim_per_comp, FLOAT_BITS,
                    FLOAT_BITS, 0)

    for name in ("pre_logits", "head"):
        if has_path(params, name):
            kk = get_path(params, f"{name}/kernel")
            _accumulate(report, name, float(kk.shape[0] * kk.shape[1]),
                        *_layer_bits(params, name), kk.numel())
    return _finish(report, params)



def ultranet_cost_report(params, img_hw: Tuple[int, int] = (160, 320),
                         w_bit: int = 4, a_bit: int = 4) -> Dict[str, Any]:
    """Per-sample MACs/BOPs of a (possibly pruned) UltraNet: the first
    conv takes 8-bit image levels, the others ``a_bit`` activations."""
    report = {"per_layer": {}, "total_macs": 0.0, "total_bops": 0.0,
              "quantized_weight_bits": 0.0}
    h, w = img_hw
    n = len(ULTRANET_LAYERS)
    for i in range(n + 1):
        k = get_path(params, f"conv_{i}/kernel")
        kh, kw, cin, cout = k.shape
        in_bits = 8 if i == 0 else a_bit
        _accumulate(report, f"conv_{i}", float(h * w * kh * kw * cin * cout),
                    float(w_bit), float(in_bits), int(np.prod(k.shape)))
        if i < n and ULTRANET_LAYERS[i][2]:
            h, w = h // 2, w // 2
    return _finish(report, params)


def resnet_cost_report(cfg, params,
                       img_hw: Tuple[int, int] = (32, 32)) -> Dict[str, Any]:
    """Per-sample MACs/BOPs of a (possibly pruned) ResNet params tree."""
    report = {"per_layer": {}, "total_macs": 0.0, "total_bops": 0.0,
              "quantized_weight_bits": 0.0}

    def conv(name, h, w, stride=1):
        if not has_path(params, f"{name}/kernel"):
            return h, w
        k = get_path(params, f"{name}/kernel")
        kh, kw, cin, cout = k.shape
        ho, wo = h // stride, w // stride
        _accumulate(report, name, float(ho * wo * kh * kw * cin * cout),
                    *_layer_bits(params, name), k.numel())
        return ho, wo

    h, w = conv("stem_conv", *img_hw)
    for s, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            blk = f"stage{s}_block{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            conv(f"{blk}/down_conv", h, w, stride)
            h2, w2 = conv(f"{blk}/conv1", h, w, stride)
            conv(f"{blk}/conv2", h2, w2, 1)
            h, w = h2, w2
    kk = get_path(params, "head/kernel")
    _accumulate(report, "head", float(kk.shape[0] * kk.shape[1]),
                *_layer_bits(params, "head"), kk.numel())
    return _finish(report, params)


def mobilenet_cost_report(cfg, params,
                          img_hw: Tuple[int, int] = (32, 32)
                          ) -> Dict[str, Any]:
    """Per-sample MACs/BOPs of a (possibly pruned) MobileNet params tree:
    a depthwise conv costs H*W*k*k*C (one input channel a filter)."""
    report = {"per_layer": {}, "total_macs": 0.0, "total_bops": 0.0,
              "quantized_weight_bits": 0.0}

    def conv(name, h, w, stride=1):
        k = get_path(params, f"{name}/kernel")
        kh, kw, cin, cout = k.shape   # depthwise: cin == 1
        ho, wo = h // stride, w // stride
        _accumulate(report, name, float(ho * wo * kh * kw * cin * cout),
                    *_layer_bits(params, name), k.numel())
        return ho, wo

    h, w = conv("stem_conv", *img_hw)
    for i, stride in enumerate(cfg.strides):
        h, w = conv(f"dw_{i}", h, w, stride)
        conv(f"pw_{i}", h, w)
    kk = get_path(params, "head/kernel")
    _accumulate(report, "head", float(kk.shape[0] * kk.shape[1]),
                *_layer_bits(params, "head"), kk.numel())
    return _finish(report, params)


def transformer_cost_report(cfg, params,
                            seq_len: Optional[int] = None) -> Dict[str, Any]:
    """Per-sample MACs/BOPs of a (possibly pruned) separate-q/k/v encoder
    params tree at ``seq_len`` tokens (default ``cfg.max_len``)."""
    report = {"per_layer": {}, "total_macs": 0.0, "total_bops": 0.0,
              "quantized_weight_bits": 0.0}
    tokens = seq_len if seq_len is not None else cfg.max_len
    for i in range(cfg.depth):
        names = [f"blocks_{i}/attn/{nm}" for nm in ("q", "k", "v")]
        names += [f"blocks_{i}/attn/proj", f"blocks_{i}/fc1",
                  f"blocks_{i}/fc2"]
        if has_path(params, f"blocks_{i}/gate"):
            names.append(f"blocks_{i}/gate")  # SwiGLU
        for name in names:
            kk = get_path(params, f"{name}/kernel")
            fin, fout = kk.shape
            _accumulate(report, name, float(tokens * fin * fout),
                        *_layer_bits(params, name), kk.numel())
        # the score and AV einsums: float, unquantized
        q_out = get_path(params, f"blocks_{i}/attn/q/kernel").shape[1]
        _accumulate(report, f"blocks_{i}/attn/einsum",
                    2.0 * tokens * tokens * q_out, FLOAT_BITS, FLOAT_BITS, 0)
    if has_path(params, "head"):
        kk = get_path(params, "head/kernel")
        _accumulate(report, "head", float(kk.shape[0] * kk.shape[1]),
                    *_layer_bits(params, "head"), kk.numel())
    return _finish(report, params)


def autoencoder_cost_report(cfg, params,
                            img_hw: Tuple[int, int] = (32, 32)
                            ) -> Dict[str, Any]:
    """Per-sample MACs/BOPs of a (possibly pruned) ConvAutoencoder: a
    conv's MACs at its output size, a transposed conv's at its input
    size."""
    report = {"per_layer": {}, "total_macs": 0.0, "total_bops": 0.0,
              "quantized_weight_bits": 0.0}
    h, w = img_hw

    def layer(name, hw):
        k = get_path(params, f"{name}/kernel")
        kh, kw, cin, cout = k.shape
        _accumulate(report, name, float(hw[0] * hw[1] * kh * kw * cin * cout),
                    *_layer_bits(params, name), k.numel())

    for i in range(len(cfg.widths)):
        h, w = h // 2, w // 2
        layer(f"enc_{i}", (h, w))
    for i in range(len(cfg.decoder_widths)):
        layer(f"dec_{i}", (h, w))
        h, w = h * 2, w * 2
    layer("out_conv", (h, w))
    return _finish(report, params)
