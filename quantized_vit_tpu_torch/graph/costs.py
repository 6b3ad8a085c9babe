"""Analytic cost model of a (possibly pruned) ViT: MACs, BOPs, params,
weight size and average bit width (port of
``quantized_vit_tpu/graph/costs.py:24-125``).

The walk is over the params tree itself (flax paths, torch tensors), so a
compressed subnet reports its reduced cost directly. A layer's bit widths
come from its learned quantizer scalars (32 where it has none); BOPs =
MACs x w_bit x a_bit. UltraNet's report (``ultranet_cost_report``)
takes its fixed DoReFa bit widths. The other model families' reports come
with their models (ROADMAP.md, modules to port, 'Other model families,
interop, auto-discovery'); ``graph.OTO`` refuses those models.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

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
