"""UltraNet's integer artifact (``quantized_vit_tpu/artifact/ultranet.py``):
one pass over the params and ``batch_stats`` trees gives the integer
tensors :class:`~quantized_vit_tpu_torch.models.UltraNetInt` takes (the
``weight_quantize_int`` levels and the ``bn_act_quantize_int`` ``(inc,
bias)`` tables) and a per-layer geometry table. Saved through
``artifact/io.py`` in the JAX package's format: an artifact written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import tree_map
from ..models.ultranet import (ULTRANET_LAYERS, ULTRANET_OUT_CHANNELS,
                               channels_of)
from ..quant.integer import bn_act_quantize_int, weight_quantize_int
from .io import load_artifact_tree, save_artifact_tree


@dataclasses.dataclass
class UltraNetExportConfig:
    """The export's hyperparameters (the reference's
    ``ultranet_param_gen.py``); ``input_shape`` is (H, W, C)."""

    w_bit: int = 4
    in_bit_first: int = 8   # the first conv takes 8-bit image levels
    a_bit: int = 4
    out_bit_last: int = 32  # the last conv dequantizes for the YOLO head
    l_shift: int = 8
    eps: float = 1e-5
    input_shape: Tuple[int, int, int] = (160, 320, 3)


def as_tensors(tree, device=None):
    """A tree with every numpy leaf as a tensor (on ``device``, or the
    CPU), tensor leaves kept (moved to ``device`` if given)."""
    dev = resolve_device(device) if device is not None else None

    def conv(v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        return t.to(dev) if dev is not None else t

    return tree_map(conv, tree)


def generate_ultranet_config(exp: UltraNetExportConfig,
                             channels: Any = None) -> List[Dict[str, Any]]:
    """Per-layer geometry: in/out shapes (H, W, C), kernel, stride,
    padding, bits, the pool after. ``channels`` overrides the per-conv
    widths (a compressed subnet)."""
    h, w, c = exp.input_shape
    table = []
    in_ch = c
    for i, (feat, ks, pool) in enumerate(ULTRANET_LAYERS):
        if channels is not None:
            feat = int(channels[i])
        entry = {
            "name": f"conv_{i}",
            "in_shape": [h, w, in_ch],
            "k": ks, "s": 1, "p": ks // 2,
            "out_channels": feat,
            "w_bit": exp.w_bit,
            "in_bit": exp.in_bit_first if i == 0 else exp.a_bit,
            "out_bit": exp.a_bit,
            "l_shift": exp.l_shift,
            "maxpool_after": bool(pool),
        }
        if pool:
            h, w = h // 2, w // 2
        entry["out_shape"] = [h, w, feat]
        table.append(entry)
        in_ch = feat
    table.append({
        "name": f"conv_{len(ULTRANET_LAYERS)}",
        "in_shape": [h, w, in_ch],
        "k": 1, "s": 1, "p": 0,
        "out_channels": ULTRANET_OUT_CHANNELS,
        "w_bit": exp.w_bit,
        "in_bit": exp.a_bit,
        "out_bit": exp.out_bit_last,
        "l_shift": exp.l_shift,
        "maxpool_after": False,
        "out_shape": [h, w, ULTRANET_OUT_CHANNELS],
    })
    return table


def export_ultranet_int(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        exp: Optional[UltraNetExportConfig] = None
                        ) -> Dict[str, torch.Tensor]:
    """Trained UltraNet params (tensors or numpy arrays) -> the integer
    tree: per conv i < 8 ``kernel_int`` levels in +-(2^(w_bit-1) - 1) and
    the folded-BN ``(inc, bias)`` tables; the last conv's integer kernel
    and f32 bias. On the params' device."""
    exp = exp or UltraNetExportConfig()
    params, batch_stats = as_tensors(params), as_tensors(batch_stats)
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(ULTRANET_LAYERS)):
        in_bit = exp.in_bit_first if i == 0 else exp.a_bit
        out[f"conv_{i}_kernel_int"] = weight_quantize_int(
            params[f"conv_{i}"]["kernel"], bit=exp.w_bit)
        inc, bias = bn_act_quantize_int(
            params[f"bn_{i}"]["scale"], params[f"bn_{i}"]["bias"],
            batch_stats[f"bn_{i}"]["mean"], batch_stats[f"bn_{i}"]["var"],
            exp.eps, w_bit=exp.w_bit, in_bit=in_bit, out_bit=exp.a_bit,
            l_shift=exp.l_shift)
        out[f"conv_{i}_inc"] = inc
        out[f"conv_{i}_bias_int"] = bias
    last = f"conv_{len(ULTRANET_LAYERS)}"
    out[f"{last}_kernel_int"] = weight_quantize_int(params[last]["kernel"],
                                                    bit=exp.w_bit)
    out[f"{last}_bias"] = params[last]["bias"].to(torch.float32)
    return out


def save_ultranet_artifact(out_dir: str, params, batch_stats,
                           exp: Optional[UltraNetExportConfig] = None) -> str:
    """The integer tree and the geometry table -> ``out_dir``."""
    exp = exp or UltraNetExportConfig()
    int_params = export_ultranet_int(params, batch_stats, exp)
    meta = {
        "model": "ultranet",
        "config": generate_ultranet_config(exp, channels=channels_of(params)),
        "export": dataclasses.asdict(exp),
    }
    return save_artifact_tree(out_dir, int_params, meta)


def load_ultranet_artifact(in_dir: str, device="cuda"):
    """(the integer tree, its tensors on ``device``; meta)."""
    return load_artifact_tree(
        in_dir, device=device,
        registry={"UltraNetExportConfig": UltraNetExportConfig})
