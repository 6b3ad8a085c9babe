"""The reference-format ``ultranet_4w4a.npz`` and ``config.json``
(``quantized_vit_tpu/interop/npz_export.py``, the reference's
``torch_export.py`` flow).

The npz holds the raw float params as ``arr_0..arr_N`` in the reference's
module order (conv weight [, conv bias], then BN gamma, beta, mean, var,
eps per layer); ``config.json`` the per-conv and per-pool geometry in
channels-first shapes. The reference's own downstream tools
(``qnn_param_reader.py``, ``qnn_mem_process.py``,
``ultranet_param_gen.py``) read them unchanged. Kernels go HWIO -> OIHW.
The params may be tensors (on any device) or numpy arrays.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from ..models.ultranet import ULTRANET_LAYERS, ULTRANET_OUT_CHANNELS


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def ultranet_reference_arrays(params: Mapping[str, Any],
                              batch_stats: Mapping[str, Any],
                              eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """``arr_i``-keyed dict in the reference's module enumeration order."""
    out: Dict[str, np.ndarray] = {}
    cnt = 0

    def put(arr):
        nonlocal cnt
        out[f"arr_{cnt}"] = _np(arr)
        cnt += 1

    for i in range(len(ULTRANET_LAYERS)):
        conv = params[f"conv_{i}"]
        put(_np(conv["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
        if "bias" in conv:
            put(_np(conv["bias"]))
        put(_np(params[f"bn_{i}"]["scale"]))
        put(_np(params[f"bn_{i}"]["bias"]))
        put(_np(batch_stats[f"bn_{i}"]["mean"]))
        put(_np(batch_stats[f"bn_{i}"]["var"]))
        put(np.asarray(eps))
    last = params[f"conv_{len(ULTRANET_LAYERS)}"]
    put(_np(last["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in last:
        put(_np(last["bias"]))
    return out


def ultranet_reference_config(
    input_shape: Tuple[int, int, int] = (3, 160, 320),
    channels: Optional[Tuple[int, ...]] = None,
) -> Dict[str, Any]:
    """Geometry dict in the reference's format: ``conv_i``/``pool_i`` keys,
    channels-first [C, H, W] shapes, conv k/s/p, pool kernel ``p``.
    ``channels`` overrides the dense per-conv out counts so a compressed
    checkpoint's config.json agrees with its npz array shapes."""
    c, h, w = input_shape
    dic: Dict[str, Any] = {}
    pool_cnt = 0
    for i, (feat, ks, pool) in enumerate(ULTRANET_LAYERS):
        if channels is not None:
            feat = int(channels[i])
        p = ks // 2
        dic[f"conv_{i}"] = {
            "in_shape": [c, h, w],
            "out_shape": [feat, (h + 2 * p - ks) + 1, (w + 2 * p - ks) + 1],
            "k": ks, "s": 1, "p": p,
        }
        c, h, w = feat, (h + 2 * p - ks) + 1, (w + 2 * p - ks) + 1
        if pool:
            dic[f"pool_{pool_cnt}"] = {
                "in_shape": [c, h, w],
                "p": 2,
                "out_shape": [c, h // 2, w // 2],
            }
            h, w = h // 2, w // 2
            pool_cnt += 1
    n = len(ULTRANET_LAYERS)
    dic[f"conv_{n}"] = {
        "in_shape": [c, h, w],
        "out_shape": [ULTRANET_OUT_CHANNELS, h, w],
        "k": 1, "s": 1, "p": 0,
    }
    return dic


def export_reference_ultranet(params: Mapping[str, Any],
                              batch_stats: Mapping[str, Any],
                              out_dir: str,
                              eps: float = 1e-5,
                              input_shape: Tuple[int, int, int] = (3, 160, 320),
                              npz_name: str = "ultranet_4w4a.npz",
                              ) -> Tuple[str, str]:
    """Write `ultranet_4w4a.npz` + `config.json` into ``out_dir``; returns
    the two paths."""
    os.makedirs(out_dir, exist_ok=True)
    npz_path = os.path.join(out_dir, npz_name)
    np.savez(npz_path, **ultranet_reference_arrays(params, batch_stats, eps))
    channels = tuple(
        int(np.shape(params[f"conv_{i}"]["kernel"])[-1])
        for i in range(len(ULTRANET_LAYERS)))
    cfg_path = os.path.join(out_dir, "config.json")
    with open(cfg_path, "w") as f:
        f.write(json.dumps(
            ultranet_reference_config(input_shape, channels=channels),
            indent=4))
    return npz_path, cfg_path
