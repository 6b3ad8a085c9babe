"""Reference PyTorch state dicts <-> params trees
(``quantized_vit_tpu/interop/torch_import.py``), the UltraNet half: the
payload normalizer, the ``.pt`` loader and the UltraNet converters. The
ViT converters come with the rest of interop/ (ROADMAP.md, modules to
port, 'Other model families, interop, auto-discovery').

The converters are name and layout translators on numpy arrays, as the
JAX package's: a conv ``weight`` [O, I, kh, kw] becomes ``kernel`` [kh,
kw, I, O] (HWIO), a BatchNorm's ``weight`` ``scale``, its running
statistics the ``batch_stats`` tree's ``mean``/``var``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.ultranet import ULTRANET_LAYERS


def _to_numpy(v: Any) -> np.ndarray:
    """Torch tensor / numpy array / python scalar -> numpy (duck-typed)."""
    if hasattr(v, "detach"):
        v = v.detach()
    if hasattr(v, "cpu"):
        v = v.cpu()
    if hasattr(v, "numpy"):
        v = v.numpy()
    return np.asarray(v)


def normalize_state_dict(obj: Any) -> Dict[str, np.ndarray]:
    """Normalize any reference checkpoint payload to {name: numpy array}.

    Accepts: a raw state dict; the combined ``{"model": sd, "optimizer": ...,
    "args": ...}`` checkpoint (train.py:517-532); a ``{"state_dict": sd}``
    wrapper; or a whole pickled module (predict.py:43 loads entire modules
    because pruning changes shapes) — anything exposing ``.state_dict()``.
    ``module.``-prefixed keys (DataParallel-wrapped saves) are stripped.
    Non-tensor entries (e.g. ``num_batches_tracked``) are kept; callers
    filter what they understand.
    """
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, Mapping):
        for wrapper in ("model", "state_dict", "model_state_dict"):
            inner = obj.get(wrapper)
            if isinstance(inner, Mapping) or hasattr(inner, "state_dict"):
                return normalize_state_dict(inner)
    if not isinstance(obj, Mapping):
        raise TypeError(f"cannot interpret checkpoint payload of type {type(obj)}")
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = _to_numpy(v)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """``torch.load`` a ``.pt``/``.pth`` file and normalize it.

    ``weights_only`` stays off because reference checkpoints may be whole
    pickled modules (predict.py:43); only load files you trust.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return normalize_state_dict(obj)


# ---------------------------------------------------------------------------
# UltraNet
# ---------------------------------------------------------------------------


def ultranet_params_from_torch(
    state_dict: Mapping[str, Any],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``ultranet_4w4a.pt`` state dict -> (params, batch_stats) for
    :class:`quantized_vit_tpu_torch.models.UltraNet`, numpy leaves.

    The reference model is one ``nn.Sequential`` named ``layers``
    (mymodel.py:71-124); conv/BN modules are identified by their tensors
    (4-dim weight vs running stats) rather than hard-coded indices, so the
    converter also accepts the commented-out deeper variants. Conv weights
    go OIHW -> HWIO; BN maps to flax ``{scale, bias}`` params +
    ``{mean, var}`` batch stats.
    """
    sd = normalize_state_dict(state_dict)
    modules: Dict[int, Dict[str, np.ndarray]] = {}
    for key, arr in sd.items():
        m = re.match(r"^layers\.(\d+)\.(.+)$", key)
        if not m:
            if key.endswith("num_batches_tracked"):
                continue
            raise KeyError(f"unexpected UltraNet key: {key}")
        modules.setdefault(int(m.group(1)), {})[m.group(2)] = arr

    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    n_conv = n_bn = 0
    for idx in sorted(modules):
        entries = {k: v for k, v in modules[idx].items()
                   if not k.endswith("num_batches_tracked")}
        if "running_mean" in entries:
            batch_stats[f"bn_{n_bn}"] = {
                "mean": entries.pop("running_mean"),
                "var": entries.pop("running_var"),
            }
            params[f"bn_{n_bn}"] = {
                "scale": entries.pop("weight"),
                "bias": entries.pop("bias"),
            }
            n_bn += 1
        elif entries.get("weight") is not None and entries["weight"].ndim == 4:
            p = {"kernel": entries.pop("weight").transpose(2, 3, 1, 0)}
            if "bias" in entries:
                p["bias"] = entries.pop("bias")
            params[f"conv_{n_conv}"] = p
            n_conv += 1
        if entries:
            raise KeyError(
                f"unmapped tensors on layers.{idx}: {sorted(entries)}"
            )
    return params, batch_stats


def ultranet_params_to_torch(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> Dict[str, np.ndarray]:
    """Inverse of :func:`ultranet_params_from_torch`, reconstructing the
    reference's ``layers.{i}`` Sequential indices (conv, BN, act-quant
    [, MaxPool] per block — mymodel.py:71-124)."""
    out: Dict[str, np.ndarray] = {}
    idx = 0
    for i, (_, _, pool) in enumerate(ULTRANET_LAYERS):
        conv = params[f"conv_{i}"]
        out[f"layers.{idx}.weight"] = _to_numpy(conv["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in conv:
            out[f"layers.{idx}.bias"] = _to_numpy(conv["bias"])
        idx += 1
        bnp, bns = params[f"bn_{i}"], batch_stats[f"bn_{i}"]
        out[f"layers.{idx}.weight"] = _to_numpy(bnp["scale"])
        out[f"layers.{idx}.bias"] = _to_numpy(bnp["bias"])
        out[f"layers.{idx}.running_mean"] = _to_numpy(bns["mean"])
        out[f"layers.{idx}.running_var"] = _to_numpy(bns["var"])
        idx += 1
        idx += 1  # activation_quantize_fn (no params)
        if pool:
            idx += 1  # MaxPool2d
    last = f"conv_{len(ULTRANET_LAYERS)}"
    out[f"layers.{idx}.weight"] = _to_numpy(params[last]["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in params[last]:
        out[f"layers.{idx}.bias"] = _to_numpy(params[last]["bias"])
    return out
