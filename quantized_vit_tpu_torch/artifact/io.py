"""Artifact serialization, format-compatible with
``quantized_vit_tpu/artifact/io.py``: a nested tree becomes ``arrays.npz``
(flat arrays keyed by tree path) plus ``manifest.json`` (structure and
static metadata). Artifacts written by either package load in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
FORMAT_VERSION = 1


def _to_numpy(node) -> np.ndarray:
    if isinstance(node, torch.Tensor):
        if node.dtype == torch.bfloat16:
            raise TypeError("bf16 tensors have no numpy dtype; store f32")
        return node.detach().cpu().numpy()
    return np.asarray(node)


def _encode(node, arrays: Dict[str, np.ndarray], path: str):
    from ..serve.vit_int4 import QLayerArtifact

    if node is None:
        return {"__none__": True}
    if isinstance(node, QLayerArtifact):
        return {
            "__qlayer__": {
                "fmt": node.fmt,
                "act_pow": bool(node.act_pow),
                "top": int(node.top),
                "w": _encode(node.w, arrays, f"{path}.w"),
                "scale": _encode(node.scale, arrays, f"{path}.scale"),
                "bias": _encode(node.bias, arrays, f"{path}.bias"),
                "act": _encode(node.act, arrays, f"{path}.act"),
            }
        }
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return {
            "__dataclass__": type(node).__name__,
            "fields": {
                f.name: _encode(getattr(node, f.name), arrays,
                                f"{path}.{f.name}")
                for f in dataclasses.fields(node)
            },
        }
    if isinstance(node, dict):
        return {"__dict__": {k: _encode(v, arrays, f"{path}.{k}")
                             for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {
            "__list__": [_encode(v, arrays, f"{path}[{i}]")
                         for i, v in enumerate(node)],
            "tuple": isinstance(node, tuple),
        }
    if isinstance(node, (bool, int, float, str)):
        return {"__scalar__": node}
    if isinstance(node, (torch.Tensor, np.ndarray, np.generic)):
        arrays[path] = _to_numpy(node)
        return {"__arr__": path}
    raise TypeError(f"cannot serialize {type(node)} at {path}")


def _decode(enc, arrays, registry: Dict[str, Callable],
            put: Callable[[str, np.ndarray], Any]):
    from ..serve.vit_int4 import QLayerArtifact

    if "__none__" in enc:
        return None
    if "__qlayer__" in enc:
        q = enc["__qlayer__"]
        act = _decode(q["act"], arrays, registry, put)
        # format-v1 artifacts carried top inside the act dict (as an
        # array); it is static metadata now
        top = q.get("top")
        if top is None:
            top = int(act.pop("top"))
        else:
            act.pop("top", None)
        return QLayerArtifact(
            w=_decode(q["w"], arrays, registry, put),
            scale=_decode(q["scale"], arrays, registry, put),
            bias=_decode(q["bias"], arrays, registry, put),
            act=act, fmt=q["fmt"], act_pow=q["act_pow"], top=int(top),
        )
    if "__dataclass__" in enc:
        ctor = registry[enc["__dataclass__"]]
        fields = {k: _decode(v, arrays, registry, put)
                  for k, v in enc["fields"].items()}
        return ctor(**fields)
    if "__dict__" in enc:
        return {k: _decode(v, arrays, registry, put)
                for k, v in enc["__dict__"].items()}
    if "__list__" in enc:
        out = [_decode(v, arrays, registry, put) for v in enc["__list__"]]
        return tuple(out) if enc.get("tuple") else out
    if "__scalar__" in enc:
        return enc["__scalar__"]
    if "__arr__" in enc:
        key = enc["__arr__"]
        return put(key, arrays[key])
    raise ValueError(f"bad manifest node {list(enc)[:3]}")


def save_artifact_tree(out_dir: str, tree, extra_meta: Optional[Dict] = None):
    """Write ``tree`` (dicts/lists/tensors/QLayerArtifact/dataclasses) to
    ``out_dir``/{manifest.json, arrays.npz}."""
    os.makedirs(out_dir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    enc = _encode(tree, arrays, "root")
    manifest = {
        "format_version": FORMAT_VERSION,
        "meta": extra_meta or {},
        "tree": enc,
    }
    np.savez(os.path.join(out_dir, ARRAYS), **arrays)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


def load_artifact_tree(in_dir: str, device="cuda",
                       registry: Optional[Dict[str, Callable]] = None):
    """Load an artifact dir; every array becomes a tensor on ``device``
    with its stored dtype. Returns (tree, meta). The default device
    raises when no GPU is present (pass ``device="cpu"``)."""
    device = resolve_device(device)
    with open(os.path.join(in_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"artifact format {manifest['format_version']} != "
            f"{FORMAT_VERSION}")
    with np.load(os.path.join(in_dir, ARRAYS)) as npz:
        arrays = dict(npz)
    reg = dict(registry or {})
    from ..models.vit import ViTConfig

    reg.setdefault("ViTConfig", ViTConfig)
    reg.setdefault("QuantConfig", dict)

    def put(_key, arr):
        return torch.from_numpy(np.array(arr, order="C")).to(device)

    tree = _decode(manifest["tree"], arrays, reg, put)
    return tree, manifest["meta"]
