"""Checkpoint save / load / scan for (params, GETA state), in the JAX
package's on-disk format (``quantized_vit_tpu/opt/checkpoint.py``):
``<path>.npz`` holds the params tree flattened to '/'-joined paths
(lists as ``#i`` keys), ``<path>.meta.pkl`` a pickled
``{"opt_state": ..., "extra": ...}``. The port writes numpy arrays and
plain Python values only, so the JAX package reads what it writes, and it
reads what the JAX package writes.
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(path: str, params, opt_state: Optional[Dict] = None,
                    extra: Optional[Dict] = None) -> str:
    """Write ``<path>.npz`` (params) + ``<path>.meta.pkl`` (optimizer state
    and extra); tensors are written as numpy arrays."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **_flatten(params))
    meta = {"opt_state": opt_state, "extra": extra or {}}
    with open(path + ".meta.pkl", "wb") as f:
        pickle.dump(meta, f)
    return path


def load_checkpoint(path: str, device="cuda") -> Tuple[Any, Optional[Dict],
                                                        Dict]:
    """(params tree of tensors on ``device``, opt_state, extra)."""
    dev = resolve_device(device)
    with np.load(path + ".npz") as z:
        params = _unflatten({k: torch.from_numpy(z[k]).to(dev)
                             for k in z.files})
    meta = {"opt_state": None, "extra": {}}
    if os.path.exists(path + ".meta.pkl"):
        with open(path + ".meta.pkl", "rb") as f:
            meta = pickle.load(f)
    return params, meta["opt_state"], meta["extra"]


def scan_checkpoint(ckpt_dir: str, name: str = "ckpt") -> Optional[str]:
    """Latest checkpoint base path by trailing step number."""
    best, best_step = None, -1
    for p in glob.glob(os.path.join(ckpt_dir, f"{name}_*.npz")):
        m = re.search(r"_(\d+)\.npz$", p)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = p[: -len(".npz")]
    return best
