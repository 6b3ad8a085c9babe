"""ViT INT4 serving artifact on disk (``quantized_vit_tpu/artifact/vit.py``).

The loader places the whole artifact on one device; the JAX loader's
``mesh`` argument (a sharded placement at load) is not ported. A process
of the serve CLI's mesh branch loads the artifact on its device and takes
its own shards (``serve.shard_tp_artifact`` /
``serve.shard_fsdp_artifact``), as the JAX CLI shards the artifact it
loaded."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..models.vit import ViTConfig
from .io import load_artifact_tree, save_artifact_tree


def save_vit_int4_artifact(out_dir: str, art: Dict[str, Any],
                           cfg: ViTConfig) -> str:
    meta = {"model": "vit_int4", "cfg": dataclasses.asdict(cfg)}
    return save_artifact_tree(out_dir, art, meta)


def _cfg_from_meta(meta: Dict[str, Any]) -> ViTConfig:
    raw = dict(meta["cfg"])
    quant = dict(raw.pop("quant"))
    for k in ("heads_per_block", "hidden_per_block"):
        if raw.get(k) is not None:
            raw[k] = tuple(raw[k])
    return ViTConfig(quant=quant, **raw)


def load_vit_int4_artifact(in_dir: str, device="cuda"):
    """Returns (artifact tree with tensors on ``device``, ViTConfig)."""
    tree, meta = load_artifact_tree(in_dir, device=device)
    return tree, _cfg_from_meta(meta)
