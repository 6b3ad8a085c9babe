"""LoRA adapters with pruning-graph support (``quantized_vit_tpu/models/
lora.py``), flax's names and layouts: ``kernel [in, out]``, ``lora_a [in,
r]``, ``lora_b [r, out]``; the forward is ``y = x @ kernel + (alpha / r) *
(x @ lora_a) @ lora_b (+ bias)``. ``LoraEmbedding``: ``embedding [vocab,
dim]``, ``lora_a [vocab, r]``, ``lora_b [r, dim]``, the lookup
``embedding[ids] + (alpha / r) * lora_a[ids] @ lora_b``.

In the node groups ``lora_b`` prunes its out-columns with the base weight
and ``lora_a`` is NO_PRUNE (``graph/builders.py:lora_layer_entries``);
the importance of a ``lora_b`` entry takes ``lora_a @ lora_b`` as the
gradient proxy (``opt/importance.py``). Freezing the base is the
caller's: :func:`lora_grad_mask` marks the adapters, to mask gradients or
to set ``requires_grad``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .layers import TreeModule, _normal, _trunc_normal


class LoraDense(TreeModule):
    """A dense layer with a low-rank adapter; ``lora_b`` starts at zero,
    so the adapted layer starts equal to its base (flax ``lecun_normal``
    kernel, ``lora_a`` normal(0.02))."""

    def __init__(self, in_features: int, features: int, rank: int = 8,
                 alpha: float = 16.0, use_bias: bool = True, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.rank, self.alpha = rank, alpha
        self.kernel = nn.Parameter(_trunc_normal(
            (in_features, features),
            math.sqrt(1.0 / in_features) / 0.87962566103423978, gen, dev))
        self.lora_a = nn.Parameter(_normal((in_features, rank), 0.02, gen,
                                           dev))
        self.lora_b = nn.Parameter(torch.zeros((rank, features),
                                               device=dev))
        self.register_parameter("bias", nn.Parameter(torch.zeros(
            features, device=dev)) if use_bias else None)

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def forward(self, x):
        y = x @ self.kernel + self.scaling * ((x @ self.lora_a)
                                              @ self.lora_b)
        if self.bias is not None:
            y = y + self.bias
        return y


class LoraEmbedding(TreeModule):
    """An embedding with a low-rank adapter; ``lora_a`` (the table side)
    starts at zero, so the adapted lookup starts equal to the base
    (``embedding`` and ``lora_b`` normal(0.02))."""

    def __init__(self, num_embeddings: int, features: int, rank: int = 8,
                 alpha: float = 16.0, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.rank, self.alpha = rank, alpha
        self.embedding = nn.Parameter(_normal((num_embeddings, features),
                                              0.02, gen, dev))
        self.lora_a = nn.Parameter(torch.zeros((num_embeddings, rank),
                                               device=dev))
        self.lora_b = nn.Parameter(_normal((rank, features), 0.02, gen, dev))

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def forward(self, ids):
        return self.embedding[ids] + self.scaling * (self.lora_a[ids]
                                                     @ self.lora_b)


def params_from_jax(tree, alpha: float = 16.0, device="cuda"):
    """The LoraDense (a tree with ``kernel``) or LoraEmbedding (with
    ``embedding``) holding copies of one JAX layer's params tree (numpy
    leaves), at the tree's widths and rank, on ``device``."""
    rank = int(np.shape(tree["lora_b"])[0])
    if "kernel" in tree:
        fin, fout = np.shape(tree["kernel"])
        model = LoraDense(int(fin), int(fout), rank, alpha,
                          use_bias="bias" in tree, device=device)
    else:
        vocab, dim = np.shape(tree["embedding"])
        model = LoraEmbedding(int(vocab), int(dim), rank, alpha,
                              device=device)
    model.load_param_tree(tree)
    return model


def merge_lora(params, scaling_by_path: Optional[dict] = None,
               default_scaling: float = 2.0):
    """Fold every adapter into its base weight, ``base += scaling * lora_a
    @ lora_b``, and drop the adapter's leaves: for a dense layer
    (``kernel``) and an embedding (``embedding``) alike. ``scaling`` is
    ``scaling_by_path[layer path]`` or ``default_scaling``. Returns a new
    tree."""

    def visit(node, path=""):
        if not isinstance(node, dict):
            return node
        out = {k: visit(v, f"{path}/{k}" if path else k)
               for k, v in node.items()}
        if "lora_a" in out and "lora_b" in out:
            base_key = "kernel" if "kernel" in out else (
                "embedding" if "embedding" in out else None)
            if base_key is not None:
                s = (scaling_by_path or {}).get(path, default_scaling)
                out[base_key] = (out[base_key]
                                 + s * (out["lora_a"] @ out["lora_b"]))
                del out["lora_a"], out["lora_b"]
        return out

    return visit(params)


def lora_grad_mask(params):
    """A boolean tree like ``params``: True at the adapters' leaves
    (``lora_a``/``lora_b`` of a layer holding both), False elsewhere."""

    def visit(node):
        has_lora = "lora_a" in node and "lora_b" in node
        return {k: visit(v) if isinstance(v, dict)
                else (has_lora and k in ("lora_a", "lora_b"))
                for k, v in node.items()}

    return visit(params)
