"""Numerical guards (``quantized_vit_tpu/utils/guards.py``): host checks
the training loop calls at step boundaries."""

from __future__ import annotations

import torch

from ..models.layers import flatten_tree


class NonFiniteLossError(RuntimeError):
    """Raised by the training loop when the loss goes NaN/Inf (raised, not
    exited, so callers can checkpoint and abort)."""


def _float_leaves(tree):
    return {k: v for k, v in flatten_tree(tree).items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()}


def all_finite(tree) -> torch.Tensor:
    """One bool tensor: every floating leaf of ``tree`` is finite."""
    leaves = [torch.isfinite(v).all() for v in _float_leaves(tree).values()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([x.cpu() for x in leaves]).all()


def assert_tree_finite(tree, what: str = "tree"):
    """Raises NonFiniteLossError naming the non-finite leaves."""
    if bool(all_finite(tree)):
        return
    bad = [k for k, v in _float_leaves(tree).items()
           if not bool(torch.isfinite(v).all())]
    raise NonFiniteLossError(f"non-finite values in {what}: {bad[:10]}")
