"""Loss functions (``quantized_vit_tpu/utils/losses.py``): one-hot
targets with label smoothing, soft-target cross entropy, mixup, KD and the
cost-aware group lasso, in PyTorch."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..opt.groups import NodeGroup, Transform, get_path, group_matrix


def one_hot(labels: torch.Tensor, num_classes: int,
            smoothing_eps: Optional[float] = None) -> torch.Tensor:
    """f32 one-hot targets (a label outside [0, C) gives a zero row, as
    ``jax.nn.one_hot``), optionally smoothed to
    one_hot * (v1 - v0) + v0 with v1 = 1 - eps + eps/C, v0 = eps/C."""
    classes = torch.arange(num_classes, device=labels.device)
    oh = (labels[:, None] == classes).to(torch.float32)
    if smoothing_eps is None:
        return oh
    v1 = 1.0 - smoothing_eps + smoothing_eps / float(num_classes)
    v0 = smoothing_eps / float(num_classes)
    return oh * (v1 - v0) + v0


def cross_entropy_onehot_target(logits, target):
    """-(target * log_softmax(logits)).sum(1).mean()."""
    return -torch.mean(torch.sum(target * torch.log_softmax(logits, -1), -1))


def softmax_cross_entropy(logits, labels):
    """Integer-label cross entropy."""
    logp = torch.log_softmax(logits, -1)
    return -torch.mean(torch.take_along_dim(logp, labels[:, None].long(), -1))


def beta_sample(alpha: float, generator: torch.Generator) -> float:
    """One Beta(alpha, alpha) draw from ``generator`` (Johnk's method in
    log space: accept U^(1/a) + V^(1/a) <= 1, return the first share)."""
    dev = generator.device
    while True:
        u, v = torch.rand(2, generator=generator, device=dev,
                          dtype=torch.float64).tolist()
        if u == 0.0 or v == 0.0:
            continue
        lx, ly = math.log(u) / alpha, math.log(v) / alpha
        lm = max(lx, ly)
        ls = lm + math.log(math.exp(lx - lm) + math.exp(ly - lm))
        if ls <= 0.0:
            return math.exp(lx - ls)


def mixup(generator: torch.Generator, inputs, targets, alpha: float = 0.2,
          gamma: Optional[float] = None, perm=None):
    """Mixup of inputs and one-hot targets: gamma ~ Beta(alpha, alpha)
    and a permutation of the batch, both drawn from ``generator`` unless
    given. The mix is taken in f32 with gamma rounded to f32, as the JAX
    package takes it. Returns (mixed_inputs, mixed_targets)."""
    if gamma is None:
        gamma = beta_sample(alpha, generator)
    if perm is None:
        perm = torch.randperm(inputs.shape[0], generator=generator,
                              device=generator.device)
    perm = torch.as_tensor(perm).to(inputs.device)
    g = np.float32(gamma)
    gx, one_minus = float(g), float(np.float32(1.0) - g)
    mixed_x = gx * inputs + one_minus * inputs[perm]
    mixed_y = gx * targets + one_minus * targets[perm]
    return mixed_x, mixed_y


def kd_loss(student_logits, teacher_logits, temperature: float = 4.0):
    """KL(teacher_T || student_T) * T^2, batch mean."""
    t = temperature
    log_p_s = torch.log_softmax(student_logits / t, -1)
    log_p_t = torch.log_softmax(teacher_logits / t, -1)
    kl = torch.sum(torch.exp(log_p_t) * (log_p_t - log_p_s)) / \
        student_logits.shape[0]
    return kl * (t * t)


def group_lasso_loss(groups: Sequence[NodeGroup], params,
                     gl_scales: Optional[Dict[str, torch.Tensor]] = None):
    """Sum over prunable groups of ``(||row||_2 * gl_scale).sum()`` over
    each group's [num_groups, -1] rows (unscaled where no scale is
    given)."""
    total = None
    for g in groups:
        if not g.is_prunable or g.is_auxiliary:
            continue
        sq = None
        for e in g.entries:
            if e.transform == Transform.NO_PRUNE:
                continue
            mat = group_matrix(get_path(params, e.path), e.transform,
                               g.num_groups, num_heads=g.num_heads)
            contrib = torch.sum(mat.to(torch.float32) ** 2, dim=1)
            sq = contrib if sq is None else sq + contrib
        if sq is None:
            continue
        norms = torch.sqrt(sq + 1e-12)
        scale = None if gl_scales is None else gl_scales.get(g.id)
        term = (torch.sum(norms * scale)
                if scale is not None and scale.shape[0] == g.num_groups
                else torch.sum(norms))
        total = term if total is None else total + term
    return torch.zeros(()) if total is None else total
