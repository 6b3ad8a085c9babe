"""Epoch drivers: the training step and evaluation
(``quantized_vit_tpu/utils/training.py``).

A step is
  1. the loss (cross entropy on one-hot targets, with mixup / label
     smoothing / KD / group lasso as configured) and its gradients with
     respect to every leaf of the params tree (``torch.autograd.grad``);
  2. ``optimizer.clip_grads`` and ``optimizer.step`` (GETA), which returns
     the new tree;
  3. the finite-loss guard, which raises :class:`NonFiniteLossError`.

The model is reached through ``apply_fn(params, images, generator) ->
logits``, the caller's closure (``models.vit.apply`` on the model), so the
loop carries the params tree as the JAX loop does. Batches come from a
numpy loader and go to ``device`` (the GPU unless the caller asks for the
CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import flatten_tree, unflatten_tree
from .guards import NonFiniteLossError
from .losses import (cross_entropy_onehot_target, group_lasso_loss, kd_loss,
                     mixup, one_hot)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1, 5),
                  mask: Optional[torch.Tensor] = None
                  ) -> Dict[int, torch.Tensor]:
    """Top-k correct counts per k; ``mask`` excludes padded rows."""
    out = {}
    kmax = min(max(ks), logits.shape[-1])  # k > C: always a hit
    top = torch.topk(logits, kmax, dim=-1).indices
    hit = top == labels[:, None].long()
    if mask is not None:
        hit = hit & mask[:, None]
    for k in ks:
        out[k] = torch.sum(hit[:, :min(k, kmax)])
    return out


@dataclasses.dataclass
class TrainLoop:
    """Epochs of (model, GETA) training.

    ``apply_fn(params, images, generator) -> logits`` runs the model on a
    params tree (dropout draws from ``generator``); ``teacher_fn(images)
    -> logits`` turns on knowledge distillation."""

    apply_fn: Callable
    optimizer: Any                     # GETA-style host optimizer
    num_classes: int
    mix_up: bool = False
    label_smooth: bool = False
    smoothing_eps: float = 0.1
    mixup_alpha: float = 0.2
    teacher_fn: Optional[Callable] = None
    kd_alpha: float = 0.0
    kd_temperature: float = 4.0
    use_group_lasso: bool = False
    group_lasso_lambda: float = 0.0
    gl_start_epoch: int = 0
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def loss_fn(self, params, images, labels, generator, gl_scales,
                gl_lambda: float):
        """(loss, aux) of one batch; aux holds ce, kd, gl and the logits."""
        if self.mix_up or self.label_smooth:
            eps = self.smoothing_eps if self.label_smooth else None
            targets = one_hot(labels, self.num_classes, eps)
            if self.mix_up:
                images, targets = mixup(generator, images, targets,
                                        self.mixup_alpha)
        else:
            targets = one_hot(labels, self.num_classes)
        logits = self.apply_fn(params, images, generator)
        ce = cross_entropy_onehot_target(logits, targets)
        loss = ce
        zero = torch.zeros((), device=logits.device)
        kd = gl = zero
        if self.teacher_fn is not None and self.kd_alpha > 0.0:
            with torch.no_grad():
                teacher = self.teacher_fn(images)
            kd = kd_loss(logits, teacher, self.kd_temperature)
            loss = (1.0 - self.kd_alpha) * ce + self.kd_alpha * kd
        if self.use_group_lasso and self.group_lasso_lambda > 0.0:
            groups = [g for g in self.optimizer.groups
                      if g.is_prunable and not g.is_auxiliary]
            gl = group_lasso_loss(groups, params, gl_scales)
            loss = loss + gl_lambda * gl
        return loss, {"ce": ce, "kd": kd, "gl": gl, "logits": logits}

    def loss_and_grads(self, params, images, labels, generator=None,
                       gl_scales=None, gl_lambda: float = 0.0):
        """(loss, aux, grads): grads is a tree like ``params`` (zeros for a
        leaf the loss does not reach)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten_tree(params).items()}
        loss, aux = self.loss_fn(unflatten_tree(leaves), images, labels,
                                 generator, gl_scales, gl_lambda)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        aux = {k: v.detach() for k, v in aux.items()}
        return loss.detach(), aux, unflatten_tree(grads)

    def _gl_scales_device(self):
        gls = getattr(self.optimizer, "gl_scales", None)
        if not self.use_group_lasso or gls is None:
            return None
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in gls.items()}

    def train_one_epoch(self, params, loader, epoch: int,
                        generator: Optional[torch.Generator] = None):
        """Returns (params, metrics): the mean loss, ce, kd and gl, the
        training accuracy, the steps, each step's loss and the seconds."""
        gl_on = (self.use_group_lasso and epoch >= self.gl_start_epoch
                 and self.group_lasso_lambda > 0.0)
        gl_lambda = self.group_lasso_lambda if gl_on else 0.0
        tot = {"loss": 0.0, "ce": 0.0, "kd": 0.0, "gl": 0.0}
        losses = []
        correct = seen = steps = 0
        t0 = time.time()
        for images, labels, mask in loader:
            images = torch.from_numpy(np.asarray(images)).to(self.device)
            labels = torch.from_numpy(np.asarray(labels)).to(self.device)
            loss, aux, grads = self.loss_and_grads(
                params, images, labels, generator, self._gl_scales_device(),
                gl_lambda)
            loss_val = float(loss)
            if not np.isfinite(loss_val):
                raise NonFiniteLossError(
                    f"non-finite loss {loss_val} at epoch {epoch} step "
                    f"{steps}")
            grads = self.optimizer.clip_grads(grads)
            params = self.optimizer.step(params, grads)

            pred = aux["logits"].argmax(-1).cpu().numpy()
            valid = np.asarray(mask)
            correct += int(((pred == labels.cpu().numpy()) & valid).sum())
            seen += int(valid.sum())
            tot["loss"] += loss_val
            losses.append(loss_val)
            for k in ("ce", "kd", "gl"):
                tot[k] += float(aux[k])
            steps += 1
        n = max(steps, 1)
        return params, {
            "loss": tot["loss"] / n,
            "acc": correct / max(seen, 1),
            "ce_loss": tot["ce"] / n,
            "kd_loss": tot["kd"] / n,
            "gl_loss": tot["gl"] / n,
            "steps": steps,
            "step_losses": losses,
            "seconds": time.time() - t0,
        }


@torch.no_grad()
def evaluate(apply_fn: Callable, params, loader, ks: Sequence[int] = (1, 5),
             device="cuda") -> Dict[str, float]:
    """Top-k accuracy and mean loss; ``apply_fn(params, images) -> logits``
    must be deterministic."""
    dev = resolve_device(device)
    hits = {k: 0 for k in ks}
    seen = steps = 0
    loss_sum = 0.0
    for images, labels, mask in loader:
        x = torch.from_numpy(np.asarray(images)).to(dev)
        y = torch.from_numpy(np.asarray(labels)).to(dev)
        m = torch.from_numpy(np.asarray(mask)).to(dev)
        logits = apply_fn(params, x)
        counts = topk_accuracy(logits, y, ks, m)
        loss = cross_entropy_onehot_target(logits,
                                           one_hot(y, logits.shape[-1]))
        for k in ks:
            hits[k] += int(counts[k])
        seen += int(np.asarray(mask).sum())
        loss_sum += float(loss)
        steps += 1
    out = {f"top{k}": hits[k] / max(seen, 1) for k in ks}
    out["loss"] = loss_sum / max(steps, 1)
    out["samples"] = seen
    return out
