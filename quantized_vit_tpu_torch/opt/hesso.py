"""HESSO: the pruning-only hybrid structured sparse optimizer
(``quantized_vit_tpu/opt/hesso.py``).

GETA's importance and redundant-group machinery without its quantization
phases: each step of a pruning period multiplies the redundant groups'
rows by ``(T - t - 1) / (T - t)`` (T the period's length, t the step
within it), so they reach zero at the period's end, where they are
committed as pruned and hard-zeroed from then on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.layers import flatten_tree, unflatten_tree
from .geta import GETA, GETAConfig, _compute_grad_variant
from .groups import (NodeGroup, Transform, get_path, group_mask_for_param,
                     set_path)


@dataclasses.dataclass
class HESSOConfig:
    lr: float = 1e-3
    variant: str = "sgd"
    first_momentum: float = 0.0
    second_momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    target_group_sparsity: float = 0.5
    start_pruning_step: int = 0
    pruning_steps: int = 1
    pruning_periods: int = 1
    group_divisible: int = 1
    importance_criteria: Optional[Dict[str, float]] = None

    def to_geta(self) -> GETAConfig:
        return GETAConfig(
            lr=self.lr, lr_quant=self.lr, variant=self.variant,
            first_momentum=self.first_momentum,
            second_momentum=self.second_momentum,
            dampening=self.dampening, weight_decay=self.weight_decay,
            target_group_sparsity=self.target_group_sparsity,
            # no projection phase: every step before pruning is warmup
            start_projection_step=10**12,
            start_pruning_step=self.start_pruning_step,
            pruning_steps=self.pruning_steps,
            pruning_periods=self.pruning_periods,
            group_divisible=self.group_divisible,
            grad_clip_min=-float("inf"), grad_clip_max=float("inf"),
            importance_criteria=self.importance_criteria,
        )


def _f32(v: float) -> float:
    """``v`` rounded to float32 (the JAX update takes its scalars as f32
    arrays)."""
    return float(np.float32(v))


class HESSO(GETA):
    """Pruning-only optimizer on GETA's schedule and masks, with the
    multiplicative decay update. ``step(params, grads)`` returns a new
    params tree."""

    def __init__(self, groups: Sequence[NodeGroup], params,
                 cfg: HESSOConfig):
        self._hesso_cfg = cfg
        super().__init__(groups, params, cfg.to_geta())

    @torch.no_grad()
    def step(self, params, grads):
        cfg = self.cfg
        self.num_steps += 1
        n = self.num_steps

        gv, self.m1, self.m2 = _compute_grad_variant(
            params, grads, self.m1, self.m2, n, cfg.variant,
            cfg.first_momentum, cfg.second_momentum, cfg.dampening,
            cfg.weight_decay)

        if (n >= cfg.start_pruning_step
                and self.curr_pruning_period < cfg.pruning_periods
                and self.pruning_period_duration != 0):
            if ((n - cfg.start_pruning_step - 1)
                    % self.pruning_period_duration == 0):
                self._commit_redundant()
                scores = self._compute_importance(params, gv)
                self._identify_redundant(scores)
                self.curr_pruning_period += 1

        t_frac = 0
        if self.pruning_period_duration != 0:
            t_frac = ((n - cfg.start_pruning_step)
                      % self.pruning_period_duration)

        prune_ids = sorted(g.id for g in self._prunable()
                           if self.state[g.id]["active_redundant"])
        decay = 1.0
        if self.pruning_period_duration != 0:
            decay = ((self.pruning_period_duration - t_frac - 1.0)
                     / (self.pruning_period_duration - t_frac))
        params = self._hesso_apply(params, gv, prune_ids, _f32(decay))

        if (self.pruning_period_duration != 0
                and n >= cfg.start_pruning_step
                and t_frac == self.pruning_period_duration - 1):
            self._commit_redundant()
        return params

    def _hesso_apply(self, params, gv, prune_ids, decay: float):
        """``p - lr * g`` on every leaf (adamw's decoupled decay after),
        then the active-redundant rows decayed by ``decay`` and the
        committed-pruned rows zeroed."""
        cfg = self.cfg
        lr = _f32(cfg.lr)
        lr_wd = _f32(np.float32(cfg.lr) * np.float32(cfg.weight_decay))
        gflat = flatten_tree(gv)
        out = {}
        for path, p in flatten_tree(params).items():
            new = p - lr * gflat[path]
            if cfg.weight_decay and cfg.variant == "adamw":
                new = new - lr_wd * p
            out[path] = new
        params = unflatten_tree(out)
        by_id = self._group_by_id
        active = self._masks("active_redundant")
        for gid in prune_ids:
            g = by_id[gid]
            for e in g.entries:
                if e.transform == Transform.NO_PRUNE:
                    continue
                p = get_path(params, e.path)
                m = group_mask_for_param(active[gid], e.transform, p.shape,
                                         g.num_heads)
                params = set_path(params, e.path,
                                  p * (1.0 - m) + p * m * decay)
        pruned = self._masks("pruned")
        for g in self._prunable():
            if not self.state[g.id]["pruned"]:
                continue  # an all-zero mask leaves the rows as they are
            for e in g.entries:
                if e.transform == Transform.NO_PRUNE:
                    continue
                p = get_path(params, e.path)
                m = group_mask_for_param(pruned[g.id], e.transform, p.shape,
                                         g.num_heads)
                params = set_path(params, e.path, p * (1.0 - m))
        return params
