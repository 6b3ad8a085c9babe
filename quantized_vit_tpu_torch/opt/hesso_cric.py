"""HESSO-CRIC: cyclic redundancy identification and correction
(``quantized_vit_tpu/opt/hesso_cric.py``).

HESSO picks its redundant groups from one importance snapshot; CRIC
samples instead. It nominates a violating set of suspect groups, decays
them toward zero while training, watches the importance and loss
evidence, resets the parameters, and only after the cycles converge
(violating set within tolerance, or the most cycles) commits to a final
redundant set scored by the importance accumulated over every cycle plus
a loss criterion. Phases, in ``step`` order:

1. ``basic`` (n < start_cric_step): plain momentum / Adam descent;
2. ``proj`` (optional, per node group): for each prunable group and each
   trial sparsity, one step zeroing that group's least important rows,
   then one recording the relative loss and resetting the parameters;
3. ``cric`` cycles: every ``sampling_steps`` steps the violating set is
   nominated again (the global bottom-K importance less the historical
   set) and the parameters reset; within a cycle the violating rows decay
   by ``(S - t - 1) / (S - t)`` a step while everything else trains;
4. terminate: the mean importance over every collected sample, the loss
   criterion added, picks the final redundant set; the parameters reset;
5. ``hybrid``: train while decaying the redundant rows, then keep them at
   zero.

Scores and index sets live on the host in numpy, as in the JAX package.
A reset hands back fresh copies of the cached tensors: the cache holds
clones, so nothing a caller does to the returned params (an in-place
update included) reaches it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.layers import tree_map
from .geta import GETA, GETAConfig, _compute_grad_variant
from .groups import (NodeGroup, Transform, get_path, group_mask_for_param,
                     set_path)
from .importance import DEFAULT_CRITERIA, combine_importance_scores

DEFAULT_CRIC_CRITERIA: Dict[str, float] = dict(DEFAULT_CRITERIA, loss=1.0)


@dataclasses.dataclass
class HESSOCRICConfig:
    lr: float = 1e-3
    variant: str = "sgd"
    first_momentum: float = 0.0
    second_momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    target_group_sparsity: float = 0.5
    tolerance: int = 0
    group_divisible: int = 1
    start_cric_step: int = 0
    max_cycle_period: int = 10
    sampling_steps: int = 4
    hybrid_training_steps: int = 4
    proj_per_node_group: bool = True
    trial_group_sparsities: Tuple[float, ...] = (0.25, 0.5, 0.75)
    importance_criteria: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.variant in ("adam", "adamw"):
            if self.first_momentum == 0.0:
                self.first_momentum = 0.9
            if self.second_momentum == 0.0:
                self.second_momentum = 0.999


def _clone(params):
    return tree_map(lambda p: p.detach().clone(), params)


class HESSOCRIC(GETA):
    """CRIC on GETA's group and importance machinery (its descent, with
    ``lr_quant = lr``: ``p - lr * g`` on every leaf).
    ``step(params, grads, loss=None)`` returns a new params tree; the loss
    value feeds the saliency."""

    def __init__(self, groups: Sequence[NodeGroup], params,
                 cfg: HESSOCRICConfig):
        self._cric_cfg = cfg
        super().__init__(groups, params, GETAConfig(
            lr=cfg.lr, lr_quant=cfg.lr, variant=cfg.variant,
            first_momentum=cfg.first_momentum,
            second_momentum=cfg.second_momentum,
            dampening=cfg.dampening, weight_decay=cfg.weight_decay,
            target_group_sparsity=cfg.target_group_sparsity,
            start_projection_step=10**12, start_pruning_step=10**12,
            group_divisible=cfg.group_divisible,
            grad_clip_min=-float("inf"), grad_clip_max=float("inf"),
            importance_criteria=cfg.importance_criteria
            or DEFAULT_CRIC_CRITERIA))
        for st in self.state.values():
            st["active_violating"] = []
            st["trial_violating"] = []
            st["historical_violating"] = []
        # the per-cycle collections
        self.score_collection: List[np.ndarray] = []
        self.loss_collection: Dict[str, List[float]] = {
            g.id: [] for g in self._prunable()}
        self.curr_cycle_period = -1
        self.is_terminated = False
        self.terminated_step: Optional[int] = None
        self.ref_loss: Optional[float] = None
        self._cache = None

        n_proj = (2 * len(cfg.trial_group_sparsities)
                  * len(self._prunable()))
        self.start_global_sampling_step = (
            cfg.start_cric_step + (n_proj if cfg.proj_per_node_group else 0))

    # -- the parameter cache ----------------------------------------------

    @property
    def cache_params(self):
        """The cached params (a reset's result): fresh copies, or None
        before the cache is filled."""
        return None if self._cache is None else _clone(self._cache)

    def _set_cache(self, params):
        self._cache = _clone(params)

    # -- small helpers ------------------------------------------------------

    def _scale_rows(self, params, group: NodeGroup, idxes: List[int],
                    factor: float):
        """The rows ``idxes`` of ``group`` times ``factor``, through its
        mask: ``p * (1 - m * (1 - factor))``."""
        if not idxes:
            return params
        mask = np.zeros((group.num_groups,), np.float32)
        mask[np.asarray(idxes, np.int64)] = 1.0
        mask = torch.from_numpy(mask).to(self.device)
        keep = 1.0 - factor
        for e in group.entries:
            if e.transform == Transform.NO_PRUNE:
                continue
            p = get_path(params, e.path)
            m = group_mask_for_param(mask, e.transform, p.shape,
                                     group.num_heads)
            params = set_path(params, e.path, p * (1.0 - m * keep))
        return params

    def _zero_rows(self, params, group: NodeGroup, idxes: List[int]):
        return self._scale_rows(params, group, idxes, 0.0)

    def _scores(self, params, gv) -> np.ndarray:
        scores, gl = combine_importance_scores(
            self._prunable(), params, gv,
            {k: v for k, v in (self.cfg.importance_criteria
                               or DEFAULT_CRIC_CRITERIA).items()
             if k != "loss"})
        self.gl_scales = {g.id: s.cpu().numpy()
                          for g, s in zip(self._prunable(), gl)}
        return scores.cpu().numpy()

    def _group_slice(self, global_vec: np.ndarray, g: NodeGroup) -> np.ndarray:
        s = self.global_start[g.id]
        return global_vec[s:s + g.num_groups]

    def _local_of(self, top: np.ndarray, g: NodeGroup) -> np.ndarray:
        start = self.global_start[g.id]
        return np.intersect1d(top, np.arange(start, start + g.num_groups)) \
            - start

    def num_active_violating(self) -> int:
        return sum(len(self.state[g.id]["active_violating"])
                   for g in self._prunable())

    def _cric_terminate(self) -> bool:
        if self.curr_cycle_period >= self._cric_cfg.max_cycle_period:
            return True
        return (self.curr_cycle_period >= 1
                and self.num_active_violating() <= self._cric_cfg.tolerance)

    # -- phase bodies -------------------------------------------------------

    def _update_violating_set(self, scores: np.ndarray, cycle: int):
        k = min(self.target_num_redundant_groups, scores.shape[0])
        top = np.argsort(scores, kind="stable")[:k]
        for g in self._prunable():
            st = self.state[g.id]
            if cycle == 1:
                st["active_violating"] = self._local_of(top, g).tolist()
            else:
                hist = set(st["historical_violating"])
                st["active_violating"] = [i for i in st["trial_violating"]
                                          if i not in hist]
            viol = set(st["active_violating"])
            st["important"] = [i for i in range(g.num_groups)
                               if i not in viol]

    def _update_trial_violating(self, scores: np.ndarray):
        k = min(self.target_num_redundant_groups, scores.shape[0])
        top = np.argsort(scores, kind="stable")[:k]
        for g in self._prunable():
            st = self.state[g.id]
            pool = set(st["trial_violating"]) | set(
                self._local_of(top, g).tolist())
            drop = set(st["active_violating"]) | set(
                st["historical_violating"])
            st["trial_violating"] = sorted(i for i in pool if i not in drop)

    def _proj_step(self, params, gv, loss):
        """Per-node-group trial projection: zero a group's least important
        rows at a trial sparsity, then record the relative loss and reset."""
        cfg = self._cric_cfg
        scores = self._scores(params, gv)
        self.score_collection.append(scores)

        groups = self._prunable()
        k = self.num_steps - cfg.start_cric_step
        gi = k // (2 * len(cfg.trial_group_sparsities))
        si = (k // 2) % len(cfg.trial_group_sparsities)
        g = groups[gi]
        if k % 2 == 0:
            trial = cfg.trial_group_sparsities[si]
            n_red = max(min(int(g.num_groups * trial), g.num_groups), 1)
            local = self._group_slice(scores, g)
            idxes = np.argsort(local, kind="stable")[:n_red].tolist()
            return self._zero_rows(params, g, idxes)
        # the relative loss deviation for the whole group, then the reset
        if loss is not None and self.ref_loss:
            self.loss_collection[g.id].append(
                float(loss) / self.ref_loss / max(g.num_groups, 1))
        return self.cache_params

    def _cric_step(self, params, gv):
        """One sampling step inside a cycle."""
        cfg = self._cric_cfg
        scores = self._scores(params, gv)

        k = self.num_steps - self.start_global_sampling_step
        if k % cfg.sampling_steps == 0:
            self.curr_cycle_period += 1
            self._update_violating_set(scores, self.curr_cycle_period)
            for g in self._prunable():
                st = self.state[g.id]
                st["historical_violating"] = sorted(
                    set(st["historical_violating"])
                    | set(st["active_violating"]))
            params = self.cache_params
        self.score_collection.append(scores)
        self._update_trial_violating(scores)

        t = k % cfg.sampling_steps
        factor = (cfg.sampling_steps - t - 1.0) / (cfg.sampling_steps - t)
        params = self._gd(params, gv)
        for g in self._prunable():
            params = self._scale_rows(
                params, g, self.state[g.id]["active_violating"], factor)
        return params

    def _finalize(self):
        """The accumulated saliency (plus the loss criterion) picks the
        redundant set; returns the reset params."""
        acc = (np.mean(np.stack(self.score_collection, 0), 0)
               if self.score_collection else
               np.zeros((self.total_num_groups,), np.float32))
        loss_w = (self.cfg.importance_criteria
                  or DEFAULT_CRIC_CRITERIA).get("loss", 1.0)
        for g in self._prunable():
            losses = self.loss_collection[g.id]
            if losses:
                s = self.global_start[g.id]
                acc[s:s + g.num_groups] += loss_w * float(np.mean(losses))

        k = min(self.target_num_redundant_groups, acc.shape[0])
        self.pruned_group_idxes = []
        self._identify_redundant_from(acc, k)
        self.is_terminated = True
        self.terminated_step = self.num_steps
        return self.cache_params

    def _identify_redundant_from(self, scores: np.ndarray, k: int):
        top = np.argsort(scores, kind="stable")[:k]
        for g in self._prunable():
            st = self.state[g.id]
            st["active_redundant"] = self._local_of(top, g).tolist()
            if g.num_groups < self.cfg.group_divisible:
                st["active_redundant"] = []
                st["pruned"] = []
            drop = set(st["active_redundant"]) | set(st["pruned"])
            st["important"] = [i for i in range(g.num_groups)
                               if i not in drop]
        self._mask_cache.clear()

    def _hybrid_step(self, params, gv):
        cfg = self._cric_cfg
        t = self.num_steps - self.terminated_step - 1
        done = self.num_steps > self.terminated_step + cfg.hybrid_training_steps
        params = self._gd(params, gv)
        if not done:
            factor = ((cfg.hybrid_training_steps - t - 1.0)
                      / (cfg.hybrid_training_steps - t))
            for g in self._prunable():
                params = self._scale_rows(
                    params, g, self.state[g.id]["active_redundant"], factor)
        if self.num_steps == self.terminated_step + cfg.hybrid_training_steps:
            for g in self._prunable():
                st = self.state[g.id]
                st["pruned"].extend(st["active_redundant"])
                st["active_redundant"] = []
            self._mask_cache.clear()
        if done:
            for g in self._prunable():
                params = self._zero_rows(params, g, self.state[g.id]["pruned"])
        return params

    # -- step ---------------------------------------------------------------

    @torch.no_grad()
    def step(self, params, grads, loss=None):
        cfg = self._cric_cfg
        self.num_steps += 1
        n = self.num_steps

        gv, self.m1, self.m2 = _compute_grad_variant(
            params, grads, self.m1, self.m2, n, self.cfg.variant,
            self.cfg.first_momentum, self.cfg.second_momentum,
            self.cfg.dampening, self.cfg.weight_decay)

        if n == cfg.start_cric_step:
            self.ref_loss = float(loss) if loss is not None else None
            self._set_cache(params)
            self.curr_cycle_period += 1

        if n < cfg.start_cric_step:
            params = self._gd(params, gv)
        elif (cfg.proj_per_node_group
              and n < self.start_global_sampling_step):
            params = self._proj_step(params, gv, loss)
        elif (not self.is_terminated
              and self.curr_cycle_period < cfg.max_cycle_period):
            if self._cache is None:
                self._set_cache(params)
            params = self._cric_step(params, gv)
        elif self.is_terminated:
            params = self._hybrid_step(params, gv)

        if not self.is_terminated and self._cric_terminate():
            params = self._finalize()
        return params

    # -- metrics --------------------------------------------------------------

    def compute_metrics(self, params) -> Dict[str, float]:
        out = super().compute_metrics(params)
        out["num_violating_groups"] = self.num_active_violating()
        out["num_trial_violating_groups"] = sum(
            len(self.state[g.id]["trial_violating"])
            for g in self._prunable())
        out["num_historical_violating_groups"] = sum(
            len(self.state[g.id]["historical_violating"])
            for g in self._prunable())
        return out
