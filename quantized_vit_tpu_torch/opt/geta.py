"""GETA: joint quantization-aware training and structured pruning
(``quantized_vit_tpu/opt/geta.py``).

Parameters are a params tree with flax's paths and layouts (a model's
``param_tree()``, or the tree a training loop carries); node-group
structure is declarative metadata (:mod:`.groups`), and redundant-group
membership is carried as {0,1} mask vectors, so the masked decay
``p[idx] -= gamma * Q(p)[idx]`` is ``p - gamma * mask * Q(p)``.

Every per-step tensor operation runs on the params' device; :meth:`GETA.step`
returns a new tree (no parameter is written in place). The host makes the
decisions the JAX package makes on the host, and no others: the
projection-period bit ramp-down, the pruning-period group selection (a
global top-K over importance scores, pulled to the host once per period),
freezing the bit layout at the first fix step, and the metrics. The
safeguarded forget-rate/step computation of a pruning step stays on the
device (its closed form, :func:`_gamma_d_device`).

The JAX package traces each phase's update into one jit; here the same
updates run eagerly, a few small launches per parameter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.layers import flatten_tree, tree_map, unflatten_tree
from ..quant.bitwidth import (bit_width, clip_transform, quant_residual,
                              quantize_simple)
from .groups import (NodeGroup, Transform, get_path, group_mask_for_param,
                     group_matrix, group_sq_norms, has_path, set_path)
from .importance import DEFAULT_CRITERIA, combine_importance_scores

QUANT_SUFFIXES = ("d_quant_wt", "q_m_wt", "t_quant_wt",
                  "d_quant_act", "q_m_act", "t_quant_act")


def _is_quant_leaf(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in QUANT_SUFFIXES


@dataclasses.dataclass
class GETAConfig:
    """Hyperparameters (the JAX package's ``GETAConfig``)."""

    lr: float = 1e-3
    lr_quant: float = 1e-3
    variant: str = "sgd"            # 'sgd' | 'adam' | 'adamw'
    first_momentum: float = 0.0
    second_momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    target_group_sparsity: float = 0.5
    start_projection_step: int = 0
    projection_steps: int = 1
    projection_periods: int = 1
    start_pruning_step: int = 1
    pruning_steps: int = 1
    pruning_periods: int = 1
    group_divisible: int = 1
    bit_reduction: float = 2.0
    min_bit_wt: float = 2.0
    max_bit_wt: float = 16.0
    min_bit_act: float = 2.0
    max_bit_act: float = 16.0
    grad_clip_min: float = -1.0
    grad_clip_max: float = 1.0
    importance_criteria: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.variant in ("adam", "adamw"):
            if self.first_momentum == 0.0:
                self.first_momentum = 0.9
            if self.second_momentum == 0.0:
                self.second_momentum = 0.999


def _gamma_d_device(s, t_frac: float, dur: float, lr: float):
    """Forget rate gamma and the new d_quant of a pruning group from its
    statistics, on the device. The reference's safeguard loop
    ``while d_q < d_lower: forget *= 0.8; d_q /= 0.8`` takes the smallest
    k >= 0 with d_q / 0.8^k >= d_lower (capped at 200):
    k = ceil(log(d_lower / d_q) / log(1.25))."""
    eta, zeta, eps = 0.999, 0.9, 1e-8
    clip_norm = torch.sqrt(torch.clamp_min(s["clip_sq"], 0.0))
    grad_norm = torch.sqrt(torch.clamp_min(s["grad_sq"], 0.0))
    res_norm = torch.sqrt(torch.clamp_min(s["res_sq"], 0.0))
    cos_clip = s["clip_dot"] / (torch.clamp_min(clip_norm, eps)
                                * torch.clamp_min(grad_norm, eps))
    cos_res = s["res_dot"] / (torch.clamp_min(res_norm, eps)
                              * torch.clamp_min(grad_norm, eps))

    cc = torch.clamp(cos_clip, -1.0, 1.0)
    forget_pos = 1.0 - (dur - t_frac - 1.0) / (dur - t_frac)
    forget_neg = -(1.0 - eta) * lr * grad_norm / (cc * clip_norm)
    forget = torch.where(cc >= 0.0, forget_pos, forget_neg)
    forget = torch.where((s["clip_mean"] < 1e-8) | ~torch.isfinite(cos_clip),
                         0.0, forget)

    d_upper = s["d_of_min_bit"]   # d(min_bit): the largest step
    d_lower = s["d_of_max_bit"]   # d(max_bit): the smallest step
    use_upper = (cos_res >= 0.0) | (forget == 0.0)
    denom = forget * cos_res * res_norm
    d_raw = -zeta * eta * lr * grad_norm / torch.where(
        denom == 0.0, 1.0, denom)  # guarded; masked by use_upper anyway
    k = torch.ceil(torch.log(torch.clamp_min(d_lower, 1e-38)
                             / torch.clamp_min(d_raw, 1e-38))
                   / math.log(1.25))
    k = torch.clamp(torch.where(d_raw < d_lower, k, 0.0), 0.0, 200.0)
    d_q = torch.minimum(d_upper, d_raw * torch.pow(1.25, k))
    forget = torch.where(use_upper, forget, forget * torch.pow(0.8, k))
    d_q = torch.where(use_upper, d_upper, d_q)
    return forget.to(torch.float32), d_q.to(torch.float32)


def _d_for_bits_scalar(bits: float, q_m, t):
    """d = |q_m|^t / (2^(bits-1) - 1) as a device scalar, from the (1,)
    params (``quant.bitwidth.d_for_bits`` reduced by a max)."""
    q = torch.clamp_min(torch.max(torch.abs(q_m)), 1e-10)
    t = torch.max(t) if t is not None else 1.0
    return torch.exp(t * torch.log(q)) / (2.0 ** (bits - 1.0) - 1.0)


class GETA:
    """Host-side orchestrator around per-step tensor updates::

        opt = GETA(groups, params, cfg)
        for batch in data:
            grads = ...                      # same tree structure
            grads = opt.clip_grads(grads)
            params = opt.step(params, grads)
    """

    def __init__(self, groups: Sequence[NodeGroup], params, cfg: GETAConfig):
        self.cfg = cfg
        self.groups = self._dedup(list(groups))
        self.num_steps = 0
        self.curr_pruning_period = 0
        self.max_bit_wt = float(cfg.max_bit_wt)
        self.max_bit_act = float(cfg.max_bit_act)
        self.bit_layers: Dict[str, Dict[str, int]] = {}
        self.gl_scales: Optional[Dict[str, np.ndarray]] = None
        self.device = next(iter(flatten_tree(params).values())).device

        self.projection_period_duration = max(
            1, cfg.projection_steps // max(1, cfg.projection_periods))
        self.pruning_period_duration = (
            cfg.pruning_steps // max(1, cfg.pruning_periods))

        # prunability bookkeeping
        self.total_num_groups = 0
        for g in self.groups:
            if g.is_prunable and not g.is_auxiliary:
                if g.num_groups <= cfg.group_divisible:
                    g.is_prunable = False
                else:
                    self.total_num_groups += g.num_groups
        self.target_num_redundant_groups = int(
            self.total_num_groups * min(cfg.target_group_sparsity, 0.999))

        # per-period redundant quotas
        self.active_num_redundant_groups: List[int] = []
        acc = 0
        for p in range(cfg.pruning_periods):
            if p == cfg.pruning_periods - 1:
                self.active_num_redundant_groups.append(
                    self.target_num_redundant_groups - acc)
            else:
                q = self.target_num_redundant_groups // cfg.pruning_periods
                self.active_num_redundant_groups.append(q)
                acc += q

        # host index sets per prunable group
        self.state: Dict[str, Dict[str, list]] = {}
        for g in self._prunable():
            self.state[g.id] = {"important": list(range(g.num_groups)),
                                "active_redundant": [], "pruned": []}
        self.pruned_group_idxes: List[int] = []  # global ids
        self._global_layout()

        # quant layers: parent dicts holding kernel + d_quant_wt, attributed
        # to the node group owning the kernel entry
        self.layers: Dict[str, Dict[str, Any]] = {}
        self.group_layers: Dict[str, List[str]] = {g.id: []
                                                   for g in self.groups}
        seen = set()
        for g in self.groups:
            for e in g.entries:
                if not e.path.endswith("/kernel"):
                    continue
                lp = e.path.rsplit("/", 1)[0]
                if lp in seen or not has_path(params, f"{lp}/d_quant_wt"):
                    continue
                seen.add(lp)
                self.layers[lp] = {
                    "nonlinear": has_path(params, f"{lp}/t_quant_wt"),
                    "has_act": has_path(params, f"{lp}/d_quant_act"),
                    "group": g.id,
                }
                self.group_layers[g.id].append(lp)
        # quant layers in no declared group still get the projection clamps
        self._scan_ungrouped_layers(params)

        # optimizer moments
        self.m1 = tree_map(lambda p: torch.zeros_like(p.detach()), params)
        self.m2 = tree_map(lambda p: torch.zeros_like(p.detach()), params)
        self._mask_cache: Dict[str, Dict[str, torch.Tensor]] = {}

    # -- set-up helpers ---------------------------------------------------

    def _dedup(self, groups: List[NodeGroup]) -> List[NodeGroup]:
        """A param belongs to one group only (the first)."""
        seen = set()
        out = []
        for g in groups:
            entries = [e for e in g.entries if e.path not in seen]
            seen.update(e.path for e in entries)
            if entries:
                out.append(dataclasses.replace(g, entries=entries))
        return out

    def _prunable(self) -> List[NodeGroup]:
        return [g for g in self.groups
                if g.is_prunable and not g.is_auxiliary]

    def _global_layout(self):
        start = 0
        self.global_start: Dict[str, int] = {}
        for g in self._prunable():
            self.global_start[g.id] = start
            start += g.num_groups

    def _scan_ungrouped_layers(self, params, prefix: str = ""):
        def visit(node, path):
            if not isinstance(node, dict):
                return
            if "d_quant_wt" in node and path not in self.layers:
                self.layers[path] = {"nonlinear": "t_quant_wt" in node,
                                     "has_act": "d_quant_act" in node,
                                     "group": None}
            for k, v in node.items():
                if isinstance(v, dict):
                    visit(v, f"{path}/{k}" if path else k)

        visit(params, prefix)

    # -- public API -------------------------------------------------------

    def clip_grads(self, grads):
        """Elementwise clamp to [grad_clip_min, grad_clip_max]."""
        lo, hi = self.cfg.grad_clip_min, self.cfg.grad_clip_max
        return tree_map(lambda g: torch.clamp(g, lo, hi), grads)

    def set_lr(self, lr: float):
        self.cfg.lr = float(lr)

    @torch.no_grad()
    def step(self, params, grads):
        """One optimizer step. Returns the new params tree."""
        cfg = self.cfg
        self.num_steps += 1
        n = self.num_steps

        gv, self.m1, self.m2 = _compute_grad_variant(
            params, grads, self.m1, self.m2, n, cfg.variant,
            cfg.first_momentum, cfg.second_momentum, cfg.dampening,
            cfg.weight_decay)

        # projection-window bit ramp-down
        if (cfg.start_projection_step <= n <= cfg.start_pruning_step
                and cfg.start_projection_step != cfg.start_pruning_step):
            k = n - cfg.start_projection_step - 1
            if k % self.projection_period_duration == 0 and k != 0:
                self.max_bit_wt = max(cfg.min_bit_wt, 6,
                                      self.max_bit_wt - cfg.bit_reduction)
                self.max_bit_act = max(cfg.min_bit_act, 6,
                                       self.max_bit_act - cfg.bit_reduction)

        # pruning-period boundary
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

        # freeze the per-layer bits at the first post-pruning step
        fix_phase = n > cfg.start_pruning_step + cfg.pruning_steps
        if fix_phase and not self.bit_layers:
            self.bit_layers = self.bitwidth_dict(params)

        prune_ids = tuple(sorted(
            g.id for g in self._prunable()
            if self.state[g.id]["active_redundant"]))
        if n <= cfg.start_projection_step:
            phase = "warmup"
        elif fix_phase:
            phase = "fix"
        else:
            phase = "range"

        params = self._apply(params, gv, phase, prune_ids, float(t_frac))

        # end-of-period commit
        if (self.pruning_period_duration != 0
                and n >= cfg.start_pruning_step
                and t_frac == self.pruning_period_duration - 1):
            self._commit_redundant()
        return params

    # -- period-boundary host logic -----------------------------------------

    def _commit_redundant(self):
        # membership through sets: the lists hold up to thousands of
        # groups (ViT-B: 3,072 per MLP), and a list scan per index made
        # this quadratic, ~0.5 s of host time per call
        for g in self._prunable():
            st = self.state[g.id]
            st["pruned"].extend(st["active_redundant"])
            st["active_redundant"] = []
            pruned = set(st["pruned"])
            st["important"] = [i for i in range(g.num_groups)
                               if i not in pruned]
        self._mask_cache.clear()

    def _compute_importance(self, params, gv) -> np.ndarray:
        scores, gl = combine_importance_scores(
            self._prunable(), params, gv,
            self.cfg.importance_criteria or DEFAULT_CRITERIA)
        self.gl_scales = {g.id: s.cpu().numpy()
                          for g, s in zip(self._prunable(), gl)}
        return scores.cpu().numpy()

    def _identify_redundant(self, global_scores: np.ndarray):
        """Global top-K smallest scores + the group_divisible refinement.
        Already-pruned candidates are removed keeping score order (the
        JAX package's deliberate deviation from the reference)."""
        cfg = self.cfg
        quota = self.active_num_redundant_groups[self.curr_pruning_period]
        curr_k = min(len(self.pruned_group_idxes) + quota,
                     global_scores.shape[0])
        order = np.argsort(global_scores, kind="stable")
        top = order[:curr_k]
        top = top[~np.isin(top, self.pruned_group_idxes)][:quota]
        self.pruned_group_idxes.extend(top.tolist())

        for g in self._prunable():
            st = self.state[g.id]
            start = self.global_start[g.id]
            local = np.intersect1d(
                top, np.arange(start, start + g.num_groups)) - start
            st["active_redundant"] = local.tolist()
            if g.num_groups < cfg.group_divisible:
                st["active_redundant"] = []
                st["pruned"] = []
            elif cfg.group_divisible > 1:
                n_imp = len(st["important"])
                trial = n_imp - len(st["active_redundant"])
                if trial % cfg.group_divisible != 0 or trial <= 0:
                    ratio = trial // cfg.group_divisible + 1
                    if ratio <= 1 or trial == 0:
                        refined = max(int(cfg.group_divisible), 1)
                    else:
                        refined = max(int(ratio * cfg.group_divisible),
                                      int(cfg.group_divisible))
                    refined = min(g.num_groups, refined)
                    n_active = max(
                        g.num_groups - len(st["pruned"]) - refined, 0)
                    self.target_num_redundant_groups += (
                        n_active - len(st["active_redundant"]))
                    st["active_redundant"] = st["active_redundant"][:n_active]
            drop = set(st["active_redundant"]) | set(st["pruned"])
            st["important"] = [i for i in st["important"] if i not in drop]
        self._mask_cache.clear()

    def _masks(self, which: str) -> Dict[str, torch.Tensor]:
        """{group id: {0,1} f32 mask on the device}; rebuilt only when the
        host index sets change."""
        if which not in self._mask_cache:
            out = {}
            for g in self._prunable():
                m = np.zeros((g.num_groups,), np.float32)
                idx = self.state[g.id][which]
                if idx:
                    m[np.asarray(idx, np.int64)] = 1.0
                out[g.id] = torch.from_numpy(m).to(self.device)
            self._mask_cache[which] = out
        return self._mask_cache[which]

    # -- the per-step updates ---------------------------------------------

    def _gd(self, params, gv, skip=()):
        """Plain descent with the quant / non-quant learning-rate split;
        adamw's decoupled weight decay."""
        cfg = self.cfg
        flat = flatten_tree(params)
        gflat = flatten_tree(gv)
        out = {}
        for path, p in flat.items():
            if path in skip:
                out[path] = p
                continue
            rate = cfg.lr_quant if _is_quant_leaf(path) else cfg.lr
            new = p - rate * gflat[path]
            if cfg.weight_decay and cfg.variant == "adamw":
                new = new - rate * cfg.weight_decay * p
            out[path] = new
        return unflatten_tree(out)

    def _clamp_range(self, params, skip_wt=()):
        """Project d_quant into [d(max_bit), d(min_bit)]."""
        cfg = self.cfg
        for lp, meta in self.layers.items():
            q_m = get_path(params, f"{lp}/q_m_wt")
            t = (get_path(params, f"{lp}/t_quant_wt")
                 if meta["nonlinear"] else None)
            if lp not in skip_wt:
                lo = _d_for_bits_scalar(self.max_bit_wt, q_m, t)
                hi = _d_for_bits_scalar(cfg.min_bit_wt, q_m, t)
                d = get_path(params, f"{lp}/d_quant_wt")
                params = set_path(params, f"{lp}/d_quant_wt",
                                  torch.clamp(d, lo, hi))
            if meta["has_act"]:
                q_ma = get_path(params, f"{lp}/q_m_act")
                ta = (get_path(params, f"{lp}/t_quant_act")
                      if has_path(params, f"{lp}/t_quant_act") else None)
                lo = _d_for_bits_scalar(self.max_bit_act, q_ma, ta)
                hi = _d_for_bits_scalar(cfg.min_bit_act, q_ma, ta)
                da = get_path(params, f"{lp}/d_quant_act")
                params = set_path(params, f"{lp}/d_quant_act",
                                  torch.clamp(da, lo, hi))
        return params

    def _clamp_fix(self, params):
        """Set d to the frozen per-layer bit layout."""
        for lp, bits in self.bit_layers.items():
            if lp not in self.layers:
                continue
            meta = self.layers[lp]
            if "weight" in bits:
                q_m = get_path(params, f"{lp}/q_m_wt")
                t = (get_path(params, f"{lp}/t_quant_wt")
                     if meta["nonlinear"] else None)
                target = _d_for_bits_scalar(float(bits["weight"]), q_m, t)
                d = get_path(params, f"{lp}/d_quant_wt")
                params = set_path(params, f"{lp}/d_quant_wt",
                                  torch.broadcast_to(target, d.shape))
            if "activation" in bits and meta["has_act"]:
                q_ma = get_path(params, f"{lp}/q_m_act")
                ta = (get_path(params, f"{lp}/t_quant_act")
                      if has_path(params, f"{lp}/t_quant_act") else None)
                target = _d_for_bits_scalar(float(bits["activation"]), q_ma,
                                            ta)
                da = get_path(params, f"{lp}/d_quant_act")
                params = set_path(params, f"{lp}/d_quant_act",
                                  torch.broadcast_to(target, da.shape))
        return params

    def _zero_pruned(self, params, pruned_masks):
        """Hard-zero the committed groups (masked multiply)."""
        for g in self._prunable():
            if not self.state[g.id]["pruned"]:
                continue
            mask = pruned_masks[g.id]
            for e in g.entries:
                if e.transform == Transform.NO_PRUNE:
                    continue
                p = get_path(params, e.path)
                m = group_mask_for_param(mask, e.transform, p.shape,
                                         g.num_heads)
                params = set_path(params, e.path, p * (1.0 - m))
        return params

    def _apply(self, params, gv, phase: str, prune_ids, t_frac: float):
        pruned = self._masks("pruned")
        if not prune_ids:
            params = self._gd(params, gv)
            if phase == "fix":
                params = self._clamp_fix(params)
            elif phase == "range":
                params = self._clamp_range(params)
            return self._zero_pruned(params, pruned)
        return self._apply_prune(params, gv, phase, prune_ids, t_frac,
                                 self._masks("active_redundant"), pruned)

    def _group_stats(self, params, gv, gid, mask):
        """Reductions over a pruning group's redundant rows (quant scalars
        taken after this step's descent update)."""
        cfg = self.cfg
        g = self._group_by_id[gid]
        z = torch.zeros((), device=self.device)
        clip_sq = grad_sq = res_sq = clip_dot = res_dot = z
        clip_sum = clip_cnt = qm_max = z
        t_any = None
        w = mask[:, None]
        for e in g.entries:
            if e.transform == Transform.NO_PRUNE:
                continue
            p = get_path(params, e.path).to(torch.float32)
            gvar = get_path(gv, e.path).to(torch.float32)
            lp = self._quant_kernels.get(e.path)
            if lp is not None:
                d = get_path(params, f"{lp}/d_quant_wt")
                q_m = (get_path(params, f"{lp}/q_m_wt")
                       - cfg.lr_quant * get_path(gv, f"{lp}/q_m_wt"))
                t = ((get_path(params, f"{lp}/t_quant_wt")
                      - cfg.lr_quant * get_path(gv, f"{lp}/t_quant_wt"))
                     if self.layers[lp]["nonlinear"] else None)
                clip = clip_transform(p, q_m, t)
                res = quant_residual(p, d, q_m, t)
                qm_max = torch.maximum(qm_max, torch.max(torch.abs(q_m)))
                if t is not None:
                    t_any = torch.max(t)
            else:
                clip = p
                res = torch.zeros_like(p)
            cm = group_matrix(clip, e.transform, g.num_groups, g.num_heads)
            rm = group_matrix(res, e.transform, g.num_groups, g.num_heads)
            gm = group_matrix(gvar, e.transform, g.num_groups, g.num_heads)
            clip_sq = clip_sq + torch.sum(torch.square(cm) * w)
            grad_sq = grad_sq + torch.sum(torch.square(gm) * w)
            res_sq = res_sq + torch.sum(torch.square(rm) * w)
            clip_dot = clip_dot + torch.sum(cm * gm * w)
            res_dot = res_dot + torch.sum(rm * gm * w)
            clip_sum = clip_sum + torch.sum(cm * w)
            clip_cnt = clip_cnt + float(cm.shape[1]) * torch.sum(mask)
        t_eff = t_any if t_any is not None else 1.0
        qm_pow = torch.exp(t_eff * torch.log(torch.clamp_min(qm_max, 1e-10)))
        return dict(
            clip_sq=clip_sq, grad_sq=grad_sq, res_sq=res_sq,
            clip_dot=clip_dot, res_dot=res_dot,
            clip_mean=clip_sum / torch.clamp_min(clip_cnt, 1.0),
            d_of_min_bit=qm_pow / (2.0 ** (cfg.min_bit_wt - 1.0) - 1.0),
            d_of_max_bit=qm_pow / (2.0 ** (self.max_bit_wt - 1.0) - 1.0))

    @property
    def _group_by_id(self):
        return {g.id: g for g in self.groups}

    @property
    def _quant_kernels(self):
        return {f"{lp}/kernel": lp for lp in self.layers}

    def _apply_prune(self, params, gv, phase, prune_ids, t_frac, active,
                     pruned):
        """A pruning step: gamma / d from the redundant rows' statistics;
        the prune groups' quant scalars, d_quant_wt override and masked
        decay; everyone else's usual update."""
        cfg = self.cfg
        by_id = self._group_by_id
        quant_kernels = self._quant_kernels
        prune_layers = {gid: list(self.group_layers[gid])
                        for gid in prune_ids}
        dur = float(self.pruning_period_duration)
        gammas, ds = {}, {}
        for gid in prune_ids:
            stats = self._group_stats(params, gv, gid, active[gid])
            gammas[gid], ds[gid] = _gamma_d_device(stats, t_frac, dur,
                                                   cfg.lr)
        # 1. quant-scalar descent for prune groups (the *_act trio and
        #    t/q_m_wt; d_quant_wt is overwritten below)
        for gid in prune_ids:
            for lp in prune_layers[gid]:
                for name in ("q_m_wt", "t_quant_wt", "d_quant_act",
                             "q_m_act", "t_quant_act"):
                    fp = f"{lp}/{name}"
                    if has_path(params, fp):
                        params = set_path(params, fp, get_path(params, fp)
                                          - cfg.lr_quant * get_path(gv, fp))
        # 2. d_quant_wt := the computed step
        for gid in prune_ids:
            for lp in prune_layers[gid]:
                d = get_path(params, f"{lp}/d_quant_wt")
                params = set_path(params, f"{lp}/d_quant_wt",
                                  torch.broadcast_to(ds[gid], d.shape))
        # 3. masked decay + descent for the prune groups' tensors:
        #    p -= gamma * mask * (Q(p) | p), then -= lr * gv
        for gid in prune_ids:
            g = by_id[gid]
            for e in g.entries:
                if e.transform == Transform.NO_PRUNE:
                    continue
                p = get_path(params, e.path)
                m = group_mask_for_param(active[gid], e.transform, p.shape,
                                         g.num_heads)
                lp = quant_kernels.get(e.path)
                if lp is not None:
                    t = (get_path(params, f"{lp}/t_quant_wt")
                         if self.layers[lp]["nonlinear"] else None)
                    decay_src = quantize_simple(
                        p, get_path(params, f"{lp}/d_quant_wt"),
                        get_path(params, f"{lp}/q_m_wt"), t)
                else:
                    decay_src = p
                new = p - gammas[gid] * m * decay_src
                new = new - cfg.lr * get_path(gv, e.path)
                params = set_path(params, e.path, new)
        # 4. everyone else: their usual branch. NO_PRUNE entries of prune
        #    groups that are not quant scalars (lora_a) keep plain descent
        skip = set()
        for gid in prune_ids:
            for e in by_id[gid].entries:
                if (e.transform != Transform.NO_PRUNE
                        or _is_quant_leaf(e.path)):
                    skip.add(e.path)
            for lp in prune_layers[gid]:
                skip.update(f"{lp}/{name}" for name in QUANT_SUFFIXES)
        params = self._gd(params, gv, skip=skip)
        if phase == "fix":
            params = self._clamp_fix(params)
        elif phase == "range":
            # prune-mode layers keep their d_quant_wt override; the act side
            # still range-clamps
            params = self._clamp_range(params, skip_wt={
                lp for gid in prune_ids for lp in prune_layers[gid]})
        return self._zero_pruned(params, pruned)

    # -- metrics / introspection ------------------------------------------

    def bitwidth_dict(self, params) -> Dict[str, Dict[str, int]]:
        """Per-layer rounded bit widths (host)."""
        out = {}
        for lp, meta in self.layers.items():
            d = get_path(params, f"{lp}/d_quant_wt")
            q_m = get_path(params, f"{lp}/q_m_wt")
            t = (get_path(params, f"{lp}/t_quant_wt") if meta["nonlinear"]
                 else None)
            entry = {"weight": int(round(float(bit_width(d, q_m, t)[0])))}
            if meta["has_act"]:
                da = get_path(params, f"{lp}/d_quant_act")
                qa = get_path(params, f"{lp}/q_m_act")
                ta = (get_path(params, f"{lp}/t_quant_act")
                      if has_path(params, f"{lp}/t_quant_act") else None)
                entry["activation"] = int(round(float(
                    bit_width(da, qa, ta)[0])))
            out[lp] = entry
        return out

    def compute_metrics(self, params) -> Dict[str, float]:
        """Group-sparsity metrics (host)."""
        norm_params = norm_imp = norm_red = 0.0
        num_zero = num_imp = num_red = 0
        for g in self._prunable():
            norms = torch.sqrt(group_sq_norms(g, params)).cpu().numpy()
            st = self.state[g.id]
            imp = np.asarray(st["important"], np.int64)
            red = np.asarray(st["active_redundant"] + st["pruned"], np.int64)
            num_zero += int((norms == 0).sum())
            norm_params += float(norms.sum())
            norm_imp += float(norms[imp].sum()) if imp.size else 0.0
            norm_red += float(norms[red].sum()) if red.size else 0.0
            num_imp += len(st["important"])
            num_red += len(red)
        return {
            "norm_params": norm_params,
            "norm_important_groups": norm_imp,
            "norm_redundant_groups": norm_red,
            "num_zero_groups": num_zero,
            "num_important_groups": num_imp,
            "num_redundant_groups": num_red,
            "group_sparsity": num_zero / float(self.total_num_groups + 1e-8),
        }

    # -- checkpointing (numpy only; the JAX package reads it) -------------

    def state_dict(self) -> Dict[str, Any]:
        to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
        return {
            "num_steps": self.num_steps,
            "curr_pruning_period": self.curr_pruning_period,
            "max_bit_wt": self.max_bit_wt,
            "max_bit_act": self.max_bit_act,
            "bit_layers": dict(self.bit_layers),
            "pruned_group_idxes": [int(i) for i in self.pruned_group_idxes],
            "group_state": {k: {kk: [int(i) for i in vv]
                                for kk, vv in v.items()}
                            for k, v in self.state.items()},
            "target_num_redundant_groups": self.target_num_redundant_groups,
            "m1": tree_map(to_np, self.m1),
            "m2": tree_map(to_np, self.m2),
            "config": dataclasses.asdict(self.cfg),
        }

    def load_state_dict(self, sd: Dict[str, Any]):
        self.num_steps = int(sd["num_steps"])
        self.curr_pruning_period = int(sd["curr_pruning_period"])
        self.max_bit_wt = float(sd["max_bit_wt"])
        self.max_bit_act = float(sd["max_bit_act"])
        self.bit_layers = dict(sd["bit_layers"])
        self.pruned_group_idxes = list(sd["pruned_group_idxes"])
        self.target_num_redundant_groups = int(
            sd["target_num_redundant_groups"])
        for k, v in sd["group_state"].items():
            if k in self.state:
                self.state[k] = {kk: list(vv) for kk, vv in v.items()}
        to_dev = lambda a: torch.as_tensor(np.asarray(a)).to(self.device)  # noqa: E731,E501
        self.m1 = tree_map(to_dev, sd["m1"])
        self.m2 = tree_map(to_dev, sd["m2"])
        self._mask_cache.clear()


# ---------------------------------------------------------------------------
# grad variant
# ---------------------------------------------------------------------------


def _compute_grad_variant(params, grads, m1, m2, step: int, variant: str,
                          first_momentum: float, second_momentum: float,
                          dampening: float, weight_decay: float):
    """Momentum / Adam gradient estimate with bias correction. Returns
    (grad_variant, m1, m2), trees like params."""
    is_adam = variant in ("adam", "adamw")
    f32 = np.float32
    c1 = float(f32(1.0) - f32(first_momentum) ** f32(step))
    c2 = float(f32(1.0) - f32(second_momentum) ** f32(step))

    def upd(p, g, b1, b2):
        g = g.to(p.dtype)
        if weight_decay and variant != "adamw":
            g = g + weight_decay * p
        if not is_adam:
            if first_momentum > 0.0 or dampening > 0.0:
                b1 = (g if step == 1
                      else first_momentum * b1 + (1.0 - dampening) * g)
                return b1, b1, b2
            return g, b1, b2
        if step == 1:
            b1, b2 = g, g * g
        else:
            b1 = first_momentum * b1 + (1.0 - first_momentum) * g
            b2 = second_momentum * b2 + (1.0 - second_momentum) * g * g
        gv = (b1 / c1) / (torch.sqrt(b2 / c2) + 1e-8)
        return gv, b1, b2

    fp, fg, fa, fb = (flatten_tree(t) for t in (params, grads, m1, m2))
    out = {k: upd(fp[k], fg[k], fa[k], fb[k]) for k in fp}
    return tuple(unflatten_tree({k: v[i] for k, v in out.items()})
                 for i in range(3))
