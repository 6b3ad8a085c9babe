"""Group importance scores: the five GETA saliency criteria, their global
L2 normalisation and weighted sum, and the cost-aware group-lasso scales
(``quantized_vit_tpu/opt/importance.py``). Functions over (params,
grad_variant) trees; each score is a [num_groups] tensor per prunable
group, on the params' device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .groups import NodeGroup, Transform, get_path, group_cols, group_matrix

_EPS = 1e-8
DEFAULT_CRITERIA: Dict[str, float] = {
    "magnitude": 0.2,
    "avg_magnitude": 0.2,
    "cosine_similarity": 0.2,
    "taylor_first_order": 0.2,
    "taylor_second_order": 0.2,
}


def _norms_and_inner(group: NodeGroup, params, grad_variant):
    """(||p||^2, ||g||^2, <p, g>) per group row and the group's total
    columns; NO_PRUNE entries skipped. A ``lora_b`` entry's gradient proxy
    is ``lora_a @ lora_b`` against the base kernel."""
    dev = None
    sq_p = sq_g = inner = None
    cols = 0
    for e in group.entries:
        if e.transform == Transform.NO_PRUNE:
            continue
        p_arr = get_path(params, e.path)
        if dev is None:
            dev = p_arr.device
            sq_p = torch.zeros((group.num_groups,), device=dev)
            sq_g = torch.zeros((group.num_groups,), device=dev)
            inner = torch.zeros((group.num_groups,), device=dev)
        p = group_matrix(p_arr, e.transform, group.num_groups,
                         group.num_heads).to(torch.float32)
        cols += p.shape[1]
        sq_p = sq_p + torch.sum(torch.square(p), dim=1)
        if e.path.endswith("lora_b"):
            layer = e.path.rsplit("/", 1)[0]
            node = get_path(params, layer)
            base = node["kernel"] if "kernel" in node else node["embedding"]
            proxy = get_path(params, f"{layer}/lora_a") @ p_arr
            bm = group_matrix(base, e.transform, group.num_groups,
                              group.num_heads).to(torch.float32)
            gm = group_matrix(proxy, e.transform, group.num_groups,
                              group.num_heads).to(torch.float32)
            sq_g = sq_g + torch.sum(torch.square(gm), dim=1)
            inner = inner + torch.sum(bm * gm, dim=1)
            continue
        g = group_matrix(get_path(grad_variant, e.path), e.transform,
                         group.num_groups, group.num_heads).to(torch.float32)
        sq_g = sq_g + torch.sum(torch.square(g), dim=1)
        inner = inner + torch.sum(p * g, dim=1)
    if sq_p is None:
        z = torch.zeros((group.num_groups,))
        return z, z, z, cols
    return sq_p, sq_g, inner, cols


def raw_scores(group: NodeGroup, params, grad_variant,
               criteria: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Per-criterion raw scores of one group."""
    sq_p, sq_g, inner, cols = _norms_and_inner(group, params, grad_variant)
    norm_p = torch.sqrt(sq_p)
    out: Dict[str, torch.Tensor] = {}
    if "magnitude" in criteria:
        out["magnitude"] = norm_p
    if "avg_magnitude" in criteria:
        # denominator: total column count + 1e-6
        out["avg_magnitude"] = norm_p / float(cols + 1e-6)
    if "cosine_similarity" in criteria:
        # cos + 1 (so >= 0)
        norm_g = torch.sqrt(sq_g)
        out["cosine_similarity"] = (
            inner / (norm_p + _EPS) / (norm_g + _EPS) + 1.0)
    if "taylor_first_order" in criteria:
        out["taylor_first_order"] = torch.abs(inner)
    if "taylor_second_order" in criteria:
        out["taylor_second_order"] = 0.5 * torch.square(inner)
    return out


def combine_importance_scores(
    groups: Sequence[NodeGroup],
    params,
    grad_variant,
    criteria: Dict[str, float] = None,
    safe_guard: float = _EPS,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The global score pipeline:

    1. raw per-criterion scores for each prunable non-auxiliary group;
    2. per-criterion global L2 normalisation, denom = sqrt(sum of every
       group's score^2 + safe_guard) + safe_guard;
    3. overall = sum_c weight_c / denom_c * score_c;
    4. gl_scale_i = clamp(cost^0.5 / |overall_i|, 0.1, 10) over the global
       mean: the group-lasso weight of the training loss.

    Returns (global_scores [total groups] in group order, gl_scales)."""
    criteria = dict(DEFAULT_CRITERIA if criteria is None else criteria)
    active = [g for g in groups if g.is_prunable and not g.is_auxiliary]
    raw = [raw_scores(g, params, grad_variant, list(criteria))
           for g in active]

    denoms = {
        name: torch.sqrt(
            sum(torch.sum(torch.square(r[name])) for r in raw) + safe_guard
        ) + safe_guard
        for name in criteria
    }
    overalls = [sum((criteria[name] / denoms[name]) * r[name]
                    for name in criteria) for r in raw]

    # cost-aware group-lasso scale (rho = 0.5, clamped to [0.1, 10])
    rho = 0.5
    invs = []
    for g, overall in zip(active, overalls):
        cost = float(group_cols(g, params)) ** rho
        inv = cost / torch.clamp_min(torch.abs(overall), _EPS)
        invs.append(torch.clamp(torch.nan_to_num(
            inv, nan=1.0, posinf=10.0, neginf=0.1), 0.1, 10.0))
    if invs:
        mean = torch.clamp_min(torch.mean(torch.cat(invs)), _EPS)
        gl_scales = [inv / mean for inv in invs]
        global_scores = torch.cat(overalls)
    else:
        gl_scales, global_scores = [], torch.zeros((0,))
    return global_scores, gl_scales
