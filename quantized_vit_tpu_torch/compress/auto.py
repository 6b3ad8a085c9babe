"""Generic subnet construction for automatically discovered groups
(``quantized_vit_tpu/compress/auto.py``).

The reference's ``automated_pruning_compression``
(only_train_once/subnet_construction/pruning_compression.py:4-391) slices
any traced model: pass 1 prunes each node group's out-dim (:51-58), pass 2
finds the incoming stem group by DFS and prunes in-dims (:134-215),
expanding flatten->linear indices (:335-346). Here the links come from the
dataflow walk that discovered the groups
(``graph.autogroups.discover_node_groups(return_plan=True)``):

- pass 1 (out-dims): per group, the kernels' last axis and the
  (out,)-shaped accessories (bias, BN/LN scale, ...) keep the non-zero
  group rows; the (C,)-shaped ``batch_stats`` leaves (BN running mean and
  variance) under the group's accessory layers are sliced alike;
- pass 2 (in-dims): per stem, the producer group's kept indices, expanded
  by the recorded flatten multiplicity (channels fastest-varying), slice
  the kernel's in axis (0 for a dense [in, out] kernel, 2 for a conv
  HWIO); a depthwise kernel has no in axis to slice (its channel dim is
  the group).

The sliced-away rows and columns are zero (GETA/HESSO drive them there
before construction), so the compressed forward equals the sparse one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..graph.autogroups import StemPlan
from ..models.layers import flatten_tree
from ..opt.groups import NodeGroup, Transform, get_path, has_path, set_path
from .subnet import _kept_nonempty, _take


def _layer_of(path: str) -> str:
    return path.rsplit("/", 1)[0] if "/" in path else path


def construct_subnet_auto(
    params,
    groups: Sequence[NodeGroup],
    plan: Dict[str, StemPlan],
    batch_stats=None,
) -> Tuple[Any, Dict[str, Tuple[int, ...]], Optional[Any]]:
    """Slice a group-sparse model with discovered groups.

    Returns ``(new_params, shapes, new_batch_stats)``: ``shapes`` maps each
    stem layer to its new kernel shape, from which a caller rebuilds its
    module at the new widths (``models.bind_tree`` binds the returned
    trees to it)."""
    by_id = {g.id: g for g in groups}
    kept: Dict[str, np.ndarray] = {}
    for g in groups:
        if g.is_prunable and not g.is_auxiliary:
            kept[g.id] = _kept_nonempty(g, params)

    new = params
    new_stats = batch_stats

    # ---- pass 1: out-dims and accessories, per group -------------------
    for g in groups:
        idx = kept.get(g.id)
        if idx is None or len(idx) == g.num_groups:
            continue
        acc_layers = set()
        for e in g.entries:
            if e.transform == Transform.NO_PRUNE:
                continue
            p = get_path(new, e.path)
            if e.transform == Transform.ACCESSORY:
                new = set_path(new, e.path, _take(p, idx, 0))
                acc_layers.add(_layer_of(e.path))
            else:  # OUT kernels (depthwise ones too): the group dim is last
                new = set_path(new, e.path, _take(p, idx, -1))
        if new_stats is not None:
            for layer in sorted(acc_layers):
                for path, v in flatten_tree(new_stats).items():
                    if (_layer_of(path) == layer
                            and tuple(v.shape) == (g.num_groups,)):
                        new_stats = set_path(new_stats, path,
                                             _take(v, idx, 0))

    # ---- pass 2: in-dims, per stem --------------------------------------
    for kpath, sp in plan.items():
        if sp.depthwise or sp.in_group_id is None:
            # a depthwise kernel's channel dim was sliced as the group dim;
            # an unlinked (or ambiguous) in-feed is kept whole
            continue
        idx = kept.get(sp.in_group_id)
        g_in = by_id.get(sp.in_group_id)
        if idx is None or g_in is None or len(idx) == g_in.num_groups:
            continue
        if sp.in_spatial > 1:
            # the flatten expansion: feature index = position * C + channel
            idx = (np.arange(sp.in_spatial)[:, None] * sp.in_channels
                   + idx[None, :]).reshape(-1)
        k = get_path(new, kpath)
        new = set_path(new, kpath, _take(k, idx, 0 if k.ndim == 2 else 2))

    shapes = {_layer_of(kpath): tuple(get_path(new, kpath).shape)
              for kpath in plan if has_path(new, kpath)}
    return new, shapes, new_stats
