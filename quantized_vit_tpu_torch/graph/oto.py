"""OTO facade over node groups, the GETA / HESSO / HESSO-CRIC optimizers,
subnet construction and the cost metrics (``quantized_vit_tpu/graph/oto.py``),
for the ViT family and UltraNet; the other model families are in
ROADMAP.md, modules to port, 'Other model families, interop,
auto-discovery'.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.ultranet import UltraNet
from ..models.ultranet import params_from_jax as ultranet_for_params
from ..models.vit import ViTConfig, VisionTransformer, model_for_params
from ..opt import (GETA, HESSO, HESSOCRIC, GETAConfig, HESSOConfig,
                   HESSOCRICConfig, NodeGroup)
from ..opt.groups import Transform, get_path, group_mask_for_param, set_path
from .builders import mark_unprunable, ultranet_node_groups, vit_node_groups
from .costs import ultranet_cost_report, vit_cost_report


class OTO:
    """Node groups + GETA::

        oto = OTO(model, params)
        oto.mark_unprunable_by_param_names(["patch_embed", "pos_embed",
                                            "cls_token", "head"])
        opt = oto.geta(lr=1e-4, target_group_sparsity=0.5, ...)
        ... params = opt.step(params, grads) ...
        new_model, new_params = oto.construct_subnet(params)

    ``params`` is a params tree with flax's paths (default: the model's
    own ``param_tree()``). For UltraNet (``kind == "ultranet"``) the BN
    running statistics come as ``batch_stats`` (default: the model's
    ``batch_stats_tree()``), and ``construct_subnet`` returns
    ``(model, params, batch_stats)``."""

    def __init__(self, model, params=None, batch_stats=None):
        if not isinstance(model, (VisionTransformer, UltraNet)):
            raise NotImplementedError(
                f"no node-group builder ported for {type(model).__name__}: "
                "the port has the ViT family and UltraNet; the other "
                "families (ResNet, MobileNet, the separate-q/k/v "
                "Transformer, the autoencoder, LoRA) and the automatic "
                "grouping are in ROADMAP.md, modules to port, 'Other model "
                "families, interop, auto-discovery'")
        self.model = model
        self.params = model.param_tree() if params is None else params
        self.batch_stats = batch_stats
        if isinstance(model, VisionTransformer):
            self.kind = "vit"
            self.cfg: Optional[ViTConfig] = model.cfg
            self.node_groups: List[NodeGroup] = vit_node_groups(
                self.cfg, self.params)
        else:
            self.kind = "ultranet"
            self.cfg = None
            if batch_stats is None:
                self.batch_stats = model.batch_stats_tree()
            self.node_groups = ultranet_node_groups(self.params)
        self._optimizer = None

    def mark_unprunable_by_param_names(self, names: Sequence[str]):
        mark_unprunable(self.node_groups, list(names))

    def geta(self, **kwargs) -> GETA:
        self._optimizer = GETA(self.node_groups, self.params,
                               GETAConfig(**kwargs))
        return self._optimizer

    def hesso(self, **kwargs) -> HESSO:
        self._optimizer = HESSO(self.node_groups, self.params,
                                HESSOConfig(**kwargs))
        return self._optimizer

    def hesso_cric(self, **kwargs) -> HESSOCRIC:
        """The cyclic redundancy identification variant: pass the loss
        into ``step(params, grads, loss=...)``."""
        self._optimizer = HESSOCRIC(self.node_groups, self.params,
                                    HESSOCRICConfig(**kwargs))
        return self._optimizer

    # ------------------------------------------------------------------
    # compression
    # ------------------------------------------------------------------

    def construct_subnet(self, params=None, batch_stats=None):
        """Slice the group-sparse net into a dense subnet. ViT:
        (VisionTransformer of the config with per-block widths, new
        params); the model holds the new params' tensors themselves
        (``models.model_for_params``) and ``models.apply`` runs it on them,
        as the JAX package runs its module on the params it returns.
        UltraNet: (UltraNet at the kept widths, new params, new
        batch_stats); the model holds copies of both trees and
        ``models.ultranet_apply`` runs it on the trees."""
        from ..compress import construct_subnet_ultranet, construct_subnet_vit

        params = self.params if params is None else params
        if self.kind == "ultranet":
            _, new_params, new_stats = construct_subnet_ultranet(
                params, self.node_groups,
                self.batch_stats if batch_stats is None else batch_stats)
            model = ultranet_for_params(
                new_params, new_stats,
                device=new_params["conv_0"]["kernel"].device,
                w_bit=self.model.w_bit, a_bit=self.model.a_bit)
            return model, new_params, new_stats
        new_cfg, new_params = construct_subnet_vit(self.cfg, params,
                                                   self.node_groups)
        return model_for_params(new_cfg, new_params), new_params

    # ------------------------------------------------------------------
    # cost metrics
    # ------------------------------------------------------------------

    def _report(self, params=None) -> Dict[str, Any]:
        params = self.params if params is None else params
        # the compute_* metrics call this back to back on the same tree:
        # memoised on the tree object's identity
        cached = getattr(self, "_report_cache", None)
        if cached is not None and cached[0] is params:
            return cached[1]
        rep = (ultranet_cost_report(params) if self.kind == "ultranet"
               else vit_cost_report(self.cfg, params))
        self._report_cache = (params, rep)
        return rep

    def compute_macs(self, params=None) -> float:
        return self._report(params)["total_macs"]

    def compute_bops(self, params=None) -> float:
        return self._report(params)["total_bops"]

    def compute_num_params(self, params=None) -> int:
        return self._report(params)["num_params"]

    def compute_weight_size(self, params=None) -> float:
        """Total weight bits under the learned bit widths."""
        return self._report(params)["weight_size_bits"]

    def compute_average_bit_width(self, params=None) -> float:
        return self._report(params)["average_bit_width"]

    # ------------------------------------------------------------------
    # visualization and debugging
    # ------------------------------------------------------------------

    def cluster_node_groups(self, num_clusters: int = 1):
        """Cluster the prunable node groups by size: a 1-D Lloyd loop from
        evenly spaced quantiles (the JAX package's stand-in for KMeans).
        Returns {cluster_id: [NodeGroup, ...]}."""
        prunable = [g for g in self.node_groups
                    if g.is_prunable and not g.is_auxiliary]
        if num_clusters <= 1:
            self.node_group_clusters = {0: list(prunable)}
            return self.node_group_clusters
        if len(prunable) <= num_clusters:
            # fewer groups than clusters: singletons (KMeans' behaviour)
            self.node_group_clusters = {i: [g]
                                        for i, g in enumerate(prunable)}
            return self.node_group_clusters
        sizes = np.array([float(g.num_groups) for g in prunable])
        centers = np.quantile(sizes, np.linspace(0, 1, num_clusters))
        for _ in range(50):
            labels = np.argmin(np.abs(sizes[:, None] - centers[None, :]),
                               axis=1)
            new = np.array([
                sizes[labels == c].mean() if (labels == c).any()
                else centers[c] for c in range(num_clusters)])
            if np.allclose(new, centers):
                break
            centers = new
        self.node_group_clusters = {}
        for g, lab in zip(prunable, labels):
            self.node_group_clusters.setdefault(int(lab), []).append(g)
        return self.node_group_clusters

    def random_set_zero_groups(self, params=None,
                               target_group_sparsity: Optional[float] = None,
                               num_group_divisible: int = 2, seed: int = 0):
        """Zero whole groups at random, to exercise ``construct_subnet``
        without training. Draws from ``np.random.default_rng(seed)`` in
        the JAX function's order, so one seed zeroes the same groups in
        both packages; a fixed ``target_group_sparsity`` zeroes the same
        share of every group (a uniform subnet). Returns a new params
        tree."""
        params = self.params if params is None else params
        rng = np.random.default_rng(seed)
        for g in self.node_groups:
            if not g.is_prunable or g.is_auxiliary:
                continue
            gs = (rng.random() if target_group_sparsity is None
                  else target_group_sparsity)
            assert 0.0 <= gs < 1.0
            n_zero = max(min(int(gs * g.num_groups) // num_group_divisible
                             * num_group_divisible, g.num_groups - 1), 0)
            if n_zero == 0:
                continue
            idx = np.sort(rng.choice(g.num_groups, n_zero, replace=False))
            mask = np.zeros((g.num_groups,), np.float32)
            mask[idx] = 1.0
            for e in g.entries:
                if e.transform == Transform.NO_PRUNE:
                    continue
                p = get_path(params, e.path)
                m = group_mask_for_param(
                    torch.from_numpy(mask).to(p.device), e.transform,
                    tuple(p.shape), g.num_heads)
                params = set_path(params, e.path, p * (1.0 - m))
        return params

    def visualize(self, out_path: Optional[str] = None) -> str:
        """The node-group structure as Graphviz DOT text (layout-order
        invisible edges, as for the JAX package's declared families)."""
        lines = ["digraph node_groups {", "  rankdir=TB;",
                 '  node [shape=box, fontname="helvetica"];']
        for g in self.node_groups:
            color = "lightblue" if g.is_prunable else "lightgray"
            label = (f"{g.id}\\n{g.num_groups} groups"
                     f"{' (unprunable)' if not g.is_prunable else ''}")
            lines.append(
                f'  "{g.id}" [label="{label}", style=filled,'
                f' fillcolor={color}];')
        ordered = [g.id for g in self.node_groups]
        for a, b in zip(ordered, ordered[1:]):
            lines.append(f'  "{a}" -> "{b}" [style=invis];')
        lines.append("}")
        dot = "\n".join(lines)
        if out_path:
            with open(out_path, "w") as f:
                f.write(dot)
        return dot
