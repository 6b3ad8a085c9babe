"""OTO facade over node groups, the GETA / HESSO / HESSO-CRIC optimizers,
subnet construction and the cost metrics (``quantized_vit_tpu/graph/oto.py``),
for the ViT family, UltraNet, ResNet, MobileNet, the separate-q/k/v
Transformer and the conv autoencoder (LoRA layers take their entries from
``builders.lora_layer_entries`` into groups of their own). The automatic
grouping of any other model is in ROADMAP.md, modules to port, 'Other
model families, interop, auto-discovery' (item 6d).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.autoencoder import ConvAutoencoder
from ..models.mobilenet import MobileNet
from ..models.resnet import ResNet
from ..models.transformer import TransformerEncoder
from ..models.ultranet import UltraNet
from ..models.ultranet import params_from_jax as ultranet_for_params
from ..models.layers import bind_tree
from ..models.vit import VisionTransformer
from ..opt import (GETA, HESSO, HESSOCRIC, GETAConfig, HESSOConfig,
                   HESSOCRICConfig, NodeGroup)
from ..opt.groups import Transform, get_path, group_mask_for_param, set_path
from .builders import (autoencoder_node_groups, mark_unprunable,
                       mobilenet_node_groups, resnet_node_groups,
                       transformer_node_groups, ultranet_node_groups,
                       vit_node_groups)
from .costs import (autoencoder_cost_report, mobilenet_cost_report,
                    resnet_cost_report, transformer_cost_report,
                    ultranet_cost_report, vit_cost_report)

# model class -> (kind, node-group builder over (cfg, params), cost report
# over (cfg, params)); UltraNet's take no config
_FAMILIES = {
    VisionTransformer: ("vit", vit_node_groups, vit_cost_report),
    ResNet: ("resnet", resnet_node_groups, resnet_cost_report),
    MobileNet: ("mobilenet", mobilenet_node_groups, mobilenet_cost_report),
    TransformerEncoder: ("transformer", transformer_node_groups,
                         transformer_cost_report),
    ConvAutoencoder: ("autoencoder", autoencoder_node_groups,
                      autoencoder_cost_report),
}


class OTO:
    """Node groups + GETA::

        oto = OTO(model, params)
        oto.mark_unprunable_by_param_names(["patch_embed", "pos_embed",
                                            "cls_token", "head"])
        opt = oto.geta(lr=1e-4, target_group_sparsity=0.5, ...)
        ... params = opt.step(params, grads) ...
        new_model, new_params = oto.construct_subnet(params)

    ``params`` is a params tree with flax's paths (default: the model's
    own ``param_tree()``). For the families with BatchNorms (UltraNet,
    ResNet, MobileNet) the running statistics come as ``batch_stats``
    (default: the model's ``batch_stats_tree()``), and
    ``construct_subnet`` returns ``(model, params, batch_stats)``."""

    def __init__(self, model, params=None, batch_stats=None):
        family = next((f for cls, f in _FAMILIES.items()
                       if isinstance(model, cls)), None)
        if family is None and not isinstance(model, UltraNet):
            raise NotImplementedError(
                f"no node-group builder ported for {type(model).__name__}: "
                "the port has the ViT family, UltraNet, ResNet, MobileNet, "
                "the separate-q/k/v Transformer and the conv autoencoder "
                "(LoRA layers through builders.lora_layer_entries); the "
                "automatic grouping of other models (item 6d) is in "
                "ROADMAP.md, modules to port, 'Other model families, "
                "interop, auto-discovery'")
        self.model = model
        self.params = model.param_tree() if params is None else params
        self.batch_stats = batch_stats
        if family is None:
            self.kind = "ultranet"
            self.cfg = None
            self.node_groups: List[NodeGroup] = ultranet_node_groups(
                self.params)
        else:
            self.kind, builder, self._cost_report = family
            self.cfg = model.cfg
            self.node_groups = builder(self.cfg, self.params)
        if batch_stats is None and self.kind in ("ultranet", "resnet",
                                                 "mobilenet"):
            self.batch_stats = model.batch_stats_tree()
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
        """Slice the group-sparse net into a dense subnet. The returned
        model holds the returned trees' tensors themselves (built on the
        meta device, ``models.bind_tree``; ``models.apply`` /
        ``models.apply_variables`` run it on them), as the JAX package
        runs its module on the trees it returns, but UltraNet's, which
        holds copies. ViT, Transformer,
        autoencoder: (model of the subnet's config, params); ResNet,
        MobileNet, UltraNet: (model, params, batch_stats)."""
        from ..compress import (construct_subnet_autoencoder,
                                construct_subnet_mobilenet,
                                construct_subnet_resnet,
                                construct_subnet_transformer,
                                construct_subnet_ultranet,
                                construct_subnet_vit)

        params = self.params if params is None else params
        stats = self.batch_stats if batch_stats is None else batch_stats
        if self.kind == "ultranet":
            _, new_params, new_stats = construct_subnet_ultranet(
                params, self.node_groups, stats)
            model = ultranet_for_params(
                new_params, new_stats,
                device=new_params["conv_0"]["kernel"].device,
                w_bit=self.model.w_bit, a_bit=self.model.a_bit)
            return model, new_params, new_stats
        if self.kind in ("resnet", "mobilenet"):
            fn = (construct_subnet_resnet if self.kind == "resnet"
                  else construct_subnet_mobilenet)
            new_cfg, new_params, new_stats = fn(self.cfg, params,
                                                self.node_groups, stats)
            return (bind_tree(type(self.model)(new_cfg, device="meta"),
                              new_params, new_stats), new_params, new_stats)
        fn = {"vit": construct_subnet_vit,
              "transformer": construct_subnet_transformer,
              "autoencoder": construct_subnet_autoencoder}[self.kind]
        new_cfg, new_params = fn(self.cfg, params, self.node_groups)
        return (bind_tree(type(self.model)(new_cfg, device="meta"),
                          new_params), new_params)

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
               else self._cost_report(self.cfg, params))
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
