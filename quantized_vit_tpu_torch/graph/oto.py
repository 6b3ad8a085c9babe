"""OTO facade over node groups and the GETA optimizer
(``quantized_vit_tpu/graph/oto.py``), for the ViT family. Subnet
construction and the cost reports come with ``compress/subnet.py`` and
``graph/costs.py`` (ROADMAP.md, modules to port, 'Train -> compress ->
export -> serve'); other model families with 'Other model families,
interop, auto-discovery'.
"""

from __future__ import annotations

from typing import List, Sequence

from ..models.vit import ViTConfig, VisionTransformer
from ..opt import GETA, GETAConfig, NodeGroup
from .builders import mark_unprunable, vit_node_groups


class OTO:
    """Node groups + GETA::

        oto = OTO(model, params)
        oto.mark_unprunable_by_param_names(["patch_embed", "pos_embed",
                                            "cls_token", "head"])
        opt = oto.geta(lr=1e-4, target_group_sparsity=0.5, ...)
        ... params = opt.step(params, grads) ...

    ``params`` is a params tree with flax's paths (default: the model's
    own ``param_tree()``)."""

    def __init__(self, model, params=None):
        if not isinstance(model, VisionTransformer):
            raise NotImplementedError(
                f"no node-group builder ported for {type(model).__name__}: "
                "the port has the ViT family only; the other families and "
                "the automatic grouping are in ROADMAP.md, modules to "
                "port, 'Other model families, interop, auto-discovery'")
        self.model = model
        self.params = model.param_tree() if params is None else params
        self.kind = "vit"
        self.cfg: ViTConfig = model.cfg
        self.node_groups: List[NodeGroup] = vit_node_groups(self.cfg,
                                                            self.params)
        self._optimizer = None

    def mark_unprunable_by_param_names(self, names: Sequence[str]):
        mark_unprunable(self.node_groups, list(names))

    def geta(self, **kwargs) -> GETA:
        self._optimizer = GETA(self.node_groups, self.params,
                               GETAConfig(**kwargs))
        return self._optimizer
