"""The (dp, tp) process layout and the partition rules (port of
``quantized_vit_tpu/parallel/partition.py``).

A JAX ``Mesh`` lays devices out on named axes and GSPMD places each
array by its ``PartitionSpec``. Here each device is a process of the
gloo group (one card shared by the processes, or the cards of one host):
:func:`create_mesh` lays the world's ranks out row-major, as
``Mesh(devices.reshape(shape))`` does, and gives each axis its gloo
subgroups (:class:`ProcessMesh`). A rank holds only its own shard of each
array; the rules say which:

- qkv / fc1 kernels: column-sharded over 'model'  -> P(None, 'model')
- proj / fc2 kernels: row-sharded over 'model'    -> P('model', None)
- column-sharded layer biases: P('model'); row-sharded layer biases:
  replicated (added after the all-reduce)
- everything else (LN, embeddings, quant scalars): replicated
- activations / batch: P('data')

Rules are (regex, PartitionSpec) matched against '/'-joined param paths
(the flax paths of the port's params trees, ``models/layers.py:
flatten_tree``); first match wins. :func:`shard_params` takes a rank's
shards, :func:`gather_params` puts the whole arrays back.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import flatten_tree, unflatten_tree
from .peers import Peers


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per array dimension, None
    (not split), an axis name, or a tuple of axis names (split over
    their product, row-major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# (pattern, spec) -- matched with re.search against the '/'-joined path
VIT_PARTITION_RULES: List[Tuple[str, PartitionSpec]] = [
    (r"attn/qkv/kernel$", P(None, "model")),
    (r"attn/qkv/bias$", P("model")),
    (r"attn/proj/kernel$", P("model", None)),
    (r"mlp/fc1/kernel$", P(None, "model")),
    (r"mlp/fc1/bias$", P("model")),
    (r"mlp/fc2/kernel$", P("model", None)),
    (r"", P()),  # default: replicate
]


@dataclasses.dataclass
class ProcessMesh:
    """The world's ranks laid out on named axes (:func:`create_mesh`).

    ``shape``: {axis: size} in axis order, as ``Mesh.shape``; ``rank``:
    this process's global rank; ``coords``: its index on each axis;
    ``groups``: {axis: this rank's gloo subgroup along it} (None where
    the axis has size 1)."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Any]
    device: torch.device
    _peers: Dict[str, Peers] = dataclasses.field(default_factory=dict)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def peers(self, axis: str = "model") -> Peers:
        """The :class:`Peers` of this rank's ``axis`` subgroup (made once;
        a collective call the first time, on the card: every rank asks
        for the same axes in the same order). Its data coordinate is this
        rank's on the 'data' axis, where the mesh has one."""
        if axis not in self._peers:
            d = (self.coords.get("data", 0), self.shape.get("data", 1))
            self._peers[axis] = Peers(
                self.coords[axis], self.shape[axis], self.device,
                group=self.groups[axis], data_index=d[0], dp=d[1])
        return self._peers[axis]

    def world_peers(self) -> Peers:
        """The :class:`Peers` of every rank of the mesh (the default
        group), for the health checks."""
        if "*" not in self._peers:
            import torch.distributed as dist

            self._peers["*"] = Peers(
                self.rank, self.size, self.device,
                group=dist.group.WORLD if self.size > 1 else None)
        return self._peers["*"]

    def close(self) -> None:
        """Close every :class:`Peers` made from this mesh (a collective
        call); the gloo groups stay until the process group goes."""
        for p in self._peers.values():
            p.close()
        self._peers.clear()

    def __repr__(self):
        return (f"ProcessMesh({dict(self.shape)}, rank={self.rank}, "
                f"coords={self.coords})")


def create_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("data", "model"),
                device="cuda") -> ProcessMesh:
    """The mesh of ``shape`` over the ranks of the default gloo group
    (one process and no group: a mesh of size 1). Default: every rank on
    the first axis. Every rank calls it, with the same arguments: the
    axis subgroups are made here (``dist.new_group`` is collective, so
    every rank makes every subgroup, in the same order). ``device``: this
    process's device (the card unless the caller asks for the CPU)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{axis_names}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                         f"{int(np.prod(shape))} processes; the group has "
                         f"{world}")
    grid = np.arange(world).reshape(shape)
    coords = dict(zip(axis_names, (int(c) for c in
                                   np.argwhere(grid == rank)[0])))
    groups = {}
    for ax, name in enumerate(axis_names):
        moved = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in moved:
            line = [int(r) for r in line]
            g = dist.new_group(line) if shape[ax] > 1 else None
            if rank in line:
                groups[name] = g
    return ProcessMesh(shape=collections.OrderedDict(zip(axis_names, shape)),
                       rank=rank, coords=coords, groups=groups, device=dev)


def spec_for_path(path: str, rules=VIT_PARTITION_RULES) -> PartitionSpec:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return P()


def partition_specs(params: Any, rules=VIT_PARTITION_RULES):
    """Tree of PartitionSpec matching ``params``' structure."""
    return unflatten_tree({k: spec_for_path(k, rules)
                           for k in flatten_tree(params)})


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _split(mesh: ProcessMesh, entry) -> Tuple[int, int]:
    """(this rank's index, the number of parts) of a dimension split over
    the axes of ``entry``, row-major."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx, n = idx * mesh.shape[a] + mesh.coords[a], n * mesh.shape[a]
    return idx, n


def shard_leaf(t: torch.Tensor, spec, mesh: ProcessMesh,
               path: str = "") -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec`` (a contiguous copy; the
    leaf itself where nothing is split)."""
    out = t
    for dim, entry in enumerate(spec):
        idx, n = _split(mesh, entry)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"{path}: dim {dim} of {tuple(t.shape)} not "
                             f"divisible by {n} ({entry})")
        s = out.shape[dim] // n
        out = out.narrow(dim, idx * s, s)
    return out if out is t else out.contiguous()


def shard_params(params: Any, mesh: ProcessMesh, rules=VIT_PARTITION_RULES):
    """This rank's shard of each leaf of ``params`` (the whole tree, the
    same on every rank) per its spec: P(None, 'model') gives contiguous
    column blocks, P('model', None) row blocks, P() the whole leaf."""
    return unflatten_tree({k: shard_leaf(v, spec_for_path(k, rules), mesh, k)
                           for k, v in flatten_tree(params).items()})


def gather_leaf(t: torch.Tensor, spec, mesh: ProcessMesh) -> torch.Tensor:
    """The whole array of a leaf whose shards the ranks hold under
    ``spec`` (a collective call over the split axes; gloo, so a CUDA
    shard goes through a CPU copy and the result is on its device)."""
    out = t
    for dim, entry in reversed(list(enumerate(spec))):
        for a in reversed(_axes(entry)):
            if mesh.shape[a] == 1:
                continue
            parts = mesh.peers(a).all_gather(out.detach().cpu())
            out = torch.cat(parts, dim=dim).to(t.device)
    return out


def gather_params(shards: Any, mesh: ProcessMesh, rules=VIT_PARTITION_RULES):
    """Inverse of :func:`shard_params`: every leaf whole, on every rank
    (a collective call)."""
    return unflatten_tree({k: gather_leaf(v, spec_for_path(k, rules), mesh)
                           for k, v in flatten_tree(shards).items()})


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's slice of a batch (:func:`data_sharding`): ``spec`` is
    P(axis, None, ...); called on an array of ``ndim`` dims, it returns
    the rank's rows (a view)."""

    spec: PartitionSpec
    index: int
    parts: int

    def __call__(self, x):
        if x.ndim != len(self.spec):
            raise ValueError(f"batch shard of {len(self.spec)} dims given "
                             f"an array of {x.ndim}")
        b = x.shape[0]
        if b % self.parts:
            raise ValueError(f"batch {b} not divisible by {self.parts}")
        n = b // self.parts
        return x[self.index * n:(self.index + 1) * n]


def data_sharding(mesh: ProcessMesh, ndim: int,
                  axis: str = "data") -> BatchShard:
    """Batch-dim sharding for activations/inputs: this rank's slice."""
    spec = P(axis, *([None] * (ndim - 1)))
    idx, n = _split(mesh, axis)
    return BatchShard(spec=spec, index=idx, parts=n)


def shard_vit_artifact(art, mesh: ProcessMesh):
    """This rank's entries of an in-memory INT4 serving artifact under
    the TP rules the JAX artifact loader applies: qkv/fc1 column-sharded
    (w P(None,'model'), scale/bias vectors P('model')), proj/fc2
    row-sharded (w P('model',None)), everything else replicated."""
    from ..serve.vit_tp import _apply, _qentry_specs, _rep

    specs = {
        "patch_embed": _qentry_specs(art["patch_embed"], "rep"),
        "cls_token": "rep",
        "pos_embed": "rep",
        "norm": _rep(art["norm"]),
        "blocks": [{"norm1": _rep(b["norm1"]), "norm2": _rep(b["norm2"]),
                    "qkv": _qentry_specs(b["qkv"], "col"),
                    "proj": _qentry_specs(b["proj"], "row"),
                    "fc1": _qentry_specs(b["fc1"], "col"),
                    "fc2": _qentry_specs(b["fc2"], "row")}
                   for b in art["blocks"]],
    }
    if "pre_logits" in art:
        specs["pre_logits"] = _rep(art["pre_logits"])
    if "head" in art:
        specs["head"] = _qentry_specs(art["head"], "rep")
    # a column entry's scale is sharded with its columns where it is a
    # vector (the JAX vec_spec); _qentry_specs keeps it whole
    for b, s in zip(art["blocks"], specs["blocks"]):
        for k in ("qkv", "fc1"):
            if getattr(b[k].scale, "ndim", 0) == 1:
                s[k] = dataclasses.replace(s[k], scale="col")
    return _apply(art, specs, mesh.index("model"), mesh.shape["model"])
