"""Sharded checkpoints on ``torch.distributed.checkpoint`` (port of
``quantized_vit_tpu/parallel/sharded_ckpt.py``, which writes orbax).

Arrays are keyed by their logical '/'-joined path; each rank writes the
shards it owns, and a restore places every leaf per the partition rules
onto a mesh that may differ from the writer's (shapes and dtypes from the
checkpoint's own metadata, placements from the rules). The arrays are
staged as CPU DTensors over a gloo device mesh of the
:class:`~.partition.ProcessMesh`'s shape (``init_device_mesh("cpu",
...)``): NCCL cannot put two ranks on one card, and the processes of a
mesh may share one. Layout on disk:

    <path>/arrays/      torch.distributed.checkpoint files
    <path>/meta.pkl     pickled {"extra": ...} manifest (rank 0 only)

With ``mesh=None`` the tree is written and restored whole (every leaf
replicated).
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.layers import flatten_tree, unflatten_tree
from .partition import (VIT_PARTITION_RULES, ProcessMesh, _axes, _split,
                        spec_for_path)

_ARRAYS = "arrays"
_META = "meta.pkl"


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_initialized()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _device_mesh(mesh: ProcessMesh):
    """The gloo CPU device mesh of ``mesh``'s shape (made once: its
    subgroups are collective)."""
    dm = getattr(mesh, "_device_mesh", None)
    if dm is None:
        from torch.distributed.device_mesh import init_device_mesh

        dm = init_device_mesh("cpu", tuple(mesh.shape.values()),
                              mesh_dim_names=mesh.axis_names)
        mesh._device_mesh = dm
    return dm


def _placements(spec, mesh: ProcessMesh):
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            out[mesh.axis_names.index(a)] = Shard(dim)
    return out


def _global_shape(local, spec, mesh: ProcessMesh):
    shape = list(local)
    for dim, entry in enumerate(spec):
        shape[dim] *= _split(mesh, entry)[1]
    return torch.Size(shape)


def _local_shape(shape, spec, mesh: ProcessMesh):
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = _split(mesh, entry)[1]
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} not divisible "
                             f"by {n} ({entry})")
        out[dim] //= n
    return out


def _dtensor(local: torch.Tensor, spec, mesh: ProcessMesh):
    from torch.distributed.tensor import DTensor

    shape = _global_shape(local.shape, spec, mesh)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, _device_mesh(mesh),
                              _placements(spec, mesh), run_check=False,
                              shape=shape, stride=stride)


def save_sharded_checkpoint(path: str, params: Any,
                            extra: Optional[Dict] = None,
                            mesh: Optional[ProcessMesh] = None,
                            rules=VIT_PARTITION_RULES) -> str:
    """Write ``params`` under ``path``: with a ``mesh``, this rank's shards
    (as :func:`~.partition.shard_params` lays them out under ``rules``);
    without, the whole tree. Every rank of the mesh calls it;
    ``extra`` is written by rank 0 only."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().cpu() for k, v in flatten_tree(params).items()}
    if mesh is not None and mesh.size > 1:
        flat = {k: _dtensor(v, spec_for_path(k, rules), mesh)
                for k, v in flat.items()}
    dcp.save(flat, checkpoint_id=os.path.join(path, _ARRAYS),
             no_dist=not _distributed())
    if _rank() == 0:
        with open(os.path.join(path, _META), "wb") as f:
            pickle.dump({"extra": extra or {}}, f)
    return path


def restore_sharded_checkpoint(path: str, mesh: Optional[ProcessMesh] = None,
                               rules=VIT_PARTITION_RULES,
                               device="cuda") -> Tuple[Any, Dict]:
    """Restore ``(params, extra)``. With a ``mesh``, each leaf lands as
    this rank's shard per ``rules`` (matched against its path), on the
    mesh's device; the mesh need not match the writer's. Without, the
    whole tree on ``device`` (the card unless the caller asks for the
    CPU)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = os.path.abspath(path)
    arrays = os.path.join(path, _ARRAYS)
    meta = dcp.FileSystemReader(arrays).read_metadata()
    sharded = mesh is not None and mesh.size > 1
    dev = mesh.device if mesh is not None else resolve_device(device)
    sd = {}
    for key, md in meta.state_dict_metadata.items():
        if not isinstance(md, TensorStorageMetadata):
            continue
        dtype = md.properties.dtype
        if sharded:
            spec = spec_for_path(key, rules)
            sd[key] = _dtensor(torch.empty(_local_shape(md.size, spec, mesh),
                                           dtype=dtype), spec, mesh)
        else:
            sd[key] = torch.empty(md.size, dtype=dtype)
    dcp.load(sd, checkpoint_id=arrays, no_dist=not _distributed())
    params = unflatten_tree({
        k: (v.to_local() if sharded else v).to(dev) for k, v in sd.items()})
    extra: Dict = {}
    meta_file = os.path.join(path, _META)
    if os.path.exists(meta_file):
        with open(meta_file, "rb") as f:
            extra = pickle.load(f).get("extra", {})
    return params, extra


def scan_sharded_checkpoint(ckpt_dir: str,
                            name: str = "ckpt") -> Optional[str]:
    """Latest sharded checkpoint directory by trailing step number."""
    best, best_step = None, -1
    for p in glob.glob(os.path.join(ckpt_dir, f"{name}_*")):
        if not os.path.isdir(p):
            continue
        m = re.search(r"_(\d+)$", p)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = p
    return best
