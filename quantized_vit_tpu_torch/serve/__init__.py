"""Serving: INT4 ViT forward (single device; over the processes of a
'model' axis: tensor parallel, and FSDP with column shards or in-kernel
gathers), continuous batching, and the multi-host front over RPC serving
processes."""

from .batching import ContinuousBatcher, MultiHostFrontend
from .vit_int4 import (KernelPlan, QLayerArtifact, StackMeta,
                       artifact_from_numpy, export_vit_int4, kernel_limits,
                       prepare_kernels, prepare_latency_artifact,
                       random_vit_int4_artifact, uses_chain,
                       vit_int4_forward, vit_int4_forward_latency)
from .vit_fsdp import (FsdpPlan, FsdpRdmaPlan, fsdp_artifact_specs,
                       prepare_fsdp_artifact, prepare_fsdp_kernels,
                       prepare_fsdp_rdma_artifact, prepare_fsdp_rdma_kernels,
                       shard_fsdp_artifact, shard_fsdp_rdma_artifact,
                       vit_int4_forward_fsdp, vit_int4_forward_fsdp_rdma)
from .vit_tp import (TpPlan, permute_qkv_entry, prepare_tp_artifact, prepare_tp_kernels,
                     shard_tp_artifact, tp_artifact_specs,
                     vit_int4_forward_tp)

__all__ = ["ContinuousBatcher", "MultiHostFrontend", "RpcBackendStub",
           "RpcServingBackend", "KernelPlan", "QLayerArtifact", "StackMeta",
           "artifact_from_numpy", "export_vit_int4", "kernel_limits", "prepare_kernels",
           "prepare_latency_artifact", "random_vit_int4_artifact",
           "uses_chain", "vit_int4_forward", "vit_int4_forward_latency",
           "FsdpRdmaPlan", "prepare_fsdp_rdma_artifact",
           "prepare_fsdp_rdma_kernels", "shard_fsdp_rdma_artifact",
           "vit_int4_forward_fsdp_rdma", "FsdpPlan", "fsdp_artifact_specs",
           "prepare_fsdp_artifact", "prepare_fsdp_kernels",
           "shard_fsdp_artifact", "vit_int4_forward_fsdp", "TpPlan",
           "permute_qkv_entry",
           "prepare_tp_artifact", "prepare_tp_kernels", "shard_tp_artifact",
           "tp_artifact_specs", "vit_int4_forward_tp"]


def __getattr__(name):
    # the RPC classes load on first use, so ``python -m
    # quantized_vit_tpu_torch.serve.rpc`` does not find its own module
    # imported already by this package
    if name in ("RpcBackendStub", "RpcServingBackend"):
        from . import rpc

        return getattr(rpc, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
