"""Serving: INT4 ViT forward (single device, and FSDP over the processes
of a 'model' axis) and continuous batching."""

from .batching import ContinuousBatcher
from .vit_int4 import (KernelPlan, QLayerArtifact, StackMeta,
                       artifact_from_numpy, export_vit_int4, kernel_limits,
                       prepare_kernels, prepare_latency_artifact,
                       random_vit_int4_artifact, uses_chain,
                       vit_int4_forward, vit_int4_forward_latency)
from .vit_fsdp import (FsdpRdmaPlan, prepare_fsdp_rdma_artifact,
                       prepare_fsdp_rdma_kernels, shard_fsdp_rdma_artifact,
                       vit_int4_forward_fsdp_rdma)

__all__ = ["ContinuousBatcher", "KernelPlan", "QLayerArtifact", "StackMeta",
           "artifact_from_numpy", "export_vit_int4", "kernel_limits", "prepare_kernels",
           "prepare_latency_artifact", "random_vit_int4_artifact",
           "uses_chain", "vit_int4_forward", "vit_int4_forward_latency",
           "FsdpRdmaPlan", "prepare_fsdp_rdma_artifact",
           "prepare_fsdp_rdma_kernels", "shard_fsdp_rdma_artifact",
           "vit_int4_forward_fsdp_rdma"]
