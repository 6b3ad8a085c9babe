"""Serving: INT4 ViT forward and continuous batching."""

from .batching import ContinuousBatcher
from .vit_int4 import (KernelPlan, QLayerArtifact, StackMeta,
                       artifact_from_numpy, kernel_limits,
                       prepare_kernels, prepare_latency_artifact,
                       random_vit_int4_artifact, uses_chain,
                       vit_int4_forward, vit_int4_forward_latency)

__all__ = ["ContinuousBatcher", "KernelPlan", "QLayerArtifact", "StackMeta",
           "artifact_from_numpy", "kernel_limits", "prepare_kernels",
           "prepare_latency_artifact", "random_vit_int4_artifact",
           "uses_chain", "vit_int4_forward", "vit_int4_forward_latency"]
