"""Serving: INT4 ViT forward and continuous batching."""

from .batching import ContinuousBatcher
from .vit_int4 import (KernelPlan, QLayerArtifact, artifact_from_numpy,
                       kernel_limits, prepare_kernels,
                       random_vit_int4_artifact, vit_int4_forward)

__all__ = ["ContinuousBatcher", "KernelPlan", "QLayerArtifact",
           "artifact_from_numpy", "kernel_limits", "prepare_kernels",
           "random_vit_int4_artifact", "vit_int4_forward"]
