"""Subnet materialization: slice a group-sparse params tree into a dense
compressed network with new static shapes (``quantized_vit_tpu/compress``,
the ViT family and UltraNet)."""

from .subnet import (construct_subnet_ultranet, construct_subnet_vit,
                     kept_groups)

__all__ = ["construct_subnet_ultranet", "construct_subnet_vit",
           "kept_groups"]
