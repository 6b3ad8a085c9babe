"""Subnet materialization: slice a group-sparse params tree into a dense
compressed network with new static shapes (``quantized_vit_tpu/compress``):
the model families' constructors and ``construct_subnet_auto`` for
automatically discovered groups."""

from .auto import construct_subnet_auto
from .subnet import (construct_subnet_autoencoder, construct_subnet_mobilenet,
                     construct_subnet_resnet, construct_subnet_transformer,
                     construct_subnet_ultranet, construct_subnet_vit,
                     kept_groups)

__all__ = ["construct_subnet_auto", "construct_subnet_autoencoder",
           "construct_subnet_mobilenet", "construct_subnet_resnet",
           "construct_subnet_transformer", "construct_subnet_ultranet",
           "construct_subnet_vit", "kept_groups"]
