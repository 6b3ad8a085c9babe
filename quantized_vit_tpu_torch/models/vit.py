"""ViT configuration (the fields of ``quantized_vit_tpu/models/vit.py``'s
``ViTConfig``); the serving port needs no model module."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


def _quant_off() -> Dict[str, Any]:
    """``QuantConfig.off()`` as the plain dict the artifact manifest holds:
    every field present so a JAX reader can rebuild its ``QuantConfig``."""
    return {"enabled": False, "nonlinear": True, "use_dge": False,
            "quantize_acts": True, "weight_clip": [-2.0, 2.0],
            "act_clip": [-2.0, 2.0], "init_bits": 32.0, "dge_bits": 4.0,
            "matmul_dtype": None, "fused_vjp": False}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    num_classes: int = 1000
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    representation_size: Optional[int] = None
    drop_ratio: float = 0.0
    attn_drop_ratio: float = 0.0
    drop_path_ratio: float = 0.0
    # the training quantizer config, kept as a plain dict so manifests
    # round-trip; serving reads nothing from it
    quant: Dict[str, Any] = dataclasses.field(default_factory=_quant_off,
                                              hash=False, compare=False)
    heads_per_block: Optional[Tuple[int, ...]] = None
    hidden_per_block: Optional[Tuple[int, ...]] = None

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1  # + cls token
