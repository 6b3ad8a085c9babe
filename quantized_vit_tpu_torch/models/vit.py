"""Vision Transformer, quantization-aware (``quantized_vit_tpu/models/
vit.py``), as ``nn.Module``s with flax's names, paths and layouts.

The parameter tree is the flax one: ``patch_embed/proj/kernel`` (HWIO),
``cls_token``, ``pos_embed``, ``blocks_{i}/norm1/{scale,bias}``,
``blocks_{i}/attn/qkv/kernel`` ([in, out]) with its ``d_quant_wt`` ...
``t_quant_act`` of shape (1,), ``blocks_{i}/mlp/fc1``, ``norm``, ``head``.
GETA's group transforms name these paths and axes, so the layout is kept
rather than torch's [out, in].

- PatchEmbed: a ``QuantConv`` patch conv (the exact space-to-depth GEMM);
- ViTAttention with the fused qkv projection, scaled dot-product, f32
  softmax, proj;
- pre-norm Blocks with DropPath; cls token + learned position embeddings;
  LayerNorm is flax's (eps 1e-6, var = E[x^2] - E[x]^2 clipped at 0); GELU
  the exact erfc form of ``jax.nn.gelu(approximate=False)``.

Inputs are NHWC. The model is run either as a module (its own parameters)
or functionally on a params tree with :func:`apply`, as flax's
``model.apply({"params": tree}, x)``; training runs it functionally.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .layers import (QuantConfig, QuantConv, QuantDense, _mm_cast,
                     _trunc_normal, flatten_tree, unflatten_tree)


def _quant_off() -> Dict[str, Any]:
    """``QuantConfig.off()`` as the plain dict the artifact manifest holds:
    every field present so a JAX reader can rebuild its ``QuantConfig``."""
    return QuantConfig.off().asdict()


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
    # the training quantizer config as a plain dict (QuantConfig.asdict) so
    # manifests round-trip; a QuantConfig given here is stored as its dict
    quant: Dict[str, Any] = dataclasses.field(default_factory=_quant_off,
                                              hash=False, compare=False)
    # per-block widths of a compressed subnet
    heads_per_block: Optional[Tuple[int, ...]] = None
    hidden_per_block: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if isinstance(self.quant, QuantConfig):
            object.__setattr__(self, "quant", self.quant.asdict())

    @property
    def quant_config(self) -> QuantConfig:
        return QuantConfig.from_dict(self.quant)

    def block_heads(self, i: int) -> int:
        return (self.heads_per_block[i] if self.heads_per_block is not None
                else self.num_heads)

    def block_hidden(self, i: int) -> int:
        return (self.hidden_per_block[i] if self.hidden_per_block is not None
                else int(self.embed_dim * self.mlp_ratio))

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1  # + cls token


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def dropout(x, rate: float, deterministic: bool, generator=None):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale by
    1/keep; the identity at rate 0 or when deterministic."""
    if rate == 0.0 or deterministic:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def drop_path(x, rate: float, deterministic: bool, generator=None):
    """Stochastic depth: drop a sample's whole residual branch."""
    if rate == 0.0 or deterministic:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def gelu(x):
    """``jax.nn.gelu(approximate=False)``: 0.5 x erfc(-x / sqrt(2))."""
    return 0.5 * x * torch.erfc(-x * math.sqrt(0.5))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6)``: f32 statistics with the fast
    variance E[x^2] - E[x]^2 clipped at 0, then
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, dim: int, eps: float = 1e-6, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x = x.to(torch.float32)
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


def _mixed_einsum(eq, a, b, q: QuantConfig):
    """``einsum``; with ``matmul_dtype`` the operands are rounded to it and
    the products accumulate in f32, as JAX's preferred_element_type=f32."""
    a, b, mixed = _mm_cast(q, a, b)
    if mixed:
        a, b = a.float(), b.float()
    return torch.einsum(eq, a, b)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, q: QuantConfig, gen, device):
        super().__init__()
        p = cfg.patch_size
        self.proj = QuantConv(cfg.in_channels, cfg.embed_dim, (p, p),
                              strides=(p, p), padding="VALID", config=q,
                              gen=gen, device=device)

    def forward(self, x):
        x = self.proj(x)
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, q: QuantConfig, num_heads: int, gen,
                 device):
        super().__init__()
        self.cfg, self.q = cfg, q
        self.heads = num_heads
        # head_dim is set by the ORIGINAL head count: head pruning removes
        # whole heads and keeps head_dim
        self.head_dim = cfg.embed_dim // cfg.num_heads
        self.scale = (cfg.qk_scale if cfg.qk_scale is not None
                      else self.head_dim**-0.5)
        inner = num_heads * self.head_dim
        self.qkv = QuantDense(cfg.embed_dim, inner * 3, q,
                              use_bias=cfg.qkv_bias, gen=gen, device=device)
        self.proj = QuantDense(inner, cfg.embed_dim, q, gen=gen,
                               device=device)

    def forward(self, x, deterministic: bool, generator=None):
        b, n, _ = x.shape
        h, hd = self.heads, self.head_dim
        qkv = self.qkv(x).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = _mixed_einsum("bhnd,bhmd->bhnm", q, k, self.q) * self.scale
        attn = torch.softmax(attn, dim=-1)
        attn = dropout(attn, self.cfg.attn_drop_ratio, deterministic,
                       generator)
        out = _mixed_einsum("bhnm,bhmd->bhnd", attn, v, self.q)
        out = out.permute(0, 2, 1, 3).reshape(b, n, h * hd)
        out = self.proj(out)
        return dropout(out, self.cfg.drop_ratio, deterministic, generator)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, q: QuantConfig, hidden: int, gen,
                 device):
        super().__init__()
        self.cfg = cfg
        self.fc1 = QuantDense(cfg.embed_dim, hidden, q, gen=gen,
                              device=device)
        self.fc2 = QuantDense(hidden, cfg.embed_dim, q, gen=gen,
                              device=device)

    def forward(self, x, deterministic: bool, generator=None):
        x = gelu(self.fc1(x))
        x = dropout(x, self.cfg.drop_ratio, deterministic, generator)
        x = self.fc2(x)
        return dropout(x, self.cfg.drop_ratio, deterministic, generator)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, q: QuantConfig, index: int,
                 drop_path_rate: float, gen, device):
        super().__init__()
        self.rate = drop_path_rate
        self.norm1 = LayerNorm(cfg.embed_dim, device=device)
        self.attn = ViTAttention(cfg, q, cfg.block_heads(index), gen, device)
        self.norm2 = LayerNorm(cfg.embed_dim, device=device)
        self.mlp = Mlp(cfg, q, cfg.block_hidden(index), gen, device)

    def forward(self, x, deterministic: bool, generator=None):
        h = self.attn(self.norm1(x), deterministic, generator)
        x = x + drop_path(h, self.rate, deterministic, generator)
        h = self.mlp(self.norm2(x), deterministic, generator)
        return x + drop_path(h, self.rate, deterministic, generator)


class VisionTransformer(nn.Module):
    """The ViT of ``cfg`` (``cfg.quant`` selects the quantizers). Weights
    are drawn from ``seed`` with flax's initializers (not JAX's numbers),
    on ``device`` (the GPU unless the caller asks for the CPU)."""

    def __init__(self, cfg: ViTConfig, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        q = cfg.quant_config
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg, q, gen, dev)
        self.cls_token = nn.Parameter(_trunc_normal((1, 1, d), 0.02, gen,
                                                    dev))
        self.pos_embed = nn.Parameter(_trunc_normal(
            (1, cfg.num_tokens, d), 0.02, gen, dev))
        # stochastic depth decay rule: rates linearly spaced 0..ratio
        dpr = [float(r) for r in np.linspace(0.0, cfg.drop_path_ratio,
                                             cfg.depth)]
        for i in range(cfg.depth):
            self.add_module(f"blocks_{i}", Block(cfg, q, i, dpr[i], gen, dev))
        self.norm = LayerNorm(d, device=dev)
        width = d
        if cfg.representation_size is not None:
            # flax nn.Dense: lecun_normal kernel
            self.pre_logits = QuantDense(
                d, cfg.representation_size, QuantConfig.off(),
                kernel_std=math.sqrt(1.0 / d) / 0.87962566103423978,
                gen=gen, device=dev)
            width = cfg.representation_size
        if cfg.num_classes > 0:
            self.head = QuantDense(width, cfg.num_classes, q, gen=gen,
                                   device=dev)

    def forward(self, x, deterministic: bool = True, generator=None):
        c = self.cfg
        b = x.shape[0]
        x = self.patch_embed(x)  # [B, N, D]
        cls = self.cls_token.expand(b, 1, c.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        x = dropout(x, c.drop_ratio, deterministic, generator)
        for i in range(c.depth):
            x = getattr(self, f"blocks_{i}")(x, deterministic, generator)
        x = self.norm(x)[:, 0]  # cls token
        if c.representation_size is not None:
            x = torch.tanh(self.pre_logits(x))
        if c.num_classes > 0:
            x = self.head(x)
        return x

    # -- the path-keyed view of the parameters --------------------------------

    def params_by_path(self) -> Dict[str, nn.Parameter]:
        """{'blocks_3/attn/qkv/kernel': Parameter, ...}: flax's paths."""
        return {k.replace(".", "/"): v for k, v in self.named_parameters()}

    def param_tree(self):
        """The parameters as flax's nested params dict (the Parameters
        themselves, not copies)."""
        return unflatten_tree(self.params_by_path())

    @torch.no_grad()
    def load_param_tree(self, tree) -> None:
        """Copy a params tree (tensors or numpy arrays, flax paths and
        layouts) into the parameters; paths and shapes must match."""
        mine = self.params_by_path()
        flat = flatten_tree(tree)
        if set(flat) != set(mine):
            missing = sorted(set(mine) - set(flat))
            extra = sorted(set(flat) - set(mine))
            raise ValueError(f"params tree differs from the model: missing "
                             f"{missing[:5]}, unexpected {extra[:5]}")
        for path, p in mine.items():
            v = flat[path]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch at {path}: "
                                 f"{tuple(v.shape)} vs {tuple(p.shape)}")
            p.copy_(v.to(p.dtype))


def apply(model: nn.Module, params, x, deterministic: bool = True,
          generator=None):
    """flax's ``model.apply({"params": params}, x)``: the forward of
    ``model`` with its parameters taken from the params tree ``params``
    (gradients flow to the tree's tensors)."""
    flat = {k.replace("/", "."): v for k, v in flatten_tree(params).items()}
    flat.update(model.named_buffers())
    return torch.func.functional_call(
        model, flat, (x,), {"deterministic": deterministic,
                            "generator": generator}, strict=True)


def params_from_jax(tree, cfg: ViTConfig, device="cuda"
                    ) -> VisionTransformer:
    """A model holding the JAX package's params tree (numpy leaves, flax
    paths and layouts), on ``device``."""
    model = VisionTransformer(cfg, device=device)
    model.load_param_tree(tree)
    return model


def params_to_numpy(model_or_tree):
    """The params tree of a model (or a tree of tensors) as numpy arrays,
    flax paths and layouts: what the JAX package's ``model.apply`` takes."""
    tree = (model_or_tree.param_tree() if isinstance(model_or_tree,
                                                     nn.Module)
            else model_or_tree)
    return unflatten_tree({k: v.detach().cpu().numpy() if isinstance(
        v, torch.Tensor) else np.asarray(v)
        for k, v in flatten_tree(tree).items()})


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------


def _make(img, patch, dim, depth, heads, rep, num_classes, quant, device):
    return VisionTransformer(ViTConfig(
        img_size=img, patch_size=patch, embed_dim=dim, depth=depth,
        num_heads=heads, representation_size=rep, num_classes=num_classes,
        quant=quant), device=device)


def vit_base_patch16_224(num_classes=1000, quant=QuantConfig.off(),
                         device="cuda"):
    return _make(224, 16, 768, 12, 12, None, num_classes, quant, device)


def vit_base_patch16_224_in21k(num_classes=21843, has_logits=True,
                               quant=QuantConfig.off(), device="cuda"):
    return _make(224, 16, 768, 12, 12, 768 if has_logits else None,
                 num_classes, quant, device)


def vit_base_patch32_224(num_classes=1000, quant=QuantConfig.off(),
                         device="cuda"):
    return _make(224, 32, 768, 12, 12, None, num_classes, quant, device)


def vit_base_patch32_224_in21k(num_classes=21843, has_logits=True,
                               quant=QuantConfig.off(), device="cuda"):
    return _make(224, 32, 768, 12, 12, 768 if has_logits else None,
                 num_classes, quant, device)


def vit_large_patch16_224(num_classes=1000, quant=QuantConfig.off(),
                          device="cuda"):
    return _make(224, 16, 1024, 24, 16, None, num_classes, quant, device)


def vit_large_patch16_224_in21k(num_classes=21843, has_logits=True,
                                quant=QuantConfig.off(), device="cuda"):
    return _make(224, 16, 1024, 24, 16, 1024 if has_logits else None,
                 num_classes, quant, device)


def vit_large_patch32_224_in21k(num_classes=21843, has_logits=True,
                                quant=QuantConfig.off(), device="cuda"):
    return _make(224, 32, 1024, 24, 16, 1024 if has_logits else None,
                 num_classes, quant, device)


def vit_huge_patch14_224_in21k(num_classes=21843, has_logits=True,
                               quant=QuantConfig.off(), device="cuda"):
    return _make(224, 14, 1280, 32, 16, 1280 if has_logits else None,
                 num_classes, quant, device)
