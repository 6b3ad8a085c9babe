"""Sequence Transformer encoder with separate q/k/v projections
(``quantized_vit_tpu/models/transformer.py``), as ``nn.Module``s with
flax's names, paths and layouts: Bert-style multi-head attention, and the
Llama-style options grouped-query attention (``num_kv_heads``), rotary
position embeddings (``rope``), a causal mask and the SwiGLU MLP.

- ``embed/embedding`` [vocab, D] gathered by token, plus ``pos_embed``
  [1, max_len, D] sliced to the sequence;
- pre-norm blocks: LayerNorm (flax's, eps 1e-6) -> attention (``q``,
  ``k``, ``v``, ``proj``: ``QuantDense``) -> residual; LayerNorm -> MLP
  (``fc1`` -> exact GELU -> ``fc2``, or ``silu(gate) * fc1`` -> ``fc2``)
  -> residual;
- final LayerNorm, mean pool over the tokens (a masked mean with a floor
  of one token under ``attn_mask``), ``head``.

Masks fill with -1e30 (not -inf): the key mask first, then the causal
one. Under GQA each kv head serves ``num_heads / num_kv_heads`` query
heads (``bnkgd,bmkd->bkgnm``). A compressed subnet keeps head_dim and
carries ``heads_per_block`` (query heads) and ``hidden_per_block``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .layers import QuantConfig, QuantDense, TreeModule, _normal
from .vit import LayerNorm, dropout, gelu

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    max_len: int = 128
    num_classes: int = 2
    embed_dim: int = 256
    depth: int = 4
    num_heads: int = 4
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    causal: bool = False           # decoder-style masking (Llama-like)
    # grouped-query attention: k/v have num_kv_heads heads, each serving
    # num_heads / num_kv_heads query heads; None: multi-head attention
    num_kv_heads: Optional[int] = None
    rope: bool = False             # rotary position embeddings on q/k
    # "gelu": fc1 -> GELU -> fc2; "swiglu": silu(gate(x)) * fc1(x) -> fc2
    mlp_type: str = "gelu"
    drop_ratio: float = 0.0
    quant: QuantConfig = QuantConfig.off()
    # per-block widths of a compressed subnet (query heads, hidden units)
    heads_per_block: Optional[Tuple[int, ...]] = None
    hidden_per_block: Optional[Tuple[int, ...]] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def q_per_kv(self) -> int:
        if self.num_heads % self.kv_heads:
            raise ValueError("num_heads must divide by num_kv_heads")
        return self.num_heads // self.kv_heads

    def block_heads(self, i: int) -> int:
        return (self.heads_per_block[i] if self.heads_per_block is not None
                else self.num_heads)

    def block_hidden(self, i: int) -> int:
        return (self.hidden_per_block[i] if self.hidden_per_block is not None
                else int(self.embed_dim * self.mlp_ratio))


def rope_rotate(x, positions, base: float = 10000.0):
    """Rotary position embedding (rotate-half) on [..., N, H, hd]: the
    angles in f32, the result cast back to the input's dtype."""
    half = x.shape[-1] // 2
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32),
                      -torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class SeparateQKVAttention(nn.Module):
    """Multi-head attention with three projections; head pruning removes
    whole heads (whole kv groups under GQA) and keeps head_dim."""

    def __init__(self, cfg: TransformerConfig, num_heads: int, gen, device):
        super().__init__()
        self.cfg = cfg
        self.heads = num_heads
        self.head_dim = cfg.embed_dim // cfg.num_heads
        self.kv_heads = num_heads // cfg.q_per_kv
        q, d, hd = cfg.quant, cfg.embed_dim, self.head_dim
        for name, nh in (("q", num_heads), ("k", self.kv_heads),
                         ("v", self.kv_heads)):
            self.add_module(name, QuantDense(d, nh * hd, q,
                                             use_bias=cfg.qkv_bias, gen=gen,
                                             device=device))
        self.proj = QuantDense(num_heads * hd, d, q, gen=gen, device=device)

    def forward(self, x, mask, deterministic: bool, generator=None):
        c = self.cfg
        b, n, _ = x.shape
        hd, kv, g = self.head_dim, self.kv_heads, c.q_per_kv
        q = self.q(x).reshape(b, n, self.heads, hd)
        k = self.k(x).reshape(b, n, kv, hd)
        v = self.v(x).reshape(b, n, kv, hd)
        if c.rope:
            pos = torch.arange(n, device=x.device)
            q, k = rope_rotate(q, pos), rope_rotate(k, pos)
        q = q.reshape(b, n, kv, g, hd)
        attn = torch.einsum("bnkgd,bmkd->bkgnm", q, k) * hd**-0.5
        if mask is not None:
            attn = torch.where(mask[:, :, None], attn, _NEG)
        if c.causal:
            causal = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                           device=x.device))
            attn = torch.where(causal, attn, _NEG)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bkgnm,bmkd->bnkgd", attn, v)
        out = self.proj(out.reshape(b, n, self.heads * hd))
        return dropout(out, c.drop_ratio, deterministic, generator)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, num_heads: int, hidden: int,
                 gen, device):
        super().__init__()
        self.cfg = cfg
        q, d = cfg.quant, cfg.embed_dim
        self.norm1 = LayerNorm(d, device=device)
        self.attn = SeparateQKVAttention(cfg, num_heads, gen, device)
        self.norm2 = LayerNorm(d, device=device)
        if cfg.mlp_type == "swiglu":
            self.gate = QuantDense(d, hidden, q, use_bias=False, gen=gen,
                                   device=device)
            self.fc1 = QuantDense(d, hidden, q, use_bias=False, gen=gen,
                                  device=device)
        else:
            self.fc1 = QuantDense(d, hidden, q, gen=gen, device=device)
        self.fc2 = QuantDense(hidden, d, q, gen=gen, device=device)

    def forward(self, x, mask, deterministic: bool, generator=None):
        x = x + self.attn(self.norm1(x), mask, deterministic, generator)
        y = self.norm2(x)
        if self.cfg.mlp_type == "swiglu":
            gate = self.gate(y)
            y = gate * torch.sigmoid(gate) * self.fc1(y)
        else:
            y = gelu(self.fc1(y))
        y = dropout(self.fc2(y), self.cfg.drop_ratio, deterministic,
                    generator)
        return x + y


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` [vocab, features] (variance-scaling
    normal init, std 1/sqrt(features)) gathered by index."""

    def __init__(self, num_embeddings: int, features: int, gen, device):
        super().__init__()
        self.embedding = nn.Parameter(_normal(
            (num_embeddings, features), math.sqrt(1.0 / features), gen,
            device))

    def forward(self, ids):
        return self.embedding[ids]


class TransformerEncoder(TreeModule):
    """The encoder of ``cfg``; weights drawn from ``seed`` with flax's
    initializers, on ``device`` (the GPU unless the caller asks for the
    CPU). ``forward(tokens, attn_mask=None, deterministic=True,
    generator=None)``: int tokens [B, N], an optional 0/1 mask [B, N]."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        d = cfg.embed_dim
        self.embed = Embed(cfg.vocab_size, d, gen, dev)
        self.pos_embed = nn.Parameter(_normal((1, cfg.max_len, d), 0.02, gen,
                                              dev))
        for i in range(cfg.depth):
            self.add_module(f"blocks_{i}", TransformerBlock(
                cfg, cfg.block_heads(i), cfg.block_hidden(i), gen, dev))
        self.norm = LayerNorm(d, device=dev)
        if cfg.num_classes > 0:
            self.head = QuantDense(d, cfg.num_classes, cfg.quant, gen=gen,
                                   device=dev)

    def forward(self, tokens, attn_mask=None, deterministic: bool = True,
                generator=None):
        c = self.cfg
        n = tokens.shape[1]
        x = self.embed(tokens) + self.pos_embed[:, :n]
        x = dropout(x, c.drop_ratio, deterministic, generator)
        mask = None
        if attn_mask is not None:
            mask = attn_mask[:, None, None, :].to(torch.bool)  # keys
        for i in range(c.depth):
            x = getattr(self, f"blocks_{i}")(x, mask, deterministic,
                                             generator)
        x = self.norm(x)
        if attn_mask is not None:
            w = attn_mask.to(x.dtype)[..., None]
            pooled = torch.sum(x * w, dim=1) / torch.clamp_min(
                torch.sum(w, dim=1), 1.0)
        else:
            pooled = torch.mean(x, dim=1)
        if c.num_classes > 0:
            pooled = self.head(pooled)
        return pooled


def transformer_encoder_tiny(num_classes=2, quant=QuantConfig.off(),
                             device="cuda"):
    return TransformerEncoder(TransformerConfig(
        vocab_size=1000, max_len=64, embed_dim=64, depth=2, num_heads=2,
        num_classes=num_classes, quant=quant), device=device)


def transformer_encoder_base(num_classes=2, quant=QuantConfig.off(),
                             device="cuda"):
    """BERT-base geometry (Devlin et al. 2019): 12 layers, width 768, 12
    heads, vocabulary 30522, 512 positions."""
    return TransformerEncoder(TransformerConfig(
        vocab_size=30522, max_len=512, embed_dim=768, depth=12, num_heads=12,
        num_classes=num_classes, quant=quant), device=device)


def params_from_jax(tree, cfg: TransformerConfig,
                    device="cuda") -> TransformerEncoder:
    """An encoder of ``cfg`` holding copies of the JAX package's params
    tree (numpy leaves, flax paths and layouts), on ``device``."""
    model = TransformerEncoder(cfg, device=device)
    model.load_param_tree(tree)
    return model
