"""ViT W4A4 integer serving forward (port of
``quantized_vit_tpu/serve/vit_int4.py``).

One forward runs four kernels: :func:`~..ops.fused.fused_quant_matmul` (K1)
for the patch embed and the head, :func:`~..ops.patch.patch_finalize` (K4)
once, and per block :func:`~..ops.attention.attention_block` (K3, whose
proj GEMM is K1) then :func:`~..ops.fused.fused_mlp` (K2). Every batch
size takes that route: the JAX package's TPU gates (batch >= 4, the VMEM
fit predicates, the MLP alignment test, the ViT-H chain tiles) do not
carry over, and its batch 1-3 routes are not ported yet.

Each weight operand carries its own format (packed int4 or int8), so
GETA mixed-precision exports stay on the kernels. The kernels run from a
:class:`KernelPlan` (:func:`prepare_kernels`: each layer's weight in the
kernels' layout and its constants folded, once per artifact).
``use_kernels=False`` runs the plain PyTorch versions instead (the
reference the kernels are held to); CPU tensors take the plain versions
in either case.

Token layout: patches first, cls at row ``n_real - 1``, padded to a
multiple of ``n_align`` (197 -> 208); padded keys are masked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.vit import ViTConfig
from ..ops.attention import (AttentionPlan, attention_block_plain,
                             heads_kernel_limit, plan_attention_block,
                             run_attention_block)
from ..ops.fused import (MatmulPlan, MlpPlan, fused_mlp_plain,
                         fused_quant_matmul_plain, mlp_kernel_limit,
                         plan_matmul, plan_mlp, run_matmul, run_mlp)
from ..ops.patch import patch_finalize, patch_finalize_plain
from ..quant.packing import pack_int4


@dataclasses.dataclass
class QLayerArtifact:
    """One quantized layer's serving artifact: weight levels (packed int4
    [K/2, N] or int8 [K, N]), the fused dequant scale ``d_w * d_a``, the
    float bias, the activation quantizer constants ``act`` (d, q_m, t),
    and the static ``fmt``, ``act_pow`` (t != 1) and ``top`` (clip level)."""

    w: torch.Tensor
    scale: torch.Tensor
    bias: Any
    act: Dict[str, torch.Tensor]
    fmt: str
    act_pow: bool = True
    top: int = 127


def _qmatmul(x2d, entry: QLayerArtifact, float_dtype, **kw):
    """Quantized matmul with fused prologue/epilogue (K1's plain version)."""
    kw.setdefault("prologue", "quant")
    if kw["prologue"] is not None:
        kw.setdefault("act_d", entry.act["d"])
        kw.setdefault("act_t", entry.act["t"])
        kw.setdefault("act_top", entry.top)
        kw.setdefault("act_pow", entry.act_pow)
    return fused_quant_matmul_plain(
        x2d, entry.w, kw.pop("scale", entry.scale), kw.pop("bias", entry.bias),
        fmt=entry.fmt, out_dtype=float_dtype, **kw)


def _layernorm(x, p, eps=1e-6):
    """Two-pass LayerNorm of the final norm (vit_int4.py:175-181): a
    different function from the kernels' fast-variance form."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(dt)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _patches_2d(images, cfg: ViTConfig, images_layout: str):
    """images -> [B*P, p*p*C] patch rows (``nhwc`` patchified on the
    device, in the host patchify's order)."""
    b = images.shape[0]
    p = cfg.patch_size
    g = cfg.img_size // p
    kdim = p * p * cfg.in_channels
    if images_layout == "patches":
        return images.reshape(b * g * g, kdim)
    if images_layout == "nhwc":
        xp = images.reshape(b, g, p, g, p * cfg.in_channels)
        return xp.permute(0, 1, 3, 2, 4).reshape(b * g * g, kdim)
    raise ValueError(f"unknown images_layout {images_layout!r}")


def _pos_rows(art, cfg: ViTConfig):
    """(patch positional rows [P, D], cls row [D]) in f32."""
    pos = art["pos_embed"].to(torch.float32).reshape(cfg.num_tokens, -1)
    cls_row = art["cls_token"].to(torch.float32).reshape(-1) + pos[0]
    return pos[1:], cls_row


def _embed_tokens(art, images, cfg: ViTConfig, float_dtype,
                  images_layout: str, n_pad: int):
    """Patch embed + pos embed + cls + pad: images -> [B*n_pad, D] rows
    (plain versions).

    ``patches``: K1 applies the dequant scale and bias. ``nhwc``: K1
    returns the exact integer accumulators (scale 1, no bias) and K4
    applies the scale and bias, as the JAX conv path does."""
    b = images.shape[0]
    pe = art["patch_embed"]
    xp = _patches_2d(images, cfg, images_layout)
    pos_patch, cls_row = _pos_rows(art, cfg)
    if images_layout == "patches":
        acc = _qmatmul(xp, pe, torch.float32, epilogue=None)
        pe_scale = torch.ones((), dtype=torch.float32, device=images.device)
    else:
        acc = _qmatmul(xp, pe, torch.float32, epilogue=None,
                       scale=torch.ones((), dtype=torch.float32,
                                        device=images.device), bias=None)
        pe_scale = pe.scale
        if pe.bias is not None:
            pos_patch = pos_patch + pe.bias
    return patch_finalize_plain(acc.reshape(b, cfg.num_patches, -1),
                                pos_patch, cls_row, pe_scale, n_pad=n_pad,
                                out_dtype=float_dtype)


def _vit_block(x2d, blk, *, b: int, n_pad: int, n_real: int, dim: int,
               hd: int, sm_scale: float, float_dtype, int_attention: bool):
    """One transformer block (plain versions): the attention residual
    branch (K3) then the MLP residual branch (K2)."""
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    fc1_e, fc2_e = blk["fc1"], blk["fc2"]
    x2d = attention_block_plain(
        x2d.reshape(b, n_pad, dim),
        qkv_e.w, qkv_e.scale, qkv_e.bias,
        proj_e.w, proj_e.scale, proj_e.bias,
        fmt_proj=proj_e.fmt, n_valid=n_real, out_dtype=float_dtype,
        int_attention=int_attention, **_attention_layer(blk, hd, sm_scale),
    ).reshape(b * n_pad, dim)
    return fused_mlp_plain(
        x2d, fc1_e.w, fc1_e.scale, fc1_e.bias,
        fc2_e.w, fc2_e.scale, fc2_e.bias, out_dtype=float_dtype,
        **_mlp_layer(blk))


def _attention_layer(blk, hd: int, sm_scale: float):
    """K3's layer arguments of one block."""
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    # heads may differ per block in GETA-compressed subnets; the qkv width
    # encodes it (N = 3 * heads_i * hd)
    return dict(
        ln_scale=blk["norm1"]["scale"], ln_bias=blk["norm1"]["bias"],
        heads=qkv_e.w.shape[1] // (3 * hd), sm_scale=sm_scale,
        act_d=qkv_e.act["d"], act_t=qkv_e.act["t"], act_top=qkv_e.top,
        act_pow=qkv_e.act_pow, out_d=proj_e.act["d"],
        out_t=proj_e.act["t"], out_top=proj_e.top,
        out_pow=proj_e.act_pow, fmt=qkv_e.fmt)


def _mlp_layer(blk):
    """K2's layer arguments of one block."""
    fc1_e, fc2_e = blk["fc1"], blk["fc2"]
    return dict(
        ln_scale=blk["norm2"]["scale"], ln_bias=blk["norm2"]["bias"],
        act_d=fc1_e.act["d"], act_t=fc1_e.act["t"], act_top=fc1_e.top,
        act_pow=fc1_e.act_pow, hid_d=fc2_e.act["d"], hid_t=fc2_e.act["t"],
        hid_top=fc2_e.top, hid_pow=fc2_e.act_pow, fmt=fc1_e.fmt,
        fmt2=fc2_e.fmt)


def _quant_layer(entry: QLayerArtifact):
    """K1's layer arguments of a layer with the ``quant`` prologue."""
    return dict(fmt=entry.fmt, prologue="quant", act_d=entry.act["d"],
                act_t=entry.act["t"], act_top=entry.top,
                act_pow=entry.act_pow)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """An artifact prepared for the CUDA kernels, once
    (:func:`prepare_kernels`): each K1/K2/K3 call site of the forward
    with its weight copied into the kernels' layout and its constants
    folded, and K4's rows. It holds its own copy of every weight, beside
    the artifact's."""

    # per images_layout: the patch embed's K1 plan, then K4's positional
    # rows and scale ("nhwc": K1 returns the exact accumulators, K4
    # applies the dequant scale and the conv bias folded into the rows)
    embed: Dict[str, Tuple[MatmulPlan, torch.Tensor, torch.Tensor]]
    cls_row: torch.Tensor
    blocks: List[Tuple[AttentionPlan, MlpPlan]]
    head: Optional[MatmulPlan]


def kernel_limits(cfg: ViTConfig, n_align: int = 16) -> List[str]:
    """Why the CUDA kernels cannot serve ``cfg`` (empty if they can)."""
    hd = cfg.embed_dim // cfg.num_heads
    n_pad = _round_up(cfg.num_tokens, n_align)
    return [lim for lim in (heads_kernel_limit(n_pad, hd),
                            mlp_kernel_limit(cfg.embed_dim)) if lim]


def prepare_kernels(art, cfg: ViTConfig) -> KernelPlan:
    """The artifact's kernel plans (its tensors on a CUDA device). Raises a
    ValueError naming each kernel limit that ``cfg`` exceeds."""
    limits = kernel_limits(cfg)
    if limits:
        raise ValueError("the CUDA kernels cannot serve this configuration "
                         "(ROADMAP.md, kernel limits): " + "; ".join(limits))
    hd = art["pos_embed"].shape[-1] // cfg.num_heads
    sm_scale = cfg.qk_scale if cfg.qk_scale is not None else hd**-0.5
    pe = art["patch_embed"]
    patch_embed = plan_matmul(pe.w, pe.scale, pe.bias, **_quant_layer(pe))
    one = torch.ones((), dtype=torch.float32, device=pe.w.device)
    pos_patch, cls_row = _pos_rows(art, cfg)
    pos_acc = pos_patch if pe.bias is None else pos_patch + pe.bias
    embed = {
        "patches": (patch_embed, pos_patch.contiguous(), one),
        "nhwc": (dataclasses.replace(patch_embed, bias=None,
                                     scale=torch.ones_like(patch_embed.scale)),
                 pos_acc.contiguous(), pe.scale),
    }
    blocks = []
    for blk in art["blocks"]:
        qkv_e, proj_e = blk["qkv"], blk["proj"]
        fc1_e, fc2_e = blk["fc1"], blk["fc2"]
        blocks.append((
            plan_attention_block(
                qkv_e.w, qkv_e.scale, qkv_e.bias, proj_e.w, proj_e.scale,
                proj_e.bias, fmt_proj=proj_e.fmt,
                **_attention_layer(blk, hd, sm_scale)),
            plan_mlp(fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
                     fc2_e.bias, **_mlp_layer(blk))))
    he = art.get("head")
    return KernelPlan(
        embed=embed, cls_row=cls_row.contiguous(), blocks=blocks,
        head=None if he is None else plan_matmul(he.w, he.scale, he.bias,
                                                 **_quant_layer(he)))


@torch.no_grad()
def vit_int4_forward(art, images, cfg: ViTConfig,
                     float_dtype=torch.float32, int_attention: bool = False,
                     images_layout: str = "nhwc", n_align: int = 16,
                     input_scale: float | None = None,
                     use_kernels: bool = True,
                     plan: Optional[KernelPlan] = None):
    """Quantized ViT forward on integer weights.

    images: [B, H, W, C] (``images_layout='nhwc'``) or host-patchified
    [B, (H/P)*(W/P), P*P*C] (``'patches'``), float or — with
    ``input_scale`` — integer pixels cast and scaled on the device.
    ``float_dtype`` is the residual-stream dtype (bf16 serving, f32 strict
    parity); level math is always f32. Returns f32 logits [B, classes].

    Tensors off the CPU run the CUDA kernels unless ``use_kernels`` is
    False; ``plan`` is the artifact's :func:`prepare_kernels`, made here
    when not given (a caller that serves many batches keeps it). CPU
    tensors take the plain versions.
    """
    b = images.shape[0]
    if input_scale is not None:
        images = images.to(torch.float32) * torch.full(
            (), input_scale, dtype=torch.float32, device=images.device)
    n_real = cfg.num_tokens
    n_pad = _round_up(n_real, n_align)
    dim = art["pos_embed"].shape[-1]
    hd = dim // cfg.num_heads
    sm_scale = cfg.qk_scale if cfg.qk_scale is not None else hd**-0.5
    xp = _patches_2d(images, cfg, images_layout)
    if use_kernels and images.device.type != "cpu":
        if int_attention:
            raise NotImplementedError(
                "int_attention has no kernel path yet; pass "
                "use_kernels=False")
        plan = plan or prepare_kernels(art, cfg)
        pe_plan, pos_patch, pe_scale = plan.embed[images_layout]
        acc = run_matmul(pe_plan, xp, out_dtype=torch.float32)
        x2d = patch_finalize(acc.reshape(b, cfg.num_patches, dim), pos_patch,
                             plan.cls_row, pe_scale, n_pad=n_pad,
                             out_dtype=float_dtype)
        for attn, mlp in plan.blocks:
            x2d = run_attention_block(
                attn, x2d.reshape(b, n_pad, dim), n_valid=n_real,
                out_dtype=float_dtype).reshape(b * n_pad, dim)
            x2d = run_mlp(mlp, x2d, out_dtype=float_dtype)
    else:
        plan = None
        x2d = _embed_tokens(art, images, cfg, float_dtype, images_layout,
                            n_pad)
        for blk in art["blocks"]:
            x2d = _vit_block(x2d, blk, b=b, n_pad=n_pad, n_real=n_real,
                             dim=dim, hd=hd, sm_scale=sm_scale,
                             float_dtype=float_dtype,
                             int_attention=int_attention)
    x = x2d.reshape(b, n_pad, dim)[:, n_real - 1]  # cls row (last real row)
    x = _layernorm(x, art["norm"]).to(torch.float32)
    if "pre_logits" in art:
        x = torch.tanh(x @ art["pre_logits"]["kernel"]
                       + art["pre_logits"]["bias"])
    if "head" in art:
        x = (run_matmul(plan.head, x, out_dtype=torch.float32) if plan
             else _qmatmul(x, art["head"], torch.float32))
    return x


def random_vit_int4_artifact(cfg: ViTConfig, seed: int = 0,
                             pack_weights: bool = True, device="cuda"):
    """Random serving artifact with realistic scales. Draws from numpy in
    the order of the JAX function (vit_int4.py:704-752), so one seed gives
    the same artifact byte for byte."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)

    def t(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def qlayer(k, n, with_bias=True):
        w = t(rng.integers(-7, 8, (k, n)).astype(np.int8))
        return QLayerArtifact(
            w=pack_int4(w, axis=0) if pack_weights else w,
            scale=f32(1e-3),
            bias=t(rng.standard_normal(n).astype(np.float32) * 1e-2)
            if with_bias else None,
            act={"d": f32(0.05), "q_m": f32(0.35), "t": f32(1.0)},
            fmt="int4" if pack_weights else "int8", act_pow=False, top=7,
        )

    def ln(n):
        return {"scale": torch.ones((n,), dtype=torch.float32, device=dev),
                "bias": torch.zeros((n,), dtype=torch.float32, device=dev)}

    art = {
        "patch_embed": qlayer(cfg.patch_size**2 * cfg.in_channels, d),
        "cls_token": t(
            rng.standard_normal((1, 1, d)).astype(np.float32) * 0.02),
        "pos_embed": t(
            rng.standard_normal((1, cfg.num_tokens, d)).astype(np.float32)
            * 0.02),
        "blocks": [
            {
                "norm1": ln(d),
                "qkv": qlayer(d, 3 * d),
                "proj": qlayer(d, d),
                "norm2": ln(d),
                "fc1": qlayer(d, hidden),
                "fc2": qlayer(hidden, d),
            }
            for _ in range(cfg.depth)
        ],
        "norm": ln(d),
    }
    if cfg.num_classes > 0:
        art["head"] = qlayer(d, cfg.num_classes)
    return art


_QLAYER_FIELDS = ("w", "scale", "bias", "act", "fmt", "act_pow", "top")


def artifact_from_numpy(tree, device="cuda"):
    """The port's artifact from a JAX artifact pytree after
    ``jax.tree.map(np.asarray, art)``: arrays become tensors on ``device``
    with identical bytes; each layer object carrying the QLayerArtifact
    attributes (duck-typed: the port cannot import the JAX class) becomes
    this module's :class:`QLayerArtifact`."""
    dev = resolve_device(device)

    def conv(node):
        if node is None or isinstance(node, (bool, int, float, str)):
            return node
        if all(hasattr(node, f) for f in _QLAYER_FIELDS):
            return QLayerArtifact(
                w=conv(node.w), scale=conv(node.scale), bias=conv(node.bias),
                act=conv(node.act), fmt=str(node.fmt),
                act_pow=bool(node.act_pow), top=int(node.top))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        arr = np.asarray(node)
        return torch.from_numpy(np.array(arr, order="C")).to(dev)

    return conv(tree)
