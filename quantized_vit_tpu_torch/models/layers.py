"""Quantized layers (``quantized_vit_tpu/models/layers.py``) as
``nn.Module``s with flax's parameter names and layouts.

Each quantized layer owns its float ``kernel`` ([in, out] for a dense
layer, HWIO for a conv, as flax keeps them), ``bias``, and the learnable
one-element scalars ``d_quant_wt``, ``q_m_wt`` (+ ``t_quant_wt`` for the
nonlinear quantizer) and the ``_act`` trio when activations are quantized.
The forward quantizes the weight (and the input) and then runs the dense or
conv product. ``QuantConfig(enabled=False)`` makes the layers plain
dense/conv layers.

Parameters are created uninitialised-but-valid (flax's initializers with a
``torch.Generator``: they cannot draw JAX's numbers); a model takes real
weights through ``models/vit.py:params_from_jax`` or a checkpoint, and the
quantizer scalars through :func:`init_quant_params_tree`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..quant.lsfq import (dge, lsfq_linear, lsfq_nonlinear,
                          lsfq_nonlinear_fused)

QUANT_PARAM_NAMES = (
    "d_quant_wt", "q_m_wt", "t_quant_wt",
    "d_quant_act", "q_m_act", "t_quant_act",
)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization configuration of a model (the JAX package's
    ``QuantConfig``, every field)."""

    enabled: bool = True
    nonlinear: bool = True          # SYMMETRIC_NONLINEAR vs SYMMETRIC_LINEAR
    use_dge: bool = False           # DGE quantizer
    quantize_acts: bool = True      # WEIGHT_AND_ACTIVATION vs WEIGHT_ONLY
    weight_clip: Tuple[float, float] = (-2.0, 2.0)
    act_clip: Tuple[float, float] = (-2.0, 2.0)
    init_bits: float = 32.0
    dge_bits: float = 4.0
    # None (f32 dots) or "bfloat16": the dense/conv/attention dots take
    # operands rounded to bf16 and accumulate in f32; quantizer math,
    # LayerNorm and softmax stay f32
    matmul_dtype: Optional[str] = None
    # the fused single-pass quantizer backward (K7 on the card)
    fused_vjp: bool = False

    @staticmethod
    def off() -> "QuantConfig":
        return QuantConfig(enabled=False)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "QuantConfig":
        """From the plain dict a ``ViTConfig`` or an artifact manifest
        holds (clip ranges as lists)."""
        return QuantConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in d.items()})

    def asdict(self) -> Dict[str, Any]:
        """The plain dict form (clip ranges as lists, as JSON keeps
        them); ``from_dict(c.asdict()) == c``."""
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(self).items()}


def _mm_cast(config: QuantConfig, x, kernel):
    """Mixed-precision dot operands (``QuantConfig.matmul_dtype``):
    (x, kernel, mixed)."""
    if config.enabled and config.matmul_dtype is not None:
        dt = getattr(torch, config.matmul_dtype)
        return x.to(dt), kernel.to(dt), True
    return x, kernel, False


def mm_dot(x, kernel, mixed: bool):
    """``x @ kernel``; ``mixed``: the operands are bf16-rounded and the
    products accumulate in f32 (JAX's ``preferred_element_type=f32``), so
    the product runs on the f32 upcasts of the rounded values."""
    if mixed:
        return torch.matmul(x.float(), kernel.float())
    return torch.matmul(x, kernel)


def _trunc_normal(shape, std, gen, device):
    """flax's truncated normal (cut at +-2 std) from a torch generator."""
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)
    return t.to(device)


class _QuantLayer(nn.Module):
    """The parameters and quantize dispatch shared by dense and conv; they
    lie on ``device``, the GPU unless the caller asks for the CPU."""

    def __init__(self, kernel_shape, features, config: QuantConfig,
                 use_bias: bool, kernel_std: float, gen, device):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.kernel = nn.Parameter(_trunc_normal(kernel_shape, kernel_std,
                                                 gen, device))
        self.register_parameter("bias", nn.Parameter(torch.zeros(
            features, device=device)) if use_bias else None)
        if config.enabled:
            suffixes = ("wt", "act") if config.quantize_acts else ("wt",)
            for s in suffixes:
                names = ["d_quant", "q_m"] + (["t_quant"] if config.nonlinear
                                              else [])
                for nm in names:
                    self.register_parameter(f"{nm}_{s}", nn.Parameter(
                        torch.ones((1,), device=device)))
            self.register_buffer("weight_clip", torch.tensor(
                config.weight_clip, device=device), persistent=False)
            self.register_buffer("act_clip", torch.tensor(
                config.act_clip, device=device), persistent=False)

    def _quantize(self, x, suffix: str):
        cfg = self.config
        d = getattr(self, f"d_quant_{suffix}")
        q_m = getattr(self, f"q_m_{suffix}")
        clip = cfg.weight_clip if suffix == "wt" else cfg.act_clip
        clip_val = self.weight_clip if suffix == "wt" else self.act_clip
        if cfg.use_dge:
            return dge(x, d, q_m, clip_val, 0.0, cfg.dge_bits)
        if cfg.nonlinear:
            t = getattr(self, f"t_quant_{suffix}")
            if cfg.fused_vjp:
                return lsfq_nonlinear_fused(x, d, q_m, t, clip[0], clip[1],
                                            0.0)
            return lsfq_nonlinear(x, d, q_m, t, clip, 0.0)
        return lsfq_linear(x, d, q_m, clip_val, 0.0)

    def _quant_weight(self, kernel):
        if self.config.enabled:
            return self._quantize(kernel, "wt")
        return kernel

    def _quant_input(self, x):
        if self.config.enabled and self.config.quantize_acts:
            return self._quantize(x, "act")
        return x


class QuantDense(_QuantLayer):
    """Dense layer with LSFQ weight (+activation) fake-quantization; kernel
    [in, out] (flax ``truncated_normal(0.01)`` init)."""

    def __init__(self, in_features: int, features: int,
                 config: QuantConfig = QuantConfig.off(),
                 use_bias: bool = True, kernel_std: float = 0.01, gen=None,
                 device="cuda"):
        super().__init__((in_features, features), features, config,
                         use_bias, kernel_std, gen, device)

    def forward(self, x):
        kernel = self._quant_weight(self.kernel)
        x = self._quant_input(x)
        xd, kd, mixed = _mm_cast(self.config, x, kernel)
        y = mm_dot(xd, kd, mixed)
        if self.bias is not None:
            y = y + self.bias
        return y


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class QuantConv(_QuantLayer):
    """Conv with LSFQ weight (+activation) fake-quantization; NHWC input,
    HWIO kernel (flax ``kaiming_normal`` init)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding: Any = "SAME",
                 config: QuantConfig = QuantConfig.off(),
                 use_bias: bool = True, feature_group_count: int = 1,
                 gen=None, device="cuda"):
        kh, kw = kernel_size
        cin = in_channels // feature_group_count
        # variance_scaling(2.0, fan_in, truncated normal): the std of the
        # untruncated normal divided by the truncation's shrink factor
        std = math.sqrt(2.0 / (kh * kw * cin)) / 0.87962566103423978
        super().__init__((kh, kw, cin, features), features, config,
                         use_bias, std, gen, device)
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.feature_group_count = feature_group_count
        self.features = features

    def forward(self, x):
        kernel = self._quant_weight(self.kernel)
        ks = self.kernel_size
        # A non-overlapping patch conv (stride == kernel, VALID,
        # ungrouped: the ViT patch embed) is the exact space-to-depth GEMM;
        # the per-tensor quantizer is permutation-invariant, so quantizing
        # the patchified view equals quantizing the image.
        if (self.strides == ks and self.feature_group_count == 1
                and self.padding == "VALID" and x.ndim == 4
                and x.shape[1] % ks[0] == 0 and x.shape[2] % ks[1] == 0):
            b, H, W, C = x.shape
            ph, pw = ks
            xp = x.reshape(b, H // ph, ph, W // pw, pw, C)
            xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(
                b * (H // ph) * (W // pw), ph * pw * C)
            xp = self._quant_input(xp)
            xd, kd, mixed = _mm_cast(self.config, xp, kernel.reshape(
                ph * pw * C, self.features))
            y = mm_dot(xd, kd, mixed).reshape(b, H // ph, W // pw,
                                              self.features)
            if self.bias is not None:
                y = y + self.bias
            return y

        x = self._quant_input(x)
        x, kernel, mixed = _mm_cast(self.config, x, kernel)
        if mixed:
            x, kernel = x.float(), kernel.float()
        xc = x.permute(0, 3, 1, 2)
        if self.padding == "SAME":
            (t, bo), (l, r) = (_same_pads(xc.shape[2], ks[0], self.strides[0]),
                               _same_pads(xc.shape[3], ks[1], self.strides[1]))
        elif self.padding == "VALID":
            t = bo = l = r = 0
        elif isinstance(self.padding, int):
            t = bo = l = r = self.padding
        else:
            (t, bo), (l, r) = self.padding
        xc = F.pad(xc, (l, r, t, bo))
        y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), stride=self.strides,
                     groups=self.feature_group_count)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias
        return y


# ---------------------------------------------------------------------------
# functions over a params tree ({name: tensor or subtree}, flax's paths)
# ---------------------------------------------------------------------------


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """{'a/b/c': leaf} of a nested dict, in the dict's order."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: Dict[str, Any]):
    """Inverse of :func:`flatten_tree`."""
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return root


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def init_quant_params_tree(params, init_bits: float = 32.0):
    """Set each quantized layer's (d, q_m, t) from its float kernel: for
    every dict holding both a ``kernel`` and quant params, q_m_* =
    max|kernel|, d_* = q_m / (2^(init_bits-1) - 1), t_* = 1 (weight and
    activation trios alike). Returns a new tree; other leaves are kept."""

    def visit(node):
        if not isinstance(node, dict):
            return node
        out = {k: visit(v) for k, v in node.items()}
        if "kernel" in out and "d_quant_wt" in out:
            k = out["kernel"].detach()
            q_m = k.abs().max().reshape(1).to(k.dtype)
            d = (q_m / (2.0 ** (init_bits - 1.0) - 1.0)).to(k.dtype)
            for suffix in ("wt", "act"):
                if f"d_quant_{suffix}" in out:
                    out[f"d_quant_{suffix}"] = d.clone()
                    out[f"q_m_{suffix}"] = q_m.clone()
                if f"t_quant_{suffix}" in out:
                    out[f"t_quant_{suffix}"] = torch.ones(
                        (1,), dtype=k.dtype, device=k.device)
        return out

    return visit(params)


def collect_quant_params(params, prefix: str = ""):
    """{layer_path: {name: value}} for every layer's quant scalars."""
    found = {}

    def visit(node, path):
        if not isinstance(node, dict):
            return
        qp = {k: v for k, v in node.items() if k in QUANT_PARAM_NAMES}
        if qp:
            found[path] = qp
        for k, v in node.items():
            visit(v, f"{path}/{k}" if path else k)

    visit(params, prefix)
    return found


def bitwidth_dict(params):
    """{layer_path: {'weight_bit': b, 'act_bit': b}} with
    bits = log2(q_m^t/|d| + 1) + 1 (32 where activations are not
    quantized)."""
    from ..quant.bitwidth import bit_width

    out = {}
    for path, qp in collect_quant_params(params).items():
        entry = {"weight_bit": float(bit_width(
            qp["d_quant_wt"], qp["q_m_wt"], qp.get("t_quant_wt"))[0])}
        if "d_quant_act" in qp:
            entry["act_bit"] = float(bit_width(
                qp["d_quant_act"], qp["q_m_act"], qp.get("t_quant_act"))[0])
        else:
            entry["act_bit"] = 32.0
        out[path] = entry
    return out
