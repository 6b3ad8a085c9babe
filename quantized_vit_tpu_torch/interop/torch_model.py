"""Reference-shaped torch ViT for the ``torch``/``onnx`` interchange of
compressed subnets (``quantized_vit_tpu/interop/torch_model.py``).

The reference exports compressed models three ways: whole-module pickle,
``torch.onnx.export``, and HF ``save_pretrained``
(pruning_compression.py:374-391). The port writes the state-dict + arch
interchange (``cli.export torch``) and the ONNX graph (``cli.export
onnx``) through the module built here: a standalone ``nn.Module`` with the
reference's module names (vit_model.py:211-328), so the dict that
``vit_params_to_torch`` writes loads into it directly.

The graph is the **compressed dense float model**, the deployment
interchange format, as the reference's own onnx branch (which traces the
fake-quant forward into float ops anyway). :func:`bake_weight_quant` first
replaces each kernel with its dequantized LSFQ levels (the weight-quant
numerics kept exactly; activation fake-quant is a training construct the
reference's onnx consumers drop too). The integer path ships through the
serving artifact (``artifact/vit.py``), not ONNX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.layers import QUANT_PARAM_NAMES


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * heads * head_dim, bias=True)
        self.proj = nn.Linear(heads * head_dim, dim, bias=True)
        self.num_heads, self.head_dim = heads, head_dim

    def forward(self, x):
        b, n, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(b, n, h * hd)
        return self.proj(x)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, bias=True)
        self.act = nn.GELU()  # the exact erf GELU, as vit_model.py's
        self.fc2 = nn.Linear(hidden, dim, bias=True)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, in_ch: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, kernel_size=patch, stride=patch)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class _PreLogits(nn.Module):
    def __init__(self, dim: int, rep: int):
        super().__init__()
        self.fc = nn.Linear(dim, rep)
        self.act = nn.Tanh()

    def forward(self, x):
        return self.act(self.fc(x))


class TorchViT(nn.Module):
    """The reference's VisionTransformer layout: NCHW input, the cls token
    first (vit_model.py:126), ``pre_logits.fc`` + tanh when the config has
    a representation size."""

    def __init__(self, img: int, patch: int, in_ch: int, dim: int,
                 depth: int, heads: int, heads_pb, hidden_pb, classes: int,
                 rep):
        super().__init__()
        head_dim = dim // heads
        n_tokens = (img // patch) ** 2 + 1
        self.patch_embed = _PatchEmbed(in_ch, dim, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, dim))
        self.blocks = nn.ModuleList([
            _Block(dim, int(heads_pb[i]), head_dim, int(hidden_pb[i]))
            for i in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        if rep:
            self.pre_logits = _PreLogits(dim, int(rep))
        head_in = int(rep) if rep else dim
        self.head = (nn.Linear(head_in, classes) if classes > 0
                     else nn.Identity())

    def forward(self, x):
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)[:, 0]
        if hasattr(self, "pre_logits"):
            x = self.pre_logits(x)
        return self.head(x)


@torch.no_grad()
def _init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """The reference's ``_init_vit_weights`` drawn from ``gen`` on the CPU
    and copied to the module's device: Linear trunc-normal(0.01), Conv2d
    kaiming-normal (fan_out), LayerNorm ones/zeros, cls token and position
    embeddings trunc-normal(0.02)."""

    def put(t, fn):
        cpu = torch.empty(tuple(t.shape), dtype=t.dtype)
        fn(cpu)
        t.copy_(cpu)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            put(m.weight, lambda c: nn.init.trunc_normal_(
                c, std=0.01, generator=gen))
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            put(m.weight, lambda c: nn.init.kaiming_normal_(
                c, mode="fan_out", generator=gen))
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for p in (model.cls_token, model.pos_embed):
        put(p, lambda c: nn.init.trunc_normal_(c, std=0.02, generator=gen))


def build_torch_vit(cfg: Mapping[str, Any], device="cuda") -> TorchViT:
    """Reference-shaped torch ViT (vit_model.py:211-328) from an arch dict
    (the ``arch.json`` that ``cli.export torch`` writes,
    ``dataclasses.asdict`` of a ViTConfig), on ``device`` (the card unless
    the caller asks for the CPU). A compressed subnet's per-block head
    counts and MLP widths come from its ``heads_per_block`` and
    ``hidden_per_block``. The weights are drawn from a generator seeded
    with 0 (never the global one) until :func:`load_interchange` loads
    real ones.

    Module names are the reference's: ``patch_embed.proj``,
    ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
    ``norm``, ``head`` (and ``pre_logits.fc``)."""
    dev = resolve_device(device)
    dim = int(cfg.get("embed_dim", 768))
    depth = int(cfg.get("depth", 12))
    heads = int(cfg.get("num_heads", 12))
    mlp_ratio = float(cfg.get("mlp_ratio", 4.0))
    with torch.device("meta"):  # nothing drawn from the global generator
        model = TorchViT(
            img=int(cfg.get("img_size", 224)),
            patch=int(cfg.get("patch_size", 16)),
            in_ch=int(cfg.get("in_channels", 3)), dim=dim, depth=depth,
            heads=heads,
            heads_pb=cfg.get("heads_per_block") or [heads] * depth,
            hidden_pb=(cfg.get("hidden_per_block")
                       or [int(dim * mlp_ratio)] * depth),
            classes=int(cfg.get("num_classes", 1000)),
            rep=cfg.get("representation_size"))
    model = model.to_empty(device=dev)
    _init_weights(model, torch.Generator().manual_seed(0))
    return model


def load_interchange(model: nn.Module, state: Mapping[str, Any]):
    """Load a ``vit_params_to_torch`` dict into ``model``, the tensors on
    the module's device. The quant scalars (d_quant_*, q_m_*, t_quant_*)
    are dropped: they parameterize the training-time fake-quant, not the
    float graph (:func:`bake_weight_quant` on the params first keeps the
    weight-quant numerics). Shapes must agree (a subnet's per-block widths
    come from the arch dict); missing or unknown keys raise KeyError."""
    dev = next(model.parameters()).device
    state = {k: (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v))).to(dev)
             for k, v in state.items()
             if k.rsplit(".", 1)[-1] not in QUANT_PARAM_NAMES}
    res = model.load_state_dict(state, strict=False)
    if res.missing_keys:
        raise KeyError(
            f"interchange dict missing params: {res.missing_keys[:5]}")
    if res.unexpected_keys:
        raise KeyError(
            f"interchange dict has unknown keys: {res.unexpected_keys[:5]}")
    return model


def bake_weight_quant(params, cfg=None) -> Dict[str, Any]:
    """Replace every quantized kernel with its dequantized LSFQ levels
    (``levels * d``, as ``serve.vit_int4._export_layer`` exports them), so
    the float export carries the trained weight-quant numerics exactly.
    ``cfg`` is taken for the JAX function's signature."""
    from ..quant.lsfq import lsfq_levels

    def visit(node):
        if not isinstance(node, dict):
            return node
        out = {k: visit(v) for k, v in node.items()}
        if "kernel" in out and "d_quant_wt" in out:
            d = out["d_quant_wt"]
            t = out.get("t_quant_wt")
            lv = lsfq_levels(out["kernel"], d, out["q_m_wt"],
                             torch.ones_like(d) if t is None else t)
            out["kernel"] = lv.to(torch.float32) * d
        return out

    with torch.no_grad():
        return visit(params)


def export_onnx(out_path: str, model: nn.Module, img_size: int,
                in_ch: int = 3, opset: int = 17) -> str:
    """``torch.onnx.export`` of the built module, its dummy input on the
    module's device. Needs the ``onnx`` package; without it raises a
    RuntimeError naming it."""
    try:
        import onnx  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "ONNX export needs the 'onnx' package, which this environment "
            "does not provide (torch.onnx.export serializes through it). "
            "Install onnx and rerun; the torch module itself is built and "
            "loaded without it (interop.torch_model.build_torch_vit).") from e
    model.eval()
    dev = next(model.parameters()).device
    dummy = torch.zeros(1, in_ch, img_size, img_size, device=dev)
    torch.onnx.export(model, (dummy,), out_path, opset_version=opset,
                      input_names=["images"], output_names=["logits"],
                      dynamic_axes={"images": {0: "batch"},
                                    "logits": {0: "batch"}})
    return out_path
