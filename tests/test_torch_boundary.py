"""The port's boundaries: it never loads JAX or the JAX package, its
entry points default to the GPU (and raise without one), a kernel
wrapper given a tensor on any device other than the CPU never reaches its
plain version (a ``meta`` tensor stands in for a CUDA tensor here), and
the forward names the kernel limits a configuration exceeds before it
prepares anything."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from quantized_vit_tpu_torch import resolve_device
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import attention as ta
from quantized_vit_tpu_torch.ops import block_stack as tb
from quantized_vit_tpu_torch.ops import fused as tf
from quantized_vit_tpu_torch.ops import patch as tp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import quantized_vit_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert chip_smoke.main() != 0  # no card here: exits non-zero
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "quantized_vit_tpu" or m.startswith("quantized_vit_tpu."))
# the training slice's modules are among those scanned
slice_ = {"quant.lsfq", "quant.bitwidth", "ops.quant_vjp", "models.layers",
          "models.vit", "opt.groups", "graph.builders", "opt.importance",
          "opt.geta", "graph.oto", "utils.losses", "utils.guards",
          "utils.data", "utils.native_prep", "utils.training",
          "opt.checkpoint"}
missing = {m for m in slice_ if pkg.__name__ + "." + m not in mods}
print(len(mods), "modules;", "loaded:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(mods) < 38 else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_alone_exits_nonzero_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from quantized_vit_tpu_torch.artifact import (load_artifact_tree,
                                                  load_vit_int4_artifact,
                                                  save_vit_int4_artifact)
    from quantized_vit_tpu_torch.serve import random_vit_int4_artifact

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    cfg = ViTConfig(img_size=32, embed_dim=64, depth=1, num_heads=4,
                    num_classes=10)
    with pytest.raises(RuntimeError):
        random_vit_int4_artifact(cfg)
    save_vit_int4_artifact(
        str(tmp_path), random_vit_int4_artifact(cfg, device="cpu"), cfg)
    with pytest.raises(RuntimeError):
        load_vit_int4_artifact(str(tmp_path))
    with pytest.raises(RuntimeError):
        load_artifact_tree(str(tmp_path))
    # the training entry points default to the card as well
    from quantized_vit_tpu_torch.models import (QuantConfig, QuantConv,
                                                QuantDense,
                                                VisionTransformer)
    from quantized_vit_tpu_torch.models.vit import LayerNorm
    from quantized_vit_tpu_torch.opt import load_checkpoint, save_checkpoint
    from quantized_vit_tpu_torch.utils import TrainLoop, evaluate

    with pytest.raises(RuntimeError):
        VisionTransformer(cfg)
    q = QuantConfig(enabled=True, fused_vjp=True)
    with pytest.raises(RuntimeError):
        QuantDense(4, 4, q)
    with pytest.raises(RuntimeError):
        QuantConv(3, 4, (2, 2), config=q)
    with pytest.raises(RuntimeError):
        LayerNorm(4)
    save_checkpoint(str(tmp_path / "ckpt"), {"w": torch.ones(2)})
    with pytest.raises(RuntimeError):
        load_checkpoint(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError):
        TrainLoop(apply_fn=None, optimizer=None, num_classes=10)
    with pytest.raises(RuntimeError):
        evaluate(None, {}, [(None, None, None)])
    assert resolve_device("cpu") == torch.device("cpu")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _never(*a, **k):
    raise AssertionError("a non-CPU tensor reached the plain version")


@pytest.mark.parametrize("kernel", ["fused_quant_matmul", "fused_mlp",
                                    "attention_block", "attention_heads",
                                    "patch_finalize", "attention_qkv",
                                    "vit_block_stack"])
def test_wrappers_never_reach_plain_for_non_cpu_tensors(kernel,
                                                        monkeypatch):
    for mod, name in ((tf, "fused_quant_matmul_plain"),
                      (tf, "fused_mlp_plain"),
                      (ta, "attention_block_plain"),
                      (ta, "attention_heads_plain"),
                      (ta, "fused_quant_matmul_plain"),
                      (tp, "patch_finalize_plain"),
                      (ta, "attention_qkv_plain"),
                      (tb, "vit_block_stack_plain")):
        monkeypatch.setattr(mod, name, _never)
    i8 = torch.int8
    one = torch.tensor(1.0)
    q = dict(act_d=one, act_t=one, act_top=7)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "fused_quant_matmul":
            tf.fused_quant_matmul(_meta(8, 16), _meta(8, 4, dtype=i8), one,
                                  **q)
        elif kernel == "fused_mlp":
            tf.fused_mlp(_meta(8, 16), _meta(16, 32, dtype=i8), one, None,
                         _meta(32, 16, dtype=i8), one, None,
                         ln_scale=_meta(16), ln_bias=_meta(16), hid_d=one,
                         hid_t=one, hid_top=7, **q)
        elif kernel in ("attention_block", "attention_heads"):
            fn = getattr(ta, kernel)
            args = (_meta(2, 8, 16), _meta(16, 48, dtype=i8), one, None)
            if kernel == "attention_block":
                args += (_meta(16, 16, dtype=i8), one, None)
            fn(*args, ln_scale=_meta(16), ln_bias=_meta(16), heads=2,
               sm_scale=0.25, out_d=one, out_t=one, out_top=7, **q)
        elif kernel == "attention_qkv":
            ta.attention_qkv(_meta(2, 8, 48), heads=2, sm_scale=0.25,
                             out_d=one, out_t=one, out_top=7)
        elif kernel == "vit_block_stack":
            # one block of width 32, 2 heads, hidden 64, int8 weights
            w = lambda k, n: _meta(1, k, n, dtype=i8)  # noqa: E731
            vec = _meta(1, 32)
            sc = [_meta(1)] * 8
            tb.vit_block_stack(
                _meta(8, 32), w(32, 96), _meta(1, 96), _meta(1, 96), vec,
                vec, w(32, 32), vec, vec, vec, vec, w(32, 64), _meta(1, 64),
                _meta(1, 64), w(64, 32), vec, vec, *sc, heads=2,
                sm_scale=0.25, fmt="int8")
        else:
            tp.patch_finalize(_meta(2, 4, 16), _meta(4, 16), _meta(16), one,
                              n_pad=8)


def test_forward_kernel_path_never_reaches_plain(monkeypatch):
    """The forward's kernel path (a prepared plan) on non-CPU tensors
    raises in the plan rather than running a plain version."""
    from quantized_vit_tpu_torch.serve import (random_vit_int4_artifact,
                                               vit_int4_forward)
    from quantized_vit_tpu_torch.serve import vit_int4 as sv

    for name in ("fused_quant_matmul_plain", "fused_mlp_plain",
                 "attention_block_plain", "patch_finalize_plain"):
        monkeypatch.setattr(sv, name, _never)
    cfg = ViTConfig(img_size=32, embed_dim=64, depth=1, num_heads=4,
                    num_classes=10)
    art = random_vit_int4_artifact(cfg, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        vit_int4_forward(art, _meta(2, 4, 768), cfg,
                         images_layout="patches")


# configurations the JAX package serves that exceed the CUDA kernels'
# limits (ROADMAP.md "Kernel limits"), each with what it exceeds
_OVER_LIMITS = {
    # ViT-H/14: D 1280 > K2's 1024; head_dim 80 > K3's 64
    "vit_h14": (dict(patch_size=14, embed_dim=1280, depth=1, num_heads=16,
                     mlp_ratio=4.0), ["K=1280 > 1024", "head_dim 80"]),
    # ViT-B/16 at 384 px: 577 tokens (592 padded) overflow K3's shared memory
    "vit_b16_384": (dict(img_size=384, depth=1), ["592 tokens"]),
}


@pytest.mark.parametrize("name", sorted(_OVER_LIMITS))
def test_forward_names_the_kernel_limits_it_exceeds(name):
    from quantized_vit_tpu_torch.serve import (kernel_limits,
                                               random_vit_int4_artifact,
                                               vit_int4_forward)

    kw, wants = _OVER_LIMITS[name]
    cfg = ViTConfig(**kw)
    assert len(kernel_limits(cfg)) == len(wants)
    assert kernel_limits(ViTConfig()) == []  # ViT-B/16 at 224 px fits
    art = random_vit_int4_artifact(cfg, pack_weights=False, device="meta")
    kp = cfg.patch_size**2 * cfg.in_channels
    with pytest.raises(ValueError, match="kernel limits") as err:
        vit_int4_forward(art, _meta(1, cfg.num_patches, kp), cfg,
                         images_layout="patches")
    for want in wants:
        assert want in str(err.value)


def test_fused_quantizer_backward_never_reaches_plain(monkeypatch):
    """K7's wrapper, and the fused quantizer's autograd backward that calls
    it, on a non-CPU tensor raise instead of running the plain chain."""
    from quantized_vit_tpu_torch.ops import quant_vjp as tq
    from quantized_vit_tpu_torch.quant import lsfq_nonlinear_fused

    monkeypatch.setattr(tq, "lsfq_nonlinear_bwd_plain", _never)
    one = _meta(1)
    with pytest.raises(ValueError, match="CUDA"):
        tq.lsfq_nonlinear_bwd_fused(_meta(8, 1000), _meta(8, 1000), one,
                                    one, one, clip_lo=-2.0, clip_hi=2.0)
    x = _meta(768, 1000).requires_grad_()  # the head weight: no width gate
    d, q_m, t = (_meta(1).requires_grad_() for _ in range(3))
    y = lsfq_nonlinear_fused(x, d, q_m, t, -2.0, 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        y.sum().backward()
