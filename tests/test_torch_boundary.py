"""The port's boundaries: it never loads JAX or the JAX package, its
entry points default to the GPU (and raise without one), a kernel
wrapper given a tensor on any device other than the CPU never reaches its
plain version (a ``meta`` tensor stands in for a CUDA tensor here), and
the forward names the kernel limits a configuration exceeds before it
prepares anything."""

import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from quantized_vit_tpu_torch import resolve_device
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import attention as ta
from quantized_vit_tpu_torch.ops import block_stack as tb
from quantized_vit_tpu_torch.ops import fused as tf
from quantized_vit_tpu_torch.ops import patch as tp
from quantized_vit_tpu_torch.ops import ring_gather as trg

# ops.int4_matmul, the module (the package exports a function by its name)
tim = importlib.import_module("quantized_vit_tpu_torch.ops.int4_matmul")

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
             or m == "quantized_vit_tpu" or m.startswith("quantized_vit_tpu.")
             or m == "tools" or m.startswith("tools."))
# the training slice's modules, the FSDP slice's, UltraNet's (its
# quantizers, model, artifact, HLS headers, native packer, interop) and
# the other model families' are among those scanned
slice_ = {"quant.lsfq", "quant.bitwidth", "ops.quant_vjp", "models.layers",
          "models.vit", "opt.groups", "graph.builders", "opt.importance",
          "opt.geta", "graph.oto", "utils.losses", "utils.guards",
          "utils.data", "utils.native_prep", "utils.training",
          "opt.checkpoint", "ops.ring_gather", "serve.vit_fsdp",
          "parallel", "parallel.distributed", "parallel.peers",
          "ops.ablations", "tools.exp_pro", "tools.exp_pro2",
          "tools.exp_attn", "tools.exp_attn2", "tools.exp_epilogue",
          "tools.exp_fc1", "quant.dorefa", "quant.integer",
          "models.ultranet", "artifact.ultranet", "artifact.hls",
          "artifact.native", "interop", "interop.npz_export",
          "interop.torch_import", "models.resnet", "models.mobilenet",
          "models.transformer", "models.autoencoder", "models.lora",
          "graph.costs", "compress.subnet"}
missing = {m for m in slice_ if pkg.__name__ + "." + m not in mods}
print(len(mods), "modules;", "loaded:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(mods) < 42 else 0)
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
    # the FSDP slice's process group takes the card as its device
    from quantized_vit_tpu_torch.parallel import initialize_distributed

    with pytest.raises(RuntimeError, match="cuda"):
        initialize_distributed()
    with pytest.raises(RuntimeError, match="cuda"):
        initialize_distributed(device="cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _never(*a, **k):
    raise AssertionError("a non-CPU tensor reached the plain version")


@pytest.mark.parametrize("kernel", ["fused_quant_matmul", "fused_mlp",
                                    "fused_mlp_chunked",
                                    "attention_block", "attention_heads",
                                    "patch_finalize", "attention_qkv",
                                    "vit_block_stack", "attention_qkv_proj",
                                    "int4_matmul", "int8_matmul",
                                    "quant_matmul_fa", "flash_attention",
                                    "gather_rows", "fused_mlp_gather"])
def test_wrappers_never_reach_plain_for_non_cpu_tensors(kernel,
                                                        monkeypatch):
    for mod, name in ((tf, "fused_quant_matmul_plain"),
                      (tf, "fused_mlp_plain"),
                      (ta, "attention_block_plain"),
                      (ta, "attention_heads_plain"),
                      (ta, "fused_quant_matmul_plain"),
                      (tp, "patch_finalize_plain"),
                      (ta, "attention_qkv_plain"),
                      (tb, "vit_block_stack_plain"),
                      (ta, "attention_qkv_proj_plain"),
                      (tim, "int4_matmul_plain"),
                      (tim, "int8_matmul_plain"),
                      (tim, "quant_matmul_fa_plain"),
                      (ta, "flash_attention_plain"),
                      (trg, "gather_rows_plain"),
                      (trg, "fused_mlp_gather_plain"),
                      (trg, "fused_mlp_plain")):
        monkeypatch.setattr(mod, name, _never)
    i8 = torch.int8
    one = torch.tensor(1.0)
    q = dict(act_d=one, act_t=one, act_top=7)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "fused_quant_matmul":
            tf.fused_quant_matmul(_meta(8, 16), _meta(8, 4, dtype=i8), one,
                                  **q)
        elif kernel in ("fused_mlp", "fused_mlp_chunked"):
            # an explicit hid_block takes K8, as the JAX function's does
            hb = 16 if kernel == "fused_mlp_chunked" else None
            tf.fused_mlp(_meta(8, 16), _meta(16, 32, dtype=i8), one, None,
                         _meta(32, 16, dtype=i8), one, None,
                         ln_scale=_meta(16), ln_bias=_meta(16), hid_d=one,
                         hid_t=one, hid_top=7, hid_block=hb, **q)
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
        elif kernel == "attention_qkv_proj":
            ta.attention_qkv_proj(_meta(2, 8, 48), _meta(16, 24, dtype=i8),
                                  one, None, _meta(2, 8, 24), heads=2,
                                  sm_scale=0.25, out_d=one, out_t=one,
                                  out_top=7)
        elif kernel == "int4_matmul":
            tim.int4_matmul(_meta(8, 16, dtype=i8), _meta(8, 4, dtype=i8),
                            one)
        elif kernel == "int8_matmul":
            tim.int8_matmul(_meta(8, 16, dtype=i8), _meta(16, 4, dtype=i8),
                            one)
        elif kernel == "quant_matmul_fa":
            tim.quant_matmul_fa(_meta(8, 16), _meta(8, 4, dtype=i8), one,
                                None, one, one, 7)
        elif kernel == "flash_attention":
            q = _meta(2, 2, 8, 16)
            ta.flash_attention(q, q, q, sm_scale=0.25, out_d=one, out_t=one,
                               out_top=7)
        elif kernel == "gather_rows":
            trg.gather_rows([_meta(32, 16, dtype=i8)])
        elif kernel == "fused_mlp_gather":
            trg.fused_mlp_gather(
                _meta(8, 16), _meta(16, 32, dtype=i8), one, None,
                _meta(32, 16, dtype=i8), one, None, ln_scale=_meta(16),
                ln_bias=_meta(16), next_shards=[_meta(32, 16, dtype=i8)],
                hid_d=one, hid_t=one, hid_top=7, **q)
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


# configurations the JAX package serves, each with the batch, weight format
# and residual dtype that once reached a CUDA kernel's limit
# (ROADMAP.md "Kernel limits"), and what it exceeds now (nothing: served)
_OVER_LIMITS = {
    # ViT-H/14 with packed int4 weights at batch 1: the JAX package's
    # resident MLP kernel (K2 here), whose first design kept its fc2 row
    # block in registers (K <= 1024); the redesigned K2 serves it
    "vit_h14_int4": (dict(patch_size=14, embed_dim=1280, depth=1,
                          num_heads=16, mlp_ratio=4.0),
                     dict(batch=1, fmt="int4", float_dtype=torch.bfloat16),
                     []),
    # ViT-H/14 with an f32 residual stream at batch 32: the first K3 kept
    # the image's q/k/v in f32 in shared memory (272 tokens x head_dim 80
    # overflowed); K3 now streams them from a scratch and serves it
    "vit_h14_f32": (dict(patch_size=14, embed_dim=1280, depth=1,
                         num_heads=16, mlp_ratio=4.0),
                    dict(batch=32, fmt="int8", float_dtype=torch.float32),
                    []),
    # ViT-B/16 at 384 px, batch 32: 577 tokens (592 padded) overflowed the
    # first K3's shared memory even in bf16; served now
    "vit_b16_384": (dict(img_size=384, depth=1),
                    dict(batch=32, fmt="int8", float_dtype=torch.bfloat16),
                    []),
}


@pytest.mark.parametrize("name", sorted(_OVER_LIMITS))
def test_forward_names_the_kernel_limits_it_exceeds(name):
    """The forward names each limit a configuration exceeds before it
    prepares anything; a configuration within every limit (``wants``
    empty) goes on to plan its kernels (a meta tensor stands in for a
    CUDA tensor, so the first plan raises for its device, not for a
    limit), and the attention kernel of its route (K3 from batch 4, K6
    below) has a query tile for it on the H100."""
    from quantized_vit_tpu_torch.serve import (kernel_limits,
                                               random_vit_int4_artifact,
                                               uses_chain, vit_int4_forward)

    kw, route, wants = _OVER_LIMITS[name]
    cfg = ViTConfig(**kw)
    assert len(kernel_limits(cfg, **route)) == len(wants)
    assert kernel_limits(ViTConfig()) == []  # ViT-B/16 at 224 px fits
    art = random_vit_int4_artifact(cfg, pack_weights=route["fmt"] == "int4",
                                   device="meta")
    kp = cfg.patch_size**2 * cfg.in_channels
    with pytest.raises(ValueError) as err:
        vit_int4_forward(art, _meta(route["batch"], cfg.num_patches, kp),
                         cfg, float_dtype=route["float_dtype"],
                         images_layout="patches")
    if not wants:
        assert kernel_limits(cfg, **route) == []
        assert "kernel limits" not in str(err.value)
        assert "CUDA" in str(err.value)
        n_pad = -(-cfg.num_tokens // 16) * 16
        hd = cfg.embed_dim // cfg.num_heads
        itemsize = route["float_dtype"].itemsize
        if uses_chain(route["batch"]):
            assert ta.qkv_kernel_limit(hd) is None
            assert ta.qkv_attn_tile_rows(route["batch"], n_pad,
                                         cfg.num_heads, hd, itemsize) > 0
            return
        assert ta.heads_kernel_limit(hd) is None
        assert ta.heads_tile_rows(route["batch"], n_pad, cfg.num_heads, hd,
                                  itemsize) == 64
        return
    assert "kernel limits" in str(err.value)
    for want in wants:
        assert want in str(err.value)


def test_vit_h14_int8_serves_at_every_batch():
    """ViT-H/14 with int8-stored levels: no kernel limit at any batch (K6 +
    K8 at batch 1-2, K3 + the K1 chain from batch 4 on), with a bf16 or
    an f32 residual stream (K3 took f32 only to batch 3 before it streamed
    its q/k/v)."""
    from quantized_vit_tpu_torch.serve import kernel_limits

    cfg = ViTConfig(patch_size=14, embed_dim=1280, depth=1, num_heads=16)
    assert kernel_limits(cfg, fmt="int8", float_dtype=torch.bfloat16) == []
    for b in (1, 2, 3, 4, 32):
        assert kernel_limits(cfg, batch=b, fmt="int8") == []
    assert kernel_limits(cfg, batch=4, fmt="int8") == kernel_limits(
        cfg, fmt="int8")
    assert len(kernel_limits(cfg, fmt="int8")) == 0


def test_mlp_gather_takes_vit_h_width(monkeypatch):
    """K15 is K2's kernel with the gather folded in, so it has no width
    limit: the FSDP forward's limits are empty for ViT-H/14 (K = 1280) at
    every batch, the old refusal and its header are gone, and the
    wrapper plans K = 1280 at K2's work split (a 128 x 128 tile pair over
    ViT-H's batch-32 rows)."""
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.serve import kernel_limits

    vit_h = ViTConfig(patch_size=14, embed_dim=1280, depth=1, num_heads=16)
    assert kernel_limits(vit_h, fmt="int8", fsdp_rdma=True) == []
    for b in (1, 2, 16, 32):
        assert kernel_limits(vit_h, batch=b, fmt="int8",
                             float_dtype=torch.bfloat16,
                             fsdp_rdma=True) == []
    assert not hasattr(trg, "mlp_gather_kernel_limit")
    assert not hasattr(trg, "MLP_GATHER_MAX_K")
    csrc = Path(trg.__file__).resolve().parent.parent / "csrc"
    assert not (csrc / "fused_mlp_core.cuh").exists()
    assert not any("fused_mlp_core" in p.read_text()
                   for p in csrc.iterdir())
    seen = []
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(trg, "_card_sms", lambda index: 132)
    monkeypatch.setattr(trg, "_launch_mlp_gather",
                        lambda plan, gather, x, layout, **kw:
                        seen.append(layout))
    plan = tf.MlpPlan(*([None] * 2), False, False, 1280, 5120,
                      *([None] * 7), False, False, 127, 127, 1e-6)
    trg.run_mlp_gather(plan, None, _meta(8704, 1280, dtype=torch.bfloat16))
    (layout,) = seen
    assert layout == tf.mlp_layout(8704, 1280, 5120)
    assert (layout.tile1, layout.tile2, layout.splits) == (128, 128, 1)


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


def test_qkv_proj_kernel_limit_follows_shared_memory():
    """K9's limit (ops/attention.py:qkv_proj_kernel_limit): head_dim 80
    taken and 96 refused; any token count and qkv dtype (K and V stream
    in chunks, staged as f32), so 592 tokens at head_dim 64 in f32 (a
    384-px patch-16 model), which the first K9 refused, are taken; the
    bound is a 16-row tile's int8 levels of every head beside the weight
    buffers (csrc/attention_proj.cu:smem_bytes): 148 heads of 80 fit, 149
    do not. ViT-H/14's 16 heads of 80 fit at the kernel's 32-row tile in
    bf16 and f32, two blocks to an H100 SM (each block's 1 KiB of
    reserved shared memory included)."""
    lim = ta.qkv_proj_kernel_limit
    assert lim(16, 80) is None and lim(12, 64) is None
    assert "head_dim 96" in lim(16, 96)
    assert lim(148, 80) is None
    assert "shared memory" in lim(149, 80)
    assert ta.qkv_proj_layout(1, 592, 12, 64, 4) != (0, 0)
    assert 32 in ta.QKV_PROJ_TILES
    for itemsize in (2, 4):
        smem = ta.qkv_proj_smem_bytes(32, 80, 16 * 80, itemsize)
        assert smem <= ta.SMEM_LIMIT
        assert 2 * (smem + 1024) <= ta._H100_SM_SMEM
    assert ta.qkv_proj_smem_bytes(16, 80, 149 * 80) > ta.SMEM_LIMIT


def test_fsdp_forward_kernel_path_never_reaches_plain(monkeypatch):
    """The FSDP forward on non-CPU tensors prepares its kernel plans and
    raises there (a meta tensor is no CUDA tensor), never running a plain
    version or a gloo gather."""
    from quantized_vit_tpu_torch.serve import (random_vit_int4_artifact,
                                               shard_fsdp_rdma_artifact,
                                               vit_int4_forward_fsdp_rdma)
    from quantized_vit_tpu_torch.serve import vit_fsdp as sf

    for name in ("attention_block_plain", "fused_mlp_gather_plain",
                 "gather_rows_plain"):
        monkeypatch.setattr(sf, name, _never)
    cfg = ViTConfig(img_size=32, embed_dim=64, depth=2, num_heads=4,
                    num_classes=10)
    art = random_vit_int4_artifact(cfg, pack_weights=False, device="meta")
    fart = shard_fsdp_rdma_artifact(art, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        vit_int4_forward_fsdp_rdma(fart, _meta(2, 4, 768), cfg,
                                   images_layout="patches")


def test_serve_cli_answers_f32_like_the_jax_cli(tmp_path):
    """The port's serve CLI serves an f32 residual stream on the
    single-device path, as the JAX CLI does (a ported part, ROADMAP.md),
    so the two CLIs give the same logits on one artifact (within 1e-4,
    the port's f32 forward tolerance, tests/test_torch_vit_int4.py);
    JAX's ``--no-pallas`` is accepted as ``--no-kernels``."""
    import numpy as np

    from quantized_vit_tpu.cli import serve as j_serve
    from quantized_vit_tpu_torch.artifact import save_vit_int4_artifact
    from quantized_vit_tpu_torch.cli import serve
    from quantized_vit_tpu_torch.serve import random_vit_int4_artifact

    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                    num_heads=4, num_classes=10)
    save_vit_int4_artifact(str(tmp_path), random_vit_int4_artifact(
        cfg, seed=2, device="cpu"), cfg)
    images = np.random.default_rng(2).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    j_forward, _, _ = j_serve.build_forward(j_serve.parse_args(
        ["--artifact", str(tmp_path)]))
    want = np.asarray(j_forward(images))
    assert serve.SERVE_DTYPE == torch.float32
    for flag in ([], ["--no-kernels"], ["--no-pallas"]):
        args = serve.parse_args(["--artifact", str(tmp_path), "--device",
                                 "cpu"] + flag)
        assert args.no_kernels == bool(flag)
        forward, _, _ = serve.build_forward(args)
        got = forward(images)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
