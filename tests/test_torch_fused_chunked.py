"""Port parity: the hidden-chunked MLP (kernel K8, ``fused_mlp_chunked``)
and the JAX package's MLP routing, against the JAX package.

K8's plain version is ``fused_mlp_plain``: the JAX package's chunked and
resident kernels compute one function, bit for bit
(tests/ops/test_fused.py:245-283). The JAX side runs its chunked Pallas
kernel in interpret mode. The routing (which of K2, K8 or the two-K1
chain a shape takes) is shape arithmetic of the TPU's VMEM budget, held
against the JAX functions and against the kernels the JAX forward's
block traces to (``jax.make_jaxpr`` of ``_vit_block``: no compute).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.models.vit import ViTConfig as JConfig
from quantized_vit_tpu.ops import fused as jf
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu.serve.vit_int4 import _vit_block as j_vit_block
from quantized_vit_tpu_torch.ops import fused as tf
from quantized_vit_tpu_torch.serve import vit_int4 as tv

torch.set_num_threads(1)

# (width, hidden, padded tokens) of ViT-B/16, ViT-L/16 at 224 px and
# ViT-H/14 (n_align 16: 197 -> 208, 257 -> 272)
PRESETS = {"vit_b16": (768, 3072, 208), "vit_l16": (1024, 4096, 208),
           "vit_h14": (1280, 5120, 272)}


def _chunked_inputs(seed=3, k=128, hid=512, m=96):
    """tests/ops/test_fused.py:250-263's inputs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    w1 = rng.integers(-7, 8, (k, hid)).astype(np.int8)
    w2 = rng.integers(-7, 8, (hid, k)).astype(np.int8)
    b1 = (rng.standard_normal(hid) * 0.01).astype(np.float32)
    b2 = (rng.standard_normal(k) * 0.01).astype(np.float32)
    ln_s = (rng.standard_normal(k) * 0.1 + 1.0).astype(np.float32)
    ln_b = (rng.standard_normal(k) * 0.01).astype(np.float32)
    return x, w1, w2, b1, b2, ln_s, ln_b


@pytest.mark.parametrize("hb", [256, 128])
@pytest.mark.parametrize("pow_", [False, True], ids=["lin", "pow"])
def test_chunked_plain_matches_jax_chunked_kernel(pow_, hb):
    """``fused_mlp(..., hid_block=hb)`` on CPU tensors (K8's plain
    version) equals the JAX chunked Pallas kernel in interpret mode, bit
    for bit: the same f32 level math on the same integer sums."""
    x, w1, w2, b1, b2, ln_s, ln_b = _chunked_inputs()
    t_a, t_h = (1.08, 0.93) if pow_ else (1.0, 1.0)
    want = np.asarray(jf.fused_mlp(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1), jnp.float32(1e-3),
        jnp.asarray(b1), jnp.asarray(w2), jnp.float32(1e-3), jnp.asarray(b2),
        ln_scale=jnp.asarray(ln_s), ln_bias=jnp.asarray(ln_b),
        act_d=jnp.float32(0.05), act_t=jnp.float32(t_a), act_top=127,
        act_pow=pow_, hid_d=jnp.float32(0.05), hid_t=jnp.float32(t_h),
        hid_top=127, hid_pow=pow_, fmt="int8", out_dtype=jnp.bfloat16,
        hid_block=hb, interpret=True), np.float32)
    f32 = torch.float32
    got = tf.fused_mlp(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w1),
        torch.tensor(1e-3), torch.from_numpy(b1), torch.from_numpy(w2),
        torch.tensor(1e-3), torch.from_numpy(b2),
        ln_scale=torch.from_numpy(ln_s), ln_bias=torch.from_numpy(ln_b),
        act_d=torch.tensor(0.05, dtype=f32),
        act_t=torch.tensor(t_a, dtype=f32), act_top=127, act_pow=pow_, hid_d=torch.tensor(0.05, dtype=f32),
        hid_t=torch.tensor(t_h, dtype=f32), hid_top=127, hid_pow=pow_,
        fmt="int8", out_dtype=torch.bfloat16, hid_block=hb)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_hid_block_needs_int8_weights():
    """An explicit hid_block with packed int4 weights raises, as the JAX
    function does (fused.py:930-932); a hid_block that does not divide H
    too."""
    x, w1, w2, b1, b2, ln_s, ln_b = _chunked_inputs(k=256, hid=512, m=8)
    kw = dict(ln_scale=torch.from_numpy(ln_s), ln_bias=torch.from_numpy(ln_b),
              act_d=torch.tensor(0.05), act_t=torch.tensor(1.0), act_top=7,
              hid_d=torch.tensor(0.05), hid_t=torch.tensor(1.0), hid_top=7)
    from quantized_vit_tpu_torch.quant import pack_int4

    args = (torch.from_numpy(x), pack_int4(torch.from_numpy(w1)),
            torch.tensor(1e-3), None, pack_int4(torch.from_numpy(w2)),
            torch.tensor(1e-3), None)
    with pytest.raises(ValueError, match="int8.* only"):
        tf.fused_mlp(*args, fmt="int4", hid_block=128, **kw)
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    with pytest.raises(ValueError, match="int8"):
        jf.fused_mlp(jnp.asarray(x), *(jnp.asarray(a.numpy())
                                       if isinstance(a, torch.Tensor) else a
                                       for a in args[1:]),
                     fmt="int4", hid_block=128, interpret=True, **jkw)
    with pytest.raises(ValueError, match="divide"):
        tf.fused_mlp(torch.from_numpy(x), torch.from_numpy(w1),
                     torch.tensor(1e-3), None, torch.from_numpy(w2),
                     torch.tensor(1e-3), None, fmt="int8", hid_block=96,
                     **kw)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_routing_arithmetic_matches_jax(preset, fmt, itemsize):
    """The port's copy of the TPU's VMEM arithmetic gives the JAX
    package's resident M tile and its M-tile picks at ViT-B, L and H
    widths, in both weight formats and both residual dtypes."""
    k, hid, n_pad = PRESETS[preset]
    assert tf.fused_mlp_resident_bm(k, hid, fmt, itemsize, itemsize) == \
        jf.fused_mlp_resident_bm(k, hid, fmt, itemsize, itemsize)
    assert tf._mlp_auto_stripes(hid) == jf._mlp_auto_stripes(hid)
    t_fits = tf._mlp_resident_fits(k, hid, fmt, itemsize, itemsize,
                                   tf._mlp_auto_stripes(hid))
    j_fits = jf._mlp_resident_fits(k, hid, fmt, itemsize, itemsize,
                                   jf._mlp_auto_stripes(hid))
    for b in (1, 2, 3, 4, 32):
        cap = -(-b * n_pad // 32) * 32
        assert tf._pick_bm(cap, t_fits) == jf._pick_bm(cap, j_fits)
    assert tf._BLOCK_M_CANDIDATES == jf._BLOCK_M_CANDIDATES


def _jax_block_kernels(jart_blk, b, n_pad, n_real, dim, hd):
    """Names of the Pallas kernels the JAX forward's block traces to at
    batch ``b`` (bf16 residual stream), in order."""
    spec = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
        jart_blk)
    jx = jax.make_jaxpr(lambda x, blk: j_vit_block(
        x, blk, b=b, n_pad=n_pad, n_real=n_real, dim=dim, hd=hd,
        sm_scale=hd**-0.5, use_pallas=True, float_dtype=jnp.bfloat16,
        int_attention=False))(
            jax.ShapeDtypeStruct((b * n_pad, dim), jnp.bfloat16), spec)
    names = []

    def walk(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "pallas_call":
                names.append(e.params["jaxpr"].debug_info.func_name)
            for v in e.params.values():
                inner = getattr(v, "jaxpr", v)
                if hasattr(inner, "eqns"):
                    walk(inner)

    walk(jx.jaxpr)
    return names


_JAX_MLP_KERNEL = {tv.MLP_RESIDENT: "_fused_mlp_kernel",
                   tv.MLP_CHUNKED: "_fused_mlp_chunked_kernel"}


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_forward_mlp_route_matches_jax_block(preset, fmt):
    """For each batch in {1, 2, 3, 32}, the port's MLP route
    (:func:`mlp_route`) is the one the JAX forward's block takes: its
    resident kernel (K2), its chunked kernel (K8), or neither (the chain
    of two K1 launches)."""
    k, hid, n_pad = PRESETS[preset]
    patch = 14 if preset == "vit_h14" else 16
    cfg = JConfig(patch_size=patch, embed_dim=k, depth=1,
                  num_heads=k // (80 if preset == "vit_h14" else 64),
                  num_classes=0)
    blk = j_random(cfg, seed=0, pack_weights=fmt == "int4")["blocks"][0]
    for b in (1, 2, 3, 32):
        route = tv.mlp_route(b * n_pad, k, hid, fmt, itemsize=2)
        names = _jax_block_kernels(blk, b, n_pad, cfg.num_tokens, k,
                                   k // cfg.num_heads)
        mlp = [n for n in names if n.startswith("_fused_mlp")]
        want = [_JAX_MLP_KERNEL[route]] if route != tv.MLP_CHAIN else []
        assert mlp == want, (preset, fmt, b, route, names)


def test_forward_runs_the_route_it_picks(monkeypatch):
    """The kernel path's MLP dispatch (``_run_mlps``) launches the route
    ``mlp_route`` names, K8 at any width."""
    calls = []
    monkeypatch.setattr(tv, "run_mlp", lambda p, x, **kw: calls.append(
        ("fused_mlp", p)) or x)
    monkeypatch.setattr(tv, "run_mlp_chunked", lambda p, x, **kw:
                        calls.append(("fused_mlp_chunked", p)) or x)
    monkeypatch.setattr(tv, "run_matmul", lambda p, x, **kw: calls.append(
        ("fused_quant_matmul", p)) or x)

    def plans(k, hid, fmt, resident="k2", chunked="k8"):
        return tv.MlpPlans(resident=resident, chunked=chunked, fc1="fc1",
                           fc2="fc2", k=k, hid=hid, fmt=fmt, fmt2=fmt)

    x = lambda m, k: torch.zeros((m, k), dtype=torch.bfloat16)  # noqa: E731
    tv._run_mlps(plans(1280, 5120, "int8"), x(272, 1280), torch.bfloat16)
    tv._run_mlps(plans(1280, 5120, "int8"), x(8704, 1280), torch.bfloat16)
    tv._run_mlps(plans(768, 3072, "int4"), x(416, 768), torch.bfloat16)
    assert calls == [("fused_mlp_chunked", "k8"),
                     ("fused_quant_matmul", "fc1"),
                     ("fused_quant_matmul", "fc2"), ("fused_mlp", "k2")]
    # packed int4 at ViT-H/14's width takes K2, which has no width limit
    # (its first design refused K = 1280)
    tv._run_mlps(plans(1280, 5120, "int4"), x(272, 1280), torch.bfloat16)
    assert calls[-1] == ("fused_mlp", "k2")
    # K8 has no width limit: past its first design's K <= 1280 it runs
    tv._run_mlps(plans(1536, 6144, "int8"), x(272, 1536), torch.bfloat16)
    assert calls[-1] == ("fused_mlp_chunked", "k8")
