"""Port parity: the LSFQ quantizers (``quant/lsfq.py``), the bit-width
algebra (``quant/bitwidth.py``) and K7's plain version
(``ops/quant_vjp.py``) against the JAX package.

Inputs come from a numpy seed and go to both packages; the JAX side runs
as its own tests run it on the CPU (the jnp chain, and the Pallas kernel
in interpret mode). Tolerances: grad_x exact (a mask select of g); the
three scalar gradients within rtol 1e-5, atol 1e-5, the bound
``tests/ops/test_quant_vjp.py`` holds the Pallas kernel to against the jnp
chain (the port sums in f64, JAX in f32); forward values equal except
where exp/log of the two libraries differ by an ulp at a rounding tie,
which moves a value by one step ``d`` at no more than 0.5% of positions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.ops.quant_vjp import lsfq_nonlinear_bwd_fused as jk7
from quantized_vit_tpu.quant import bitwidth as jbw
from quantized_vit_tpu.quant import lsfq as jl
from quantized_vit_tpu_torch.ops import quant_vjp as tqv
from quantized_vit_tpu_torch.quant import bitwidth as tbw
from quantized_vit_tpu_torch.quant import lsfq as tl

torch.set_num_threads(1)

CLIP = (-2.0, 2.0)
EDGES = np.array([0.0, 1e-8, 0.5, 1.0, 1.5, 2.0, 2.5, -0.5, -1.0, -2.0,
                  -3.0, 0.99, 1.01, -1e-8, 0.0, 0.0], np.float32)


def _inputs(shape, seed, scale=1.2):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return x, np.cos(x * 3.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _s(v):
    return torch.full((1,), v)


def _steps_close(got, want, d):
    """Equal, except by one step d at <= 0.5% of positions."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max(initial=0) <= d * 1.0001, diff.max()
    assert (diff > 0).mean() <= 0.005, (diff > 0).mean()


def _scalars_close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the four quantizers: forward and every gradient
# ---------------------------------------------------------------------------


CASES = {
    "random": (lambda: _inputs((40, 96), 0), 0.07, 1.1, 1.06),
    "random_t1": (lambda: _inputs((40, 96), 1), 0.04, 0.9, 1.0),
    "edges": (lambda: (np.tile(EDGES, (8, 8)),
                       np.cos(np.tile(EDGES, (8, 8)) * 3.0)), 0.05, 1.0, 1.0),
    "edges_t": (lambda: (np.tile(EDGES, (8, 8)),
                         np.cos(np.tile(EDGES, (8, 8)) * 3.0)), 0.05, 1.0,
                0.93),
}


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nonlinear_forward_and_grads(case, fused):
    make, d, qm, t = CASES[case]
    x, g = make()
    clip = jnp.asarray(CLIP, jnp.float32)
    jy, vjp = jax.vjp(lambda *a: jl.lsfq_nonlinear(*a, clip, 0.0),
                      jnp.asarray(x), jnp.float32(d), jnp.float32(qm),
                      jnp.float32(t))
    jg = vjp(jnp.asarray(g))

    xt = _t(x).requires_grad_()
    ps = [_s(v).requires_grad_() for v in (d, qm, t)]
    if fused:
        y = tl.lsfq_nonlinear_fused(xt, *ps, CLIP[0], CLIP[1], 0.0)
    else:
        y = tl.lsfq_nonlinear(xt, *ps, torch.tensor(CLIP), 0.0)
    y.backward(_t(g))
    _steps_close(y.detach().numpy(), jy, d)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg[0]))
    _scalars_close([p.grad[0] for p in ps], jg[1:])


def test_fused_and_chain_backward_equal_on_cpu():
    """On a CPU tensor the fused quantizer's backward is the plain chain:
    every gradient equal to the non-fused quantizer's."""
    x, g = _inputs((33, 70), 5)
    grads = []
    for fused in (False, True):
        xt = _t(x).requires_grad_()
        ps = [_s(v).requires_grad_() for v in (0.05, 1.0, 0.95)]
        y = (tl.lsfq_nonlinear_fused(xt, *ps, -2.0, 2.0) if fused
             else tl.lsfq_nonlinear(xt, *ps, torch.tensor(CLIP)))
        y.backward(_t(g))
        grads.append([xt.grad] + [p.grad for p in ps])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["random", "edges"])
def test_linear_forward_and_grads(case):
    make, d, qm, _ = CASES[case]
    x, g = make()
    clip = jnp.asarray(CLIP, jnp.float32)
    jy, vjp = jax.vjp(lambda *a: jl.lsfq_linear(*a, clip, 0.0),
                      jnp.asarray(x), jnp.float32(d), jnp.float32(qm))
    jg = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    ps = [_s(v).requires_grad_() for v in (d, qm)]
    y = tl.lsfq_linear(xt, *ps, torch.tensor(CLIP), 0.0)
    y.backward(_t(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg[0]))
    _scalars_close([p.grad[0] for p in ps], jg[1:])


@pytest.mark.parametrize("bits", [4.0, 2.0])
def test_dge_forward_and_grads(bits):
    x, g = _inputs((40, 96), 2)
    d, qm = 0.07, 1.1
    clip = jnp.asarray(CLIP, jnp.float32)
    jy, vjp = jax.vjp(lambda *a: jl.dge(*a, clip, jnp.float32(0.0),
                                        jnp.float32(bits)),
                      jnp.asarray(x), jnp.float32(d), jnp.float32(qm))
    jg = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    ps = [_s(v).requires_grad_() for v in (d, qm)]
    y = tl.dge(xt, *ps, torch.tensor(CLIP), 0.0, bits)
    y.backward(_t(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    # the smooth input gradient goes through pow: an ulp of exp/log
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[0]),
                               rtol=1e-5, atol=1e-7)
    _scalars_close([p.grad[0] for p in ps], jg[1:])


def test_levels_top_level_dequant():
    x, _ = _inputs((64, 48), 3)
    for t in (1.0, 1.07):
        jlv = np.asarray(jl.lsfq_levels(jnp.asarray(x), 0.05, 1.0, t))
        lv = tl.lsfq_levels(_t(x), _s(0.05), _s(1.0), _s(t))
        d = np.abs(lv.numpy() - jlv)
        assert d.max() <= 1 and (d > 0).mean() <= 0.005
        assert int(tl.lsfq_top_level(_s(0.05), _s(1.0), _s(t))[0]) == int(
            jl.lsfq_top_level(0.05, 1.0, t))
        np.testing.assert_array_equal(
            tl.lsfq_dequant(lv, _s(0.05)).numpy(),
            np.asarray(jl.lsfq_dequant(jnp.asarray(lv.numpy()),
                                       jnp.float32(0.05)))[None][0])


def test_bitwidth_algebra():
    x, _ = _inputs((32, 40), 4, 0.5)
    for t in (None, 1.08):
        tt = None if t is None else _s(t)
        for name in ("bit_width", "d_for_bits"):
            a = getattr(tbw, name)(_s(0.02) if name == "bit_width" else 6.0,
                                   _s(0.8), tt)
            b = getattr(jbw, name)(jnp.float32(0.02) if name == "bit_width"
                                   else 6.0, jnp.float32(0.8), t)
            np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(1),
                                       rtol=1e-6)
        for name in ("clip_transform", "quantize_simple"):
            args = (_t(x), _s(0.8), tt) if name == "clip_transform" else (
                _t(x), _s(0.02), _s(0.8), tt)
            jargs = (jnp.asarray(x), jnp.float32(0.8), t) \
                if name == "clip_transform" else (
                    jnp.asarray(x), jnp.float32(0.02), jnp.float32(0.8), t)
            got = getattr(tbw, name)(*args).numpy()
            want = np.asarray(getattr(jbw, name)(*jargs))
            if name == "clip_transform":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            else:
                _steps_close(got, want, 0.02)
        res = tbw.quant_residual(_t(x), _s(0.02), _s(0.8), tt).numpy()
        jres = np.asarray(jbw.quant_residual(jnp.asarray(x), 0.02, 0.8, t))
        # a residual near +-0.5 flips sign at a rounding tie
        assert (np.abs(res - jres) > 1e-5).mean() <= 0.005
    w = _t(x)
    for nonlinear in (False, True):
        got = tbw.init_quant_params(w, 8, nonlinear)
        want = jbw.init_quant_params(jnp.asarray(x), 8, nonlinear)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# K7's plain version against the Pallas kernel (interpret) and the chain
# ---------------------------------------------------------------------------


K7_CASES = {
    "160x256": ((160, 256), 0.07, 1.1, 1.06, 0.0),
    "320x128": ((320, 128), 0.07, 1.1, 1.06, 0.0),
    "7x4x384": ((7, 4, 384), 0.07, 1.1, 1.06, 0.0),
    "edges": (None, 0.05, 1.0, 1.0, 0.0),
    "overlap_qm_le_qs": ((64, 128), 0.02, 0.3, 1.06, 0.5),
}


@pytest.mark.parametrize("oracle", ["pallas_interpret", "jnp_chain"])
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_plain_matches_jax(case, oracle):
    shape, d, qm, t, q_s = K7_CASES[case]
    if shape is None:
        x = np.tile(EDGES, (8, 8))
        g = np.cos(x * 3.0).astype(np.float32)
    else:
        x, g = _inputs(shape, 7, 0.6 if q_s else 1.2)
    if oracle == "pallas_interpret":
        want = jk7(jnp.asarray(x), jnp.asarray(g), jnp.float32(d),
                   jnp.float32(qm), jnp.float32(t), clip_lo=CLIP[0],
                   clip_hi=CLIP[1], q_s=q_s, interpret=True)
    else:
        clip = jnp.asarray(CLIP, jnp.float32)
        want = jl._nonlinear_bwd((jnp.asarray(x), jnp.float32(d),
                                  jnp.float32(qm), jnp.float32(t), clip,
                                  jnp.float32(q_s)), jnp.asarray(g))[:4]
    got = tqv.lsfq_nonlinear_bwd_fused(
        _t(x), _t(g), _s(d), _s(qm), _s(t), clip_lo=CLIP[0],
        clip_hi=CLIP[1], q_s=q_s)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _scalars_close(got[1:], want[1:])


def test_k7_plain_sums_are_f64_sums_of_f32_terms():
    """The plain version's sums are the f32 terms added in f64 and rounded
    once, whatever the tensor's rank (K7's way)."""
    x, g = _inputs((3, 50, 7), 9)
    args = (_t(x), _t(g), _s(0.07), _s(1.1), _s(0.96))
    kw = dict(clip_lo=-2.0, clip_hi=2.0)
    _, *terms = tqv.nonlinear_bwd_terms(*args, **kw)
    got = tqv.lsfq_nonlinear_bwd_plain(*args, **kw)
    for s, term in zip(got[1:], terms):
        want = np.float32(np.sum(term.numpy().astype(np.float64)))
        assert s.dtype == torch.float32 and float(s) == float(want)
    assert tqv.grid_blocks(1) == 1 and tqv.grid_blocks(10**9) == 1024
