"""Port parity: the repository's six timing ablations (kernels K16-K21,
``quantized_vit_tpu_torch/ops/ablations.py``) against the root tools'
Pallas kernels.

Each case imports the root tool (``tools/exp_*.py``), shrinks the module
constants its kernel body reads, runs that body under
``pl.pallas_call(..., interpret=True)`` with the tool's own block shapes at
that size, and feeds the same seeded numpy inputs to the port's plain
version on the CPU.

Tolerance. Equal at every position, except at a rounding tie: where the
value before the final rounding (the port's, in f32) lies within
``TIE`` of a half-integer, the level may differ by one. Ties are common
at the tools' constants: scale 1e-3 times 1/d = 20 puts ``acc * 1e-3 *
20`` exactly on k + 1/2 whenever acc = 25 (mod 50), and the JAX package
sums and contracts in its own order (f32 sums, multiply-adds), the port
in f64 rounded once with separate roundings. The modes through a library
transcendental or bf16 arithmetic (tanh, sigmoid, exp, the bf16 erf, the
approximate reciprocal) hold within the same window: none needs a wider
one on these inputs.

The "magic" rounding ``(v + 1.5 * 2**23) - 1.5 * 2**23`` is folded to
``v`` by XLA on the CPU (even with fast math off), so there the int8 cast
truncates where the TPU rounds half to even (|v| < 2**22). The port
keeps the add and the subtract (round half to even, as the TPU), and the
tests hold the magic modes to the TPU's function: ``exp_fc1``'s through
the tool's own ``_magic_round`` replaced by ``jnp.round``; ``exp_epilogue``'s
inline ones against the tool's round twin (``quant_magic`` against
``quant_round``, ``gelu10`` against ``gelu7_split``), and for ``gelu5`` and
``gelu_sig``, which have no twin, the JAX output must be the truncation of
the port's value before rounding and the port's output its rounding.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from quantized_vit_tpu.ops.attention import attention_qkv as j_attention_qkv
from quantized_vit_tpu.quant.packing import pack_int4 as jpack
from quantized_vit_tpu_torch.ops import ablations as ab
from quantized_vit_tpu_torch.ops import attention as ta
from tools import exp_attn as r_attn
from tools import exp_attn2 as r_attn2
from tools import exp_epilogue as r_epi
from tools import exp_fc1 as r_fc1
from tools import exp_pro as r_pro
from tools import exp_pro2 as r_pro2

torch.set_num_threads(1)

# the fc1 tools' shrunk shapes (N / 4 column stripes, BM / 4 row blocks;
# K even for the packed int4 weights)
M, K, N, BM = 64, 64, 256, 32
# exp_attn at 224 query rows and 208 keys, as the tool's mask (columns
# below 197) needs; fewer images, heads and head width
A_B, A_N, A_NK, A_H, A_HD = 2, 224, 208, 2, 16
# exp_attn2: 4 images of 32 tokens, 27 real, 2 heads of 16
Q_B, Q_N, Q_NV, Q_H, Q_HD = 4, 32, 27, 2, 16

TIE = 1e-5


def _shrink_fc1(monkeypatch, mod):
    for name, v in (("M", M), ("K", K), ("N", N), ("BM", BM)):
        monkeypatch.setattr(mod, name, v)


def _held(got, want, pre, ties="half"):
    """got (JAX) equals want (the port) except at a tie of ``pre`` (the
    port's value before rounding: ``half`` for rounding, ``int`` for
    truncation), where they may differ by one level."""
    got = np.asarray(got, np.int32)
    want = np.asarray(want.numpy(), np.int32)
    pre = np.asarray(pre.double().numpy())
    assert got.shape == want.shape
    frac = pre - np.floor(pre)
    tie = (np.abs(frac - 0.5) < TIE if ties == "half"
           else np.minimum(frac, 1.0 - frac) < TIE)
    d = np.abs(got - want)
    assert d.max(initial=0) <= 1, f"max level diff {d.max()}"
    off = (d > 0) & ~tie
    assert not off.any(), (
        f"{off.sum()} positions differ off a tie; pre there "
        f"{pre[off][:4]}, jax {got[off][:4]}, port {want[off][:4]}")


def _call(kernel, in_specs, out_shape, grid, operands, scratch=()):
    f = pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs,
        out_specs=pl.BlockSpec(out_shape[1], out_shape[2]),
        out_shape=jax.ShapeDtypeStruct(out_shape[0], jnp.int8),
        scratch_shapes=list(scratch), interpret=True)
    return np.asarray(f(*operands))


def _fc1_inputs(float_x):
    """The tools' inputs: x (bf16 N(0, 4) or int8 levels), w int8 [K, N]."""
    rng = np.random.default_rng(0)
    if float_x:
        x = rng.standard_normal((M, K)) * 2.0
    else:
        x = rng.integers(-7, 8, (M, K)).astype(np.int8)
    w = rng.integers(-7, 8, (K, N)).astype(np.int8)
    return rng, x, w


def _bf16(a):
    """numpy -> (jax bf16, torch bf16) with the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# K21: exp_fc1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(ab.EXP_FC1_MODES))
def test_exp_fc1_against_pallas(mode, monkeypatch):
    _shrink_fc1(monkeypatch, r_fc1)
    # XLA on the CPU folds the tool's magic add away; on the TPU it rounds
    # half to even, which jnp.round is for |v| < 2**22 (asserted below)
    monkeypatch.setattr(r_fc1, "_magic_round", jnp.round)
    _, x, w = _fc1_inputs(False)
    got = _call(functools.partial(r_fc1.kernel, mode=mode),
                [pl.BlockSpec((BM, K), lambda i: (i, 0)),
                 pl.BlockSpec((K, N), lambda i: (0, 0))],
                ((M, N), (BM, N), lambda i: (i, 0)), (M // BM,),
                [jnp.asarray(x), jnp.asarray(w)])
    out, pre = ab.fc1_ablation_plain(
        torch.from_numpy(x), torch.from_numpy(w), ab.EXP_FC1_MODES[mode],
        with_pre=True)
    assert float(pre.abs().max()) < 2.0**22
    assert torch.equal(ab.exp_fc1(torch.from_numpy(x), torch.from_numpy(w),
                                  mode), out)
    _held(got, out, pre, ties="int" if mode == "none" else "half")


# ---------------------------------------------------------------------------
# K16: exp_pro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(ab.EXP_PRO_MODES))
def test_exp_pro_against_pallas(mode, monkeypatch):
    _shrink_fc1(monkeypatch, r_pro)
    _, x, w = _fc1_inputs(mode != "int8_in")
    if mode == "int8_in":
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        jx, tx = _bf16(x)
    g = np.full((1, K), 20.0, np.float32)
    b = np.zeros((1, K), np.float32)
    vm = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    got = _call(functools.partial(r_pro.kernel, mode=mode),
                [pl.BlockSpec((BM, K), lambda i: (i, 0)), vm((K, N)),
                 vm((1, K)), vm((1, K))],
                ((M, N), (BM, N), lambda i: (i, 0)), (M // BM,),
                [jx, jnp.asarray(w), jnp.asarray(g), jnp.asarray(b)])
    tw, tg, tb = (torch.from_numpy(a) for a in (w, g, b))
    out, pre = ab.fc1_ablation_plain(tx, tw, ab.EXP_PRO_MODES[mode],
                                     ln_g=tg, ln_b=tb, with_pre=True)
    assert torch.equal(ab.exp_pro(tx, tw, tg, tb, mode), out)
    _held(got, out, pre)


# ---------------------------------------------------------------------------
# K17: exp_pro2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(ab.EXP_PRO2_MODES))
def test_exp_pro2_against_pallas(mode, monkeypatch):
    _shrink_fc1(monkeypatch, r_pro2)
    rng, x, w = _fc1_inputs(True)
    jx, tx = _bf16(x)
    g = np.full((1, K), 20.0, np.float32)
    b = np.zeros((1, K), np.float32)
    scale = np.full((1, N), 1e-3, np.float32)
    bias = (rng.standard_normal((1, N)) * 0.01).astype(np.float32)
    vm = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    in_specs = [pl.BlockSpec((BM, K), lambda i: (i, 0)), vm((K, N)),
                vm((1, K)), vm((1, K))]
    operands = [jx, jnp.asarray(w), jnp.asarray(g), jnp.asarray(b)]
    smem_modes = r_pro2._SMEM_MODES
    if mode in ("vscale", "bias") + smem_modes:
        in_specs.append(vm((1, N)))
        operands.append(jnp.asarray(scale))
    if mode in ("bias",) + smem_modes:
        in_specs.append(vm((1, N)))
        operands.append(jnp.asarray(bias))
    if mode in smem_modes:
        in_specs += [pl.BlockSpec(memory_space=pltpu.SMEM)] * 4
        operands += [jnp.full((1,), 0.05, jnp.float32),
                     jnp.full((1,), 7, jnp.int32),
                     jnp.full((1,), 0.05, jnp.float32),
                     jnp.full((1,), 7, jnp.int32)]
    got = _call(functools.partial(r_pro2.kernel, mode=mode), in_specs,
                ((M, N), (BM, N), lambda i: (i, 0)), (M // BM,), operands)
    v = ab.EXP_PRO2_MODES[mode]
    tw, tg, tb = (torch.from_numpy(a) for a in (w, g, b))
    tscale, tbias = torch.from_numpy(scale), torch.from_numpy(bias)
    out, pre = ab.fc1_ablation_plain(
        tx, tw, v, scale=tscale if v.vscale else ab.SCALE,
        bias=tbias if v.bias else None, ln_g=tg, ln_b=tb, with_pre=True)
    assert torch.equal(ab.exp_pro2(tx, tw, tg, tb, mode, scale=tscale,
                                   bias=tbias), out)
    _held(got, out, pre)


# ---------------------------------------------------------------------------
# K20: exp_epilogue
# ---------------------------------------------------------------------------

# the modes XLA's fold of the magic add changes on the CPU: the twin that
# rounds with jnp.round instead (the same function on the TPU), or None
# where the tool has no twin
_EPI_TWIN = {"quant_magic": "quant_round", "gelu10": "gelu7_split",
             "gelu5": None, "gelu_sig": None}


def _epi_pallas(mode, x, wp):
    return _call(functools.partial(r_epi.variant_kernel, mode=mode),
                 [pl.BlockSpec((BM, K), lambda i: (i, 0)),
                  pl.BlockSpec((K // 2, N), lambda i: (0, 0))],
                 ((M, N), (BM, N), lambda i: (i, 0)), (M // BM,),
                 [jnp.asarray(x), wp],
                 scratch=[pltpu.VMEM((K // 2, N), jnp.int8),
                          pltpu.VMEM((K // 2, N), jnp.int8)])


@pytest.mark.parametrize("mode", list(ab.EXP_EPILOGUE_MODES))
def test_exp_epilogue_against_pallas(mode, monkeypatch):
    _shrink_fc1(monkeypatch, r_epi)
    _, x, w = _fc1_inputs(False)
    wp = jpack(jnp.asarray(w), axis=0)
    tx, twp = torch.from_numpy(x), torch.from_numpy(np.asarray(wp))
    out, pre = ab.fc1_ablation_plain(tx, twp, ab.EXP_EPILOGUE_MODES[mode],
                                     fmt="int4", with_pre=True)
    assert float(pre.abs().max()) < 2.0**22
    assert torch.equal(ab.exp_epilogue(tx, twp, mode), out)
    if mode in _EPI_TWIN and _EPI_TWIN[mode] is None:
        # XLA's fold leaves the int8 cast of pre: truncation (ties at the
        # integers); the port rounds pre half to even
        got = _epi_pallas(mode, x, wp)
        trunc = torch.clamp(torch.trunc(pre), -7, 7).to(torch.int8)
        _held(got, trunc, pre, ties="int")
        assert torch.equal(out, torch.clamp(torch.round(pre), -7, 7).to(
            torch.int8))
        return
    got = _epi_pallas(_EPI_TWIN.get(mode, mode), x, wp)
    _held(got, out, pre, ties="int" if mode == "none" else "half")


# ---------------------------------------------------------------------------
# K18: exp_attn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(ab.EXP_ATTN_MODES))
def test_exp_attn_against_pallas(mode, monkeypatch):
    for name, v in (("B", A_B), ("N", A_N), ("NK", A_NK), ("H", A_H),
                    ("HD", A_HD), ("HDIM", A_H * A_HD)):
        monkeypatch.setattr(r_attn, name, v)
    rng = np.random.default_rng(0)
    jx, tx = _bf16(rng.standard_normal((A_B, A_N, 3 * A_H * A_HD)) * 0.1)
    kfn = r_attn.kernel_v2 if mode in ("mxu_sum", "transposed") else (
        r_attn.kernel)
    got = _call(functools.partial(kfn, mode=mode),
                [pl.BlockSpec((1, A_N, 3 * A_H * A_HD), lambda i: (i, 0, 0))],
                ((A_B, A_N, A_H * A_HD), (1, A_N, A_H * A_HD),
                 lambda i: (i, 0, 0)), (A_B,), [jx])
    out, pre = ab.exp_attn_plain(tx, mode, heads=A_H, n_keys=A_NK,
                                 with_pre=True)
    assert torch.equal(ab.exp_attn(tx, mode, heads=A_H, n_keys=A_NK), out)
    _held(got, out, pre)


# ---------------------------------------------------------------------------
# K19: exp_attn2
# ---------------------------------------------------------------------------


def _attn2_inputs():
    rng = np.random.default_rng(0)
    return _bf16(rng.standard_normal((Q_B, Q_N, 3 * Q_H * Q_HD)) * 0.1)


def _attn2_pre(tqkv, d):
    """The port's value before rounding, o_un * (1 / (p_sum * d)), from
    its attention helpers, head by head."""
    nk = ta._n_keys(Q_N, Q_NV, 2)
    x = tqkv.reshape(Q_B, Q_N, 3, Q_H, Q_HD)
    col = torch.arange(nk)
    pre = torch.empty((Q_B, Q_N, Q_H, Q_HD))
    for b in range(Q_B):
        for h in range(Q_H):
            s = ta._score_one_head(x[b, :, 0, h], x[b, :nk, 1, h], 0.125,
                                   False)
            o_un, p_sum = ta._softmax_av(s, x[b, :nk, 2, h], col, Q_NV,
                                         False)
            pre[b, :, h] = o_un * (1.0 / (p_sum * d))
    return pre.reshape(Q_B, Q_N, Q_H * Q_HD)


@pytest.mark.parametrize("j_imgs", ab.EXP_ATTN2_J)
def test_exp_attn2_against_pallas(j_imgs, monkeypatch):
    for name, v in (("B", Q_B), ("N", Q_N), ("H", Q_H), ("HD", Q_HD),
                    ("NV", Q_NV)):
        monkeypatch.setattr(r_attn2, name, v)
    jqkv, tqkv = _attn2_inputs()
    w = 3 * Q_H * Q_HD
    got = _call(functools.partial(r_attn2.kernel, j_imgs=j_imgs, heads=Q_H,
                                  head_dim=Q_HD, sm_scale=0.125,
                                  n_valid=Q_NV, out_top=7),
                [pl.BlockSpec((j_imgs, Q_N, w), lambda i: (i, 0, 0)),
                 pl.BlockSpec(memory_space=pltpu.SMEM)],
                ((Q_B, Q_N, Q_H * Q_HD), (j_imgs, Q_N, Q_H * Q_HD),
                 lambda i: (i, 0, 0)), (Q_B // j_imgs,),
                [jqkv, jnp.full((1,), 0.05, jnp.float32)])
    out = ab.exp_attn2_plain(tqkv, 0.05, heads=Q_H, n_valid=Q_NV)
    assert torch.equal(ab.exp_attn2(tqkv, 0.05, j_imgs=j_imgs, heads=Q_H,
                                    n_valid=Q_NV), out)
    _held(got, out, _attn2_pre(tqkv, 0.05))


def test_exp_attn2_plain_is_the_jax_attention_qkv():
    """exp_attn2's function is K6's: the JAX package's attention_qkv
    kernel in interpret mode, on the same inputs."""
    jqkv, tqkv = _attn2_inputs()
    got = j_attention_qkv(jqkv, heads=Q_H, sm_scale=0.125, n_valid=Q_NV,
                          out_d=jnp.float32(0.05), out_t=jnp.float32(1.0),
                          out_top=7, interpret=True)
    out = ab.exp_attn2_plain(tqkv, 0.05, heads=Q_H, n_valid=Q_NV)
    _held(got, out, _attn2_pre(tqkv, 0.05))


# ---------------------------------------------------------------------------
# the wrappers' devices
# ---------------------------------------------------------------------------


def _never(*a, **k):
    raise AssertionError("a non-CPU tensor reached the plain version")


@pytest.mark.parametrize("tool", ["exp_fc1", "exp_pro", "exp_pro2",
                                  "exp_epilogue", "exp_attn", "exp_attn2"])
def test_wrappers_never_reach_plain_for_non_cpu_tensors(tool, monkeypatch):
    """Given a tensor off the CPU (a ``meta`` tensor stands in for a CUDA
    one), each wrapper raises before any plain version runs."""
    for name in ("fc1_ablation_plain", "exp_attn_plain", "exp_attn2_plain",
                 "fc1_prologue_plain", "fc1_epilogue_plain"):
        monkeypatch.setattr(ab, name, _never)
    meta = lambda *s, dt=torch.int8: torch.empty(s, dtype=dt, device="meta")
    calls = {
        "exp_fc1": lambda: ab.exp_fc1(meta(M, K), meta(K, N), "gelu_erf"),
        "exp_pro": lambda: ab.exp_pro(meta(M, K, dt=torch.bfloat16),
                                      meta(K, N), meta(K, dt=torch.float32),
                                      meta(K, dt=torch.float32), "ln_quant"),
        "exp_pro2": lambda: ab.exp_pro2(
            meta(M, K, dt=torch.bfloat16), meta(K, N),
            meta(K, dt=torch.float32), meta(K, dt=torch.float32), "folded",
            scale=meta(N, dt=torch.float32), bias=meta(N, dt=torch.float32)),
        "exp_epilogue": lambda: ab.exp_epilogue(meta(M, K), meta(K // 2, N),
                                                "gelu10"),
        "exp_attn": lambda: ab.exp_attn(
            meta(A_B, A_N, 3 * A_H * A_HD, dt=torch.bfloat16), "full",
            heads=A_H, n_keys=A_NK),
        "exp_attn2": lambda: ab.exp_attn2(
            meta(Q_B, Q_N, 3 * Q_H * Q_HD, dt=torch.bfloat16), 0.05,
            j_imgs=2, heads=Q_H, n_valid=Q_NV),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[tool]()


def test_modes_cover_every_tool_mode():
    """Every mode each root tool's kernel body accepts has a port."""
    assert set(ab.EXP_FC1_MODES) == {"none", "round", "magic", "gelu_erf",
                                     "gelu_magic", "gelu_tanh", "gelu_sig",
                                     "gelu_bf16"}
    assert set(ab.EXP_PRO_MODES) == {"int8_in", "quant", "noln_f32",
                                     "ln_quant", "ln_quant_r2", "ln_sub"}
    assert set(ab.EXP_PRO2_MODES) == {"lean", "vscale", "bias"} | set(
        r_pro2._SMEM_MODES)
    assert set(ab.EXP_EPILOGUE_MODES) == {"none", "quant_round",
                                          "quant_magic", "gelu10", "gelu5",
                                          "gelu_sig", "gelu7_split"}
    for v in (*ab.EXP_FC1_MODES.values(), *ab.EXP_PRO_MODES.values(),
              *ab.EXP_PRO2_MODES.values(), *ab.EXP_EPILOGUE_MODES.values()):
        assert (v.prologue, v.epilogue) in ab.FC1_BUILT


# the six port tools at small shapes (exp_attn keeps the mask's 224 rows)
_TOOL_SHAPES = {"exp_pro": (M, K, N), "exp_pro2": (M, K, N),
                "exp_epilogue": (M, K, N), "exp_fc1": (M, K, N),
                "exp_attn": (A_B, A_N, A_NK, A_H, A_HD),
                "exp_attn2": (Q_B, Q_N, Q_H, Q_HD, Q_NV)}


@pytest.mark.parametrize("tool", list(_TOOL_SHAPES))
def test_tools_run_on_cpu_and_need_a_card_by_default(tool, capsys):
    """Each tool's command line: ``--device cpu`` runs every mode's
    plain version (parity trivially equal, nothing timed); with no
    device it asks for the card and raises without one."""
    mod = importlib.import_module(f"quantized_vit_tpu_torch.tools.{tool}")
    assert mod.main(["--device", "cpu"], shape=_TOOL_SHAPES[tool]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(f"{tool} " in ln and "parity max 0" in ln
               for ln in lines) == len(mod.MODES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])
