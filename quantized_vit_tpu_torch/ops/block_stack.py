"""Whole-depth block stack in one launch (kernel K5), for batch-1 latency.

Port of ``quantized_vit_tpu/ops/block_stack.py``. :func:`vit_block_stack`
replaces ``_vit_block_stack`` (``pallas_call`` at block_stack.py:341): the
residual stream ``x [j*n, D]`` through ``depth`` transformer blocks, each
with its own stacked weights and per-layer quantizer scalars, in one
kernel launch (``csrc/block_stack.cu``: a persistent cooperative grid, one
block per SM, with grid-wide barriers between the phases of each
transformer block).

The operands are those of the JAX function: weights stacked along a
leading depth axis ([L, K(/2), N], int8 or packed int4), per-block
scale/bias/LayerNorm rows [L, N] (or [L, 1, N]) and per-layer quantizer
scalars [L]. LN1 gamma/beta carry 1/act_d when ``act_pow`` is False, LN2's
1/mlp_d when ``mlp_pow`` is False, and s1/b1 carry 2**-0.5 when
``hid_pow`` is False: the folds of ``fused.fold_ln``/``fused.fold_gelu``
(``serve/vit_int4.py:prepare_latency_artifact`` applies them). As
elsewhere, a call splits into the layer side made once
(:func:`plan_block_stack`: the weights stacked n-major, the vectors in one
buffer, the scalars on the device) and the launch (:func:`run_block_stack`).

:func:`vit_block_stack_plain` is the plain version the CPU runs and K5 is
held to: a loop over the depth of the per-block plain versions,
:func:`~.attention.attention_block_plain` and
:func:`~.fused.fused_mlp_plain`, fed each block's folded operands from the
plan (``prefolded``: they apply no fold a second time).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import _build
from .attention import (SMEM_LIMIT, _LOG2E, _f32_value,
                        _n_keys, attention_block_plain)
from .fused import _f32, fused_mlp_plain

MAX_D = 1024  # a lane of a row phase keeps D/32 values of a row
MAX_HEAD_DIM = 64  # csrc/block_stack.cu:HDMAX, the attention core's bound
MAX_IMAGES = 4  # j_imgs, as the TPU kernel takes it
_QT = 64  # query rows per attention unit (csrc/block_stack.cu:QT)

# the per-block vectors, in the order of K5's one f32 buffer
_VECS = ("qs", "qb", "l1g", "l1b", "ps", "pb", "l2g", "l2b", "s1", "b1",
         "s2", "b2")
# the per-layer quantizer scalars, the rows of the [8, L] prm array
_SCALARS = ("act_d", "act_t", "out_d", "out_t", "mlp_d", "mlp_t", "hid_d",
            "hid_t")


def stack_kernel_limit(n: Optional[int], d_model: int, hid: int,
                       head_dim: int, itemsize: int = 2,
                       n_valid: Optional[int] = None) -> Optional[str]:
    """Why K5 cannot take this geometry (``n`` token rows per image, None:
    any), or None if it can. The cooperative grid's residency is checked at
    launch (:func:`run_block_stack`)."""
    if head_dim > MAX_HEAD_DIM or head_dim % 8:
        return (f"block_stack kernel: head_dim {head_dim} must be a "
                f"multiple of 8 and <= {MAX_HEAD_DIM}")
    if d_model > MAX_D or d_model % 32 or hid % 32:
        return (f"block_stack kernel: width D={d_model} must be a multiple "
                f"of 32 and <= {MAX_D}, hidden {hid} a multiple of 32 (its "
                "row phases keep a row in registers; 16-byte tile loads)")
    if n is None:
        return None
    nk = _n_keys(n, n if n_valid is None else n_valid, itemsize)
    # csrc/block_stack.cu:smem_bytes: f32 q of one query tile and k/v of
    # the nk key rows
    smem = 4 * ((_QT + nk) * (head_dim + 4) + nk * (head_dim + 8))
    if smem > SMEM_LIMIT:
        return (f"block_stack kernel: {nk} key rows x head_dim {head_dim} "
                f"need {smem} B of shared memory > {SMEM_LIMIT}")
    return None


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """A prepared block stack (:func:`plan_block_stack`): the weights
    stacked n-major ([L, N, K] or packed [L, N, K/2]), the per-block
    vectors as views of one f32 buffer, the [8, L] quantizer scalars, the
    static options."""

    wq_t: torch.Tensor
    wp_t: torch.Tensor
    w1_t: torch.Tensor
    w2_t: torch.Tensor
    vecs: torch.Tensor
    vec: Dict[str, torch.Tensor]
    prm: torch.Tensor
    int4: bool
    depth: int
    d_model: int
    heads: int
    head_dim: int
    hid: int
    sm_scale: float
    q_mul: float
    act_pow: bool
    out_pow: bool
    mlp_pow: bool
    hid_pow: bool
    act_top: int
    out_top: int
    mlp_top: int
    hid_top: int
    ln_eps: float
    # per (rows, key rows, dtype, stream): the grid and the scratch of
    # the launches (run_block_stack)
    launch: Dict[tuple, tuple] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)


def _tops(kw):
    # vit_block_stack (block_stack.py:210-218): positive static tops
    for k in ("act_top", "out_top", "mlp_top", "hid_top"):
        if not (kw.get(k) or 0) >= 1:
            raise ValueError(f"vit_block_stack: positive {k} required")
    return {k: int(kw[k]) for k in ("act_top", "out_top", "mlp_top",
                                    "hid_top")}


def plan_block_stack(wq, qs, qb, ln1_g, ln1_b, wp, ps, pb, ln2_g, ln2_b,
                     w1, s1, b1, w2, s2, b2, act_d, act_t, out_d, out_t,
                     mlp_d, mlp_t, hid_d, hid_t, *, heads, sm_scale,
                     fmt="int4", act_pow=False, out_pow=False, mlp_pow=False,
                     hid_pow=False, act_top=127, out_top=127, mlp_top=127,
                     hid_top=127, ln_eps=1e-6) -> StackPlan:
    """K5's layer-side work, done once: checks, the n-major weight stacks,
    the vectors in one buffer, the scalars on the device. Operands as
    :func:`vit_block_stack`. Works on any device (the plain version runs
    from the plan too)."""
    tops = _tops(dict(act_top=act_top, out_top=out_top, mlp_top=mlp_top,
                      hid_top=hid_top))
    if fmt not in ("int4", "int8"):
        raise ValueError(f"unknown weight format {fmt!r}")
    int4 = fmt == "int4"
    f = 2 if int4 else 1
    depth, d_model, three = wq.shape[0], wq.shape[1] * f, wq.shape[2]
    hid = w1.shape[2]
    if three % (3 * heads):
        raise ValueError(f"w_qkv width {three} does not split into "
                         f"{heads} heads")
    hdim = three // 3
    shapes = {"wp": (tuple(wp.shape), (depth, hdim // f, d_model)),
              "w1": (tuple(w1.shape), (depth, d_model // f, hid)),
              "w2": (tuple(w2.shape), (depth, hid // f, d_model))}
    for name, (got, want) in shapes.items():
        if got != want:
            raise ValueError(f"{name} {got} vs {want} ({fmt})")
    # packed int4 w2 pairs hidden rows h and h + hid/2
    # (block_stack.py:290-297)
    if int4 and (hid % 2 or hdim % 2 or d_model % 2):
        raise ValueError("packed int4 weights need even K widths")
    dev = wq.device
    widths = {"qs": three, "qb": three, "l1g": d_model, "l1b": d_model,
              "ps": d_model, "pb": d_model, "l2g": d_model, "l2b": d_model,
              "s1": hid, "b1": hid, "s2": d_model, "b2": d_model}
    vals = dict(zip(_VECS, (qs, qb, ln1_g, ln1_b, ps, pb, ln2_g, ln2_b, s1,
                            b1, s2, b2)))
    rows = [torch.broadcast_to(_f32(vals[k], dev).reshape(depth, -1),
                               (depth, widths[k])).reshape(-1)
            for k in _VECS]
    vecs = torch.cat(rows)
    vec, off = {}, 0
    for k in _VECS:
        vec[k] = vecs[off:off + depth * widths[k]].reshape(depth, widths[k])
        off += depth * widths[k]
    prm = torch.stack([_f32(v, dev).reshape(depth) for v in (
        act_d, act_t, out_d, out_t, mlp_d, mlp_t, hid_d, hid_t)])
    return StackPlan(
        wq_t=_build.n_major(wq), wp_t=_build.n_major(wp),
        w1_t=_build.n_major(w1), w2_t=_build.n_major(w2), vecs=vecs, vec=vec,
        prm=prm.contiguous(), int4=int4, depth=depth, d_model=d_model,
        heads=int(heads), head_dim=hdim // heads, hid=hid,
        sm_scale=float(sm_scale), q_mul=_f32_value(sm_scale * _LOG2E),
        act_pow=bool(act_pow), out_pow=bool(out_pow),
        mlp_pow=bool(mlp_pow), hid_pow=bool(hid_pow), ln_eps=float(ln_eps),
        **tops)


def _stack_input(plan: StackPlan, x, n_valid, j_imgs):
    """(rows per image, n_valid) of x [j*n, D]; checks the images."""
    if not 1 <= j_imgs <= MAX_IMAGES:
        raise ValueError(f"vit_block_stack: j_imgs {j_imgs} not in "
                         f"1..{MAX_IMAGES}")
    r, d = x.shape
    if d != plan.d_model or r % j_imgs:
        raise ValueError(f"x {tuple(x.shape)} vs {j_imgs} images of width "
                         f"{plan.d_model}")
    n = r // j_imgs
    return n, n if n_valid is None else n_valid


def vit_block_stack_plain(plan: StackPlan, x, *, n_valid=None,
                          out_dtype=torch.bfloat16, j_imgs=1):
    """Plain PyTorch version of K5 on a prepared stack: per block,
    :func:`~.attention.attention_block_plain` then
    :func:`~.fused.fused_mlp_plain` on that block's operands in the plan
    (the weights viewed back to [K(/2), N]; the constants carry the folds
    already, ``prefolded``)."""
    n, n_valid = _stack_input(plan, x, n_valid, j_imgs)
    r, d = x.shape
    fmt = "int4" if plan.int4 else "int8"
    x = x.to(out_dtype)
    for i in range(plan.depth):
        v = {k: t[i] for k, t in plan.vec.items()}
        p = dict(zip(_SCALARS, plan.prm[:, i]))
        x = attention_block_plain(
            x.reshape(j_imgs, n, d), plan.wq_t[i].t(), v["qs"], v["qb"],
            plan.wp_t[i].t(), v["ps"], v["pb"], ln_scale=v["l1g"],
            ln_bias=v["l1b"], ln_eps=plan.ln_eps, heads=plan.heads,
            sm_scale=plan.sm_scale, n_valid=n_valid, act_d=p["act_d"],
            act_t=p["act_t"], act_top=plan.act_top, act_pow=plan.act_pow,
            out_d=p["out_d"], out_t=p["out_t"], out_top=plan.out_top,
            out_pow=plan.out_pow, fmt=fmt, out_dtype=out_dtype,
            prefolded=True).reshape(r, d)
        x = fused_mlp_plain(
            x, plan.w1_t[i].t(), v["s1"], v["b1"], plan.w2_t[i].t(),
            v["s2"], v["b2"], ln_scale=v["l2g"], ln_bias=v["l2b"],
            ln_eps=plan.ln_eps, act_d=p["mlp_d"], act_t=p["mlp_t"],
            act_top=plan.mlp_top, act_pow=plan.mlp_pow, hid_d=p["hid_d"],
            hid_t=p["hid_t"], hid_top=plan.hid_top, hid_pow=plan.hid_pow,
            fmt=fmt, out_dtype=out_dtype, prefolded=True)
    return x


def _library():
    """K5's library, its entry points' C signatures set on first use."""
    lib = _build.library("block_stack")
    if lib.qvt_block_stack.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.qvt_block_stack_grid.argtypes = [I, I]
        lib.qvt_block_stack_grid.restype = I
        lib.qvt_block_stack_scratch_bytes.argtypes = [I, I, I, I, I]
        lib.qvt_block_stack_scratch_bytes.restype = _build.LL
        lib.qvt_block_stack.argtypes = [
            P, P, I, P, P, P, P, I, P, P, P, I, I, I, I, I, I, I, I, I, F, I,
            I, I, I, I, I, I, I, F, I, P]
        lib.qvt_block_stack.restype = I
    return lib


def _launch_setup(plan: StackPlan, x, nk: int):
    """(grid, scratch) of a launch on ``x``: the co-resident grid and the
    scratch buffer, made on the first launch of a shape on a stream and
    kept on the plan (launches on one stream run in order, and the kernel
    zeroes its accumulators itself, so they share one scratch)."""
    stream = _build.stream()
    key = (x.shape[0], nk, x.dtype, stream)
    if key not in plan.launch:
        lib = _library()
        grid = lib.qvt_block_stack_grid(nk, plan.head_dim)
        if grid <= 0:
            raise RuntimeError(
                f"block_stack: the cooperative grid is not co-resident on "
                f"this card (no SM holds a 256-thread block with its shared "
                f"memory for {nk} key rows x head_dim {plan.head_dim}; CUDA "
                f"code {-grid}); K5 needs every block of its grid resident")
        nbytes = lib.qvt_block_stack_scratch_bytes(
            x.shape[0], plan.d_model, plan.heads * plan.head_dim, plan.hid,
            x.element_size())
        plan.launch[key] = (grid, torch.empty((nbytes,), dtype=torch.uint8,
                                              device=x.device))
    return plan.launch[key]


def run_block_stack(plan: StackPlan, x, *, n_valid=None,
                    out_dtype=torch.bfloat16, j_imgs=1):
    """Launches K5 on ``x`` [j*n, D] for a prepared stack (the only place
    that launches it): one cooperative launch for the whole depth.
    Returns the residual stream after the last block, [j*n, D]."""
    _build.require_cuda("block_stack", x, plan.wq_t)
    n, n_valid = _stack_input(plan, x, n_valid, j_imgs)
    item = out_dtype.itemsize
    limit = stack_kernel_limit(n, plan.d_model, plan.hid, plan.head_dim,
                               item, n_valid)
    if limit:
        raise ValueError(limit)
    nk = _n_keys(n, n_valid, item)
    x = x.to(out_dtype).contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    grid, scratch = _launch_setup(plan, x, nk)
    code = _library().qvt_block_stack(
        x.data_ptr(), out.data_ptr(), _build.dtype_code(out_dtype),
        plan.wq_t.data_ptr(), plan.wp_t.data_ptr(), plan.w1_t.data_ptr(),
        plan.w2_t.data_ptr(), int(plan.int4), plan.vecs.data_ptr(),
        plan.prm.data_ptr(), scratch.data_ptr(), plan.depth, j_imgs, n,
        n_valid, nk, plan.d_model, plan.heads, plan.head_dim, plan.hid,
        plan.q_mul, int(plan.act_pow), int(plan.out_pow),
        int(plan.mlp_pow), int(plan.hid_pow), plan.act_top, plan.out_top,
        plan.mlp_top, plan.hid_top, plan.ln_eps, grid, _build.stream())
    _build.check(code, "block_stack")
    _build.count_launch("block_stack")
    return out


def vit_block_stack(x, wq, qs, qb, ln1_g, ln1_b, wp, ps, pb, ln2_g, ln2_b,
                    w1, s1, b1, w2, s2, b2, act_d, act_t, out_d, out_t,
                    mlp_d, mlp_t, hid_d, hid_t, *, heads, sm_scale,
                    n_valid=None, fmt="int4", act_pow=False, out_pow=False,
                    mlp_pow=False, hid_pow=False, act_top=127, out_top=127,
                    mlp_top=127, hid_top=127, ln_eps=1e-6,
                    out_dtype=torch.bfloat16, j_imgs=1):
    """The whole block stack (kernel K5; operands as the JAX
    ``vit_block_stack``, block_stack.py:248-262): x [j_imgs*n, D] token
    rows -> the residual stream after the last block, ``out_dtype``. CPU
    tensors take :func:`vit_block_stack_plain`; CUDA tensors
    :func:`plan_block_stack` then :func:`run_block_stack` (a caller that
    runs the stack repeatedly keeps the plan)."""
    plan = plan_block_stack(
        wq, qs, qb, ln1_g, ln1_b, wp, ps, pb, ln2_g, ln2_b, w1, s1, b1, w2,
        s2, b2, act_d, act_t, out_d, out_t, mlp_d, mlp_t, hid_d, hid_t,
        heads=heads, sm_scale=sm_scale, fmt=fmt, act_pow=act_pow,
        out_pow=out_pow, mlp_pow=mlp_pow, hid_pow=hid_pow, act_top=act_top,
        out_top=out_top, mlp_top=mlp_top, hid_top=hid_top, ln_eps=ln_eps)
    run = dict(n_valid=n_valid, out_dtype=out_dtype, j_imgs=j_imgs)
    if x.device.type == "cpu":
        return vit_block_stack_plain(plan, x, **run)
    return run_block_stack(plan, x, **run)
