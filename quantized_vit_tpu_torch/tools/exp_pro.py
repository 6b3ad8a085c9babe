"""K16 on the card: fc1 with each of ``tools/exp_pro.py``'s prologue
variants, then the erf-GELU quant epilogue (``csrc/fc1_ablation.cu``,
``ops/ablations.py:exp_pro``), at the root tool's shape (M 7168, K 768, N
3072), inputs and seed (x N(0, 4) in bf16, or int8 levels for
``int8_in``; g = 20, b = 0):

    python3 -m quantized_vit_tpu_torch.tools.exp_pro [mode ...] [--device cpu]

Modes: int8_in (levels read in place), quant and noln_f32 (round and clip
x: one function), ln_quant, ln_quant_r2 and ln_sub (the two-moment
LayerNorm, then round and clip: one function; the root tool's row chunks
only scheduled the TPU's work). Output as ``exp_fc1``'s; the yardstick is
``torch._int_mm`` at the same M, K, N (the GEMM alone).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ablations as ab
from ._ablation import Mode, Tool, int_mm_yard, main as _main

M, K, N = 7168, 768, 3072
MODES = list(ab.EXP_PRO_MODES)


def inputs(dev, m, k, n, levels):
    """The root tool's inputs from seed 0: x (int8 levels, or N(0, 4) in
    bf16), w int8 [K, N], g = 20, b = 0 [K]."""
    rng = np.random.default_rng(0)
    x = (torch.from_numpy(rng.integers(-7, 8, (m, k)).astype(np.int8))
         if levels else
         torch.from_numpy(rng.standard_normal((m, k)) * 2.0).to(
             torch.bfloat16))
    w = torch.from_numpy(rng.integers(-7, 8, (k, n)).astype(np.int8))
    g = torch.full((k,), 20.0)
    b = torch.zeros((k,))
    return rng, *(t.to(dev) for t in (x, w, g, b))


def build(dev, modes=MODES, shape=None) -> Tool:
    m, k, n = shape or (M, K, N)
    cuda = dev.type == "cuda"
    sets = {lv: inputs(dev, m, k, n, lv)[1:] for lv in (True, False)}
    out = []
    for mode in modes:
        v = ab.EXP_PRO_MODES[mode]
        lv = mode == "int8_in"
        x, w, g, b = sets[lv]
        call = lambda mode=mode, x=x, w=w, g=g, b=b: ab.exp_pro(x, w, g, b,
                                                                 mode)
        plan = ab.plan_fc1(w, v, m, ln_g=g, ln_b=b) if cuda else None
        out.append(Mode(
            mode, call,
            (lambda p=plan, x=x: ab.run_fc1(p, x, "exp_pro")) if cuda
            else call,
            lambda v=v, x=x, w=w, g=g, b=b: ab.fc1_ablation_plain(
                x, w, v, ln_g=g, ln_b=b),
            bytes=x.numel() * x.element_size() + k * n + m * n + 8 * k,
            ops=2 * m * k * n, kind="int8"))
    return Tool(out, int_mm_yard([(m, k, n)], dev) if cuda else None,
                "_int_mm")


def main(argv=None, shape=None) -> int:
    return _main("exp_pro", MODES, build, argv, shape)


if __name__ == "__main__":
    sys.exit(main())
