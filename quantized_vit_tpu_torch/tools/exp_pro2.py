"""K17 on the card: ``tools/exp_pro2.py``'s LayerNorm fc1 with production
features added one at a time (``csrc/fc1_ablation.cu``,
``ops/ablations.py:exp_pro2``), at the root tool's shape (M 7168, K 768,
N 3072), inputs and seed (x N(0, 4) in bf16, g = 20, b = 0, scale 1e-3,
bias N(0, 1e-4), d = 0.05, tops 7):

    python3 -m quantized_vit_tpu_torch.tools.exp_pro2 [mode ...] [--device cpu]

Modes: lean (the scalar scale), vscale (a scale vector), bias, smem and
smem_hoist and smem_unused (the TPU's runtime scalars in SMEM; the card
takes every top as a kernel argument, so smem computes bias's function
and smem_hoist and smem_unused vscale's: the root tool adds the bias in
bias, smem and folded only), folded (K1's LayerNorm + folded quant and
folded GELU-quant forms). Output as ``exp_fc1``'s; the yardstick is
``torch._int_mm`` at the same M, K, N.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ablations as ab
from ._ablation import Mode, Tool, int_mm_yard, main as _main
from .exp_pro import inputs

M, K, N = 7168, 768, 3072
MODES = list(ab.EXP_PRO2_MODES)


def build(dev, modes=MODES, shape=None) -> Tool:
    m, k, n = shape or (M, K, N)
    cuda = dev.type == "cuda"
    rng, x, w, g, b = inputs(dev, m, k, n, False)
    scale = torch.full((n,), 1e-3, device=dev)
    bias = torch.from_numpy((rng.standard_normal((1, n)) * 0.01).astype(
        np.float32)).reshape(n).to(dev)
    out = []
    for mode in modes:
        v = ab.EXP_PRO2_MODES[mode]
        ops = dict(ln_g=g, ln_b=b, scale=scale if v.vscale else ab.SCALE,
                   bias=bias if v.bias else None)
        call = lambda mode=mode: ab.exp_pro2(x, w, g, b, mode, scale=scale,
                                             bias=bias)
        plan = ab.plan_fc1(w, v, m, **ops) if cuda else None
        out.append(Mode(
            mode, call,
            (lambda p=plan: ab.run_fc1(p, x, "exp_pro2")) if cuda else call,
            lambda v=v, o=ops: ab.fc1_ablation_plain(x, w, v, **o),
            bytes=(2 * m * k + k * n + m * n + 8 * k
                   + 4 * n * (int(v.vscale) + int(v.bias))),
            ops=2 * m * k * n, kind="int8"))
    return Tool(out, int_mm_yard([(m, k, n)], dev) if cuda else None,
                "_int_mm")


def main(argv=None, shape=None) -> int:
    return _main("exp_pro2", MODES, build, argv, shape)


if __name__ == "__main__":
    sys.exit(main())
