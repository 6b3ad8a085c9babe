"""K20 on the card: fc1 from int8 levels on packed int4 weights with each
of ``tools/exp_epilogue.py``'s epilogue variants (``csrc/
fc1_ablation.cu``, ``ops/ablations.py:exp_epilogue``), at the root tool's
shape (M 1664 = 8 images x 208 rows, K 768, N 3072) and seed:

    python3 -m quantized_vit_tpu_torch.tools.exp_epilogue [mode ...] [--device cpu]

Modes: none, quant_round, quant_magic, gelu10 (``_gelu_f32`` + the magic
add), gelu5 (a five-coefficient erf), gelu_sig, gelu7_split (``_gelu_f32``
+ round). On the card ``quant_magic`` computes ``quant_round``'s function
and ``gelu10`` ``gelu7_split``'s (the add rounds half to even); the
root tool's row split of ``gelu7_split`` and its ``dimension_semantics``
only scheduled the TPU's work. Output as ``exp_fc1``'s; the yardstick is
``torch._int_mm`` at the same M, K, N on int8 weights.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ablations as ab
from ..quant import pack_int4
from ._ablation import Mode, Tool, int_mm_yard, main as _main

M, K, N = 1664, 768, 3072
MODES = list(ab.EXP_EPILOGUE_MODES)
LIBRARY_MODES = {"gelu_sig"}  # expf: the levels contract on the card


def build(dev, modes=MODES, shape=None) -> Tool:
    m, k, n = shape or (M, K, N)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-7, 8, (m, k)).astype(np.int8)).to(dev)
    wp = pack_int4(torch.from_numpy(
        rng.integers(-7, 8, (k, n)).astype(np.int8)), axis=0).to(dev)
    cuda = dev.type == "cuda"
    out = []
    for mode in modes:
        v = ab.EXP_EPILOGUE_MODES[mode]
        call = lambda mode=mode: ab.exp_epilogue(x, wp, mode)
        plan = ab.plan_fc1(wp, v, m, fmt="int4") if cuda else None
        out.append(Mode(
            mode, call,
            (lambda p=plan: ab.run_fc1(p, x, "exp_epilogue")) if cuda
            else call,
            lambda v=v: ab.fc1_ablation_plain(x, wp, v, fmt="int4"),
            bytes=m * k + k * n // 2 + m * n, ops=2 * m * k * n,
            kind="int8", levels=mode in LIBRARY_MODES))
    return Tool(out, int_mm_yard([(m, k, n)], dev) if cuda else None,
                "_int_mm")


def main(argv=None, shape=None) -> int:
    return _main("exp_epilogue", MODES, build, argv, shape)


if __name__ == "__main__":
    sys.exit(main())
