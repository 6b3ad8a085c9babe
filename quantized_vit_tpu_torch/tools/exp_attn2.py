"""K19 on the card: K6's attention with J images a thread block, as
``tools/exp_attn2.py`` timed J images a TPU program (``csrc/
attn_ablation.cu``, ``ops/ablations.py:exp_attn2``), at the root tool's
shape (32 images of 224 rows, 197 real tokens, 12 heads of 64, qkv N(0,
0.01) in bf16, d = 0.05, sm_scale 0.125, top 7) and seed:

    python3 -m quantized_vit_tpu_torch.tools.exp_attn2 [J ...] [--device cpu]

J in 1, 2, 4: a block takes its share of the query tiles of J images of
one head, one image after another (the grid has min(J, query tiles)
shares, so every J gives 384 blocks at the tool's shape); each image's K
and V are read once a block, through a TMA-fed ring, and a warp streams
a 16-row query tile over the keys on the FP64 tensor cores. Every J
computes one function, K6's (``ops/attention.py:attention_qkv_plain``).
Output as ``exp_attn``'s; the yardstick is bf16
``scaled_dot_product_attention`` at [32, 12, 224, 64]. CPU tests of the
kernel's maps and order: ``tests/test_torch_attn2_layout.py``; its edge
shapes on the card: ``chip_smoke.py`` phase 3d (``EXP_ATTN2_EDGES``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ablations as ab
from ._ablation import Mode, Tool, main as _main, sdpa_yard

B, N, H, HD, NV = 32, 224, 12, 64, 197
MODES = [str(j) for j in ab.EXP_ATTN2_J]


def build(dev, modes=MODES, shape=None) -> Tool:
    b, n, h, hd, nv = shape or (B, N, H, HD, NV)
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * hd)) * 0.1).to(
        torch.bfloat16).to(dev)
    kw = dict(heads=h, n_valid=nv)
    cuda = dev.type == "cuda"
    plan = ab.plan_exp_attn2(dev, 0.05, h) if cuda else None
    out = []
    for mode in modes:
        call = lambda j=int(mode): ab.exp_attn2(qkv, 0.05, j_imgs=j, **kw)
        out.append(Mode(
            mode, call,
            (lambda j=int(mode): ab.run_exp_attn2(plan, qkv, j_imgs=j,
                                                  n_valid=nv))
            if cuda else call,
            lambda: ab.exp_attn2_plain(qkv, 0.05, **kw),
            # q at every row, k and v at the nv real keys (the masked
            # ones add nothing, and the kernel reads them only up to its
            # last 8-key tile); the int8 levels
            bytes=b * (n + 2 * nv) * h * hd * 2 + b * n * h * hd,
            ops=4 * b * h * n * nv * hd, kind="bf16"))
    return Tool(out, sdpa_yard(b, h, n, hd, dev) if cuda else None,
                "sdpa_bf16")


def main(argv=None, shape=None) -> int:
    return _main("exp_attn2", MODES, build, argv, shape)


if __name__ == "__main__":
    sys.exit(main())
