"""K19 on the card: K6's attention with J images a thread block, as
``tools/exp_attn2.py`` timed J images a TPU program (``csrc/
attn_ablation.cu``, ``ops/ablations.py:exp_attn2``), at the root tool's
shape (32 images of 224 rows, 197 real tokens, 12 heads of 64, qkv N(0,
0.01) in bf16, d = 0.05, sm_scale 0.125, top 7) and seed:

    python3 -m quantized_vit_tpu_torch.tools.exp_attn2 [J ...] [--device cpu]

J in 1, 2, 4: a block takes the same (query tile, head) item of J images
one after another; J = 1 is K6's grid. Every J computes one function,
K6's (``ops/attention.py:attention_qkv_plain``). Output as
``exp_attn``'s; the yardstick is bf16 ``scaled_dot_product_attention`` at
[32, 12, 224, 64].
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
    nk = ab._n_keys(n, nv, 2)
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
            # q at every row, k and v at the first nk; the int8 levels
            bytes=b * (n + 2 * nk) * h * hd * 2 + b * n * h * hd,
            ops=4 * b * h * n * nk * hd, kind="bf16"))
    return Tool(out, sdpa_yard(b, h, n, hd, dev) if cuda else None,
                "sdpa_bf16")


def main(argv=None, shape=None) -> int:
    return _main("exp_attn2", MODES, build, argv, shape)


if __name__ == "__main__":
    sys.exit(main())
