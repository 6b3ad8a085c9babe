"""The small networks outside the model families that the automatic
grouping tests trace (``tests/graph/test_autogroups.py``,
``tests/compress/test_auto_subnet.py``), each as the JAX tests' flax
module and as the port's twin built from ``QuantDense``/``QuantConv``/
``BatchNorm`` with the same parameter paths, plus the shared comparisons
of discovered groups, edges and plans."""

import flax.linen as nn
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from quantized_vit_tpu_torch.models import (BatchNorm, QuantConv, QuantDense,
                                            TreeModule)
from quantized_vit_tpu_torch.models.ultranet import max_pool_2x2

# the JAX StemPlan's op names of the port's aten products
JAX_OP = {"convolution": "conv_general_dilated", "mm": "dot_general",
          "addmm": "dot_general", "bmm": "dot_general"}


def content(groups):
    """Ids, entries (path, transform) in order, sizes, prunability."""
    return [(g.id, [(e.path, e.transform.value) for e in g.entries],
             g.num_groups, g.num_heads, g.is_prunable, g.is_auxiliary)
            for g in groups]


def plan_rows(plan, port: bool):
    """A plan as comparable rows, the port's op names as the JAX's."""
    return {k: (v.kernel_path, v.bias_path, v.group_id,
                JAX_OP[v.op] if port else v.op, v.depthwise, v.in_group_id,
                v.in_spatial, v.in_channels) for k, v in plan.items()}


# ---------------------------------------------------------------------------
# flax modules (as the JAX tests define them)
# ---------------------------------------------------------------------------


class JCustomNet(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.Conv(12, (3, 3), name="c1")(x)
        x = nn.relu(x)
        skip = x
        x = nn.Conv(12, (3, 3), name="c2")(x)
        x = nn.relu(x + skip)          # residual
        x = jnp.mean(x, axis=(1, 2))
        x = nn.Dense(24, name="d1")(x)
        x = nn.tanh(x)
        return nn.Dense(4, name="out")(x)


class JEdgeNet(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.Conv(8, (3, 3), name="a")(x)
        x = nn.relu(x)
        x = jnp.mean(x, axis=(1, 2))
        x = nn.Dense(16, name="b")(x)
        return nn.Dense(4, name="c")(nn.tanh(x))


class JLateUnionNet(nn.Module):
    @nn.compact
    def __call__(self, x):
        y0 = nn.relu(nn.Dense(8, name="c0")(x))
        y1 = nn.relu(nn.Dense(8, name="c1")(x))
        aux = jnp.tanh(y1)           # c1's output IS a model output
        merged = nn.relu(y0 + y1)    # ...and c1 merges with c0
        return merged, aux


class JGrayNet(nn.Module):
    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        x = nn.Conv(16, (3, 3), use_bias=False, name="c0")(x)
        x = nn.BatchNorm(use_running_average=deterministic, name="bn0")(x)
        x = nn.relu(x)
        x = jnp.mean(x, axis=(1, 2))
        return nn.Dense(4, name="head")(x)


class JFunkyNet(nn.Module):
    """Not in the zoo: conv->BN->relu, depthwise conv, residual, flatten."""

    w1: int = 8
    w2: int = 8
    d1: int = 12

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Conv(self.w1, (3, 3), name="c1", use_bias=False)(x)
        x = nn.BatchNorm(use_running_average=not train, name="bn1")(x)
        x = nn.relu(x)
        x = nn.Conv(self.w1, (3, 3), feature_group_count=self.w1,
                    name="dw")(x)
        x = nn.relu(x)
        skip = x
        x = nn.Conv(self.w1, (3, 3), name="c2")(x)
        x = nn.relu(x + skip)
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = nn.Conv(self.w2, (3, 3), name="c3")(x)
        x = nn.relu(x)
        x = x.reshape((x.shape[0], -1))
        x = nn.Dense(self.d1, name="fc1")(x)
        x = nn.relu(x)
        return nn.Dense(5, name="head")(x)


# ---------------------------------------------------------------------------
# the port's twins (same paths; NHWC inputs; weights copied in by the
# tests, or held from the trees by apply_variables)
# ---------------------------------------------------------------------------


class CustomNet(TreeModule):
    def __init__(self, width: int = 12, hidden: int = 24, device="cpu"):
        super().__init__()
        self.c1 = QuantConv(3, width, (3, 3), device=device)
        self.c2 = QuantConv(width, width, (3, 3), device=device)
        self.d1 = QuantDense(width, hidden, device=device)
        self.out = QuantDense(hidden, 4, device=device)

    def forward(self, x):
        x = torch.relu(self.c1(x))
        skip = x
        x = torch.relu(self.c2(x) + skip)
        x = torch.mean(x, dim=(1, 2))
        return self.out(torch.tanh(self.d1(x)))


class EdgeNet(TreeModule):
    def __init__(self, device="cpu"):
        super().__init__()
        self.a = QuantConv(3, 8, (3, 3), device=device)
        self.b = QuantDense(8, 16, device=device)
        self.c = QuantDense(16, 4, device=device)

    def forward(self, x):
        x = torch.mean(torch.relu(self.a(x)), dim=(1, 2))
        return self.c(torch.tanh(self.b(x)))


class LateUnionNet(TreeModule):
    def __init__(self, device="cpu"):
        super().__init__()
        self.c0 = QuantDense(4, 8, device=device)
        self.c1 = QuantDense(4, 8, device=device)

    def forward(self, x):
        y0 = torch.relu(self.c0(x))
        y1 = torch.relu(self.c1(x))
        return torch.relu(y0 + y1), torch.tanh(y1)


class GrayNet(TreeModule):
    def __init__(self, device="cpu"):
        super().__init__()
        self.c0 = QuantConv(1, 16, (3, 3), use_bias=False, device=device)
        self.bn0 = BatchNorm(16, device=device)
        self.head = QuantDense(16, 4, device=device)

    def forward(self, x, deterministic: bool = True):
        x = torch.relu(self.bn0(self.c0(x), not deterministic))
        return self.head(torch.mean(x, dim=(1, 2)))


class FunkyNet(TreeModule):
    def __init__(self, w1: int = 8, w2: int = 8, d1: int = 12,
                 hw: int = 8, device="cpu"):
        super().__init__()
        self.c1 = QuantConv(3, w1, (3, 3), use_bias=False, device=device)
        self.bn1 = BatchNorm(w1, device=device)
        self.dw = QuantConv(w1, w1, (3, 3), feature_group_count=w1,
                            device=device)
        self.c2 = QuantConv(w1, w1, (3, 3), device=device)
        self.c3 = QuantConv(w1, w2, (3, 3), device=device)
        self.fc1 = QuantDense((hw // 2) ** 2 * w2, d1, device=device)
        self.head = QuantDense(d1, 5, device=device)

    def forward(self, x, train: bool = False):
        x = torch.relu(self.bn1(self.c1(x), train))
        x = torch.relu(self.dw(x))
        skip = x
        x = torch.relu(self.c2(x) + skip)
        x = max_pool_2x2(x)
        x = torch.relu(self.c3(x))
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        return self.head(x)
