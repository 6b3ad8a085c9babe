"""Port parity: the analytic cost model (``graph/costs.py:
vit_cost_report``) and the OTO metrics over it (``compute_macs``,
``compute_bops``, ``compute_num_params``, ``compute_weight_size``,
``compute_average_bit_width``) against the JAX package, on the tiny
quantized ViT with per-layer bit widths (``tests/torch_a1_params.py``),
its float twin, and compressed subnets, and UltraNet's report (``ultranet_cost_report``, the
fixed DoReFa bit widths) on its full net and a subnet, exact. Integers
exact. Floats within
1e-12 relative where both packages take a layer's bit width from one
function (``bit_width`` patched in both to the same numpy formula): the
walk, the MAC counts and the sums in Python's float order. With each
package's own ``bit_width`` (f32 exp and log: XLA's and PyTorch's differ
by an ulp, 3.9999995 against 4.0 at one layer here) each bit width
within 2 f32 ulps and the totals within 1e-6 relative."""

import dataclasses

import numpy as np
import pytest
import torch

from quantized_vit_tpu.graph.costs import vit_cost_report as jreport
from quantized_vit_tpu_torch.graph import vit_cost_report

from tests import torch_a1_params as A

torch.set_num_threads(1)

METRICS = ("compute_macs", "compute_bops", "compute_num_params",
           "compute_weight_size", "compute_average_bit_width")


@pytest.fixture(scope="module")
def base():
    return A.jax_params()


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
        return
    if isinstance(b, int) and not isinstance(b, bool):
        assert a == b and isinstance(a, int)
        return
    assert a == pytest.approx(b, rel=1e-12, abs=0.0)


def _trees(base, case):
    jmodel, jp = base
    if case == "trained":
        return jmodel.cfg, jp
    if case == "float_bits":  # 32-bit scalars everywhere
        from quantized_vit_tpu.models import init_quant_params_tree
        return jmodel.cfg, init_quant_params_tree(jp, init_bits=32.0)
    seed, target, div = {"subnet": (A.ODD_SEED, None, 1),
                         "uniform": (1, 0.5, 2)}[case]
    joto, _, jz, _ = A.zeroed(jmodel, jp, seed, target, div)
    jm2, jp2 = joto.construct_subnet(jz)
    return jm2.cfg, jp2


def _port_cfg(jcfg):
    from quantized_vit_tpu_torch.models import ViTConfig

    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name != "quant"}
    return ViTConfig(**kw)


def _np_bit_width(d, q_m, t=None):
    """The bit-width formula in numpy f64 on the f32 scalars (both
    packages' inputs as numpy)."""
    def arr(v):
        return np.asarray(v.detach().cpu().numpy() if isinstance(
            v, torch.Tensor) else v, np.float64)
    t = 1.0 if t is None else arr(t)
    return np.log2(np.abs(arr(q_m)) ** t / np.abs(arr(d)) + 1.0) + 1.0


@pytest.fixture
def shared_bits(monkeypatch):
    import quantized_vit_tpu.quant.bitwidth as jbw
    import quantized_vit_tpu_torch.quant.bitwidth as tbw

    monkeypatch.setattr(jbw, "bit_width", _np_bit_width)
    monkeypatch.setattr(tbw, "bit_width", _np_bit_width)


CASES = ["trained", "float_bits", "subnet", "uniform"]


@pytest.mark.parametrize("case", CASES)
def test_vit_cost_report_equal(base, case, shared_bits):
    jcfg, jp = _trees(base, case)
    want = jreport(jcfg, jp)
    got = vit_cost_report(_port_cfg(jcfg), A.torch_tree(jp))
    _close(got, want)
    assert list(got["per_layer"]) == list(want["per_layer"])


@pytest.mark.parametrize("case", CASES)
def test_vit_cost_report_own_bit_widths(base, case):
    jcfg, jp = _trees(base, case)
    want = jreport(jcfg, jp)
    got = vit_cost_report(_port_cfg(jcfg), A.torch_tree(jp))
    ulp2 = 2 * np.finfo(np.float32).eps
    for layer, w in want["per_layer"].items():
        g = got["per_layer"][layer]
        assert (g["macs"], g["params"]) == (w["macs"], w["params"])
        for k in ("w_bit", "a_bit"):
            assert g[k] == pytest.approx(w[k], rel=ulp2, abs=0.0)
    assert got["num_params"] == want["num_params"]
    for k in ("total_macs", "total_bops", "weight_size_bits",
              "average_bit_width"):
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0.0)


def _ultranet_trees(case):
    from tests import torch_ultranet_params as U

    _, params, stats, _ = U.trained_like(0, batch=1)
    if case == "ultranet":
        return U, params, stats
    joto, _, jz, _ = U.zeroed(params, stats, 2, 0.4, 2)
    _, jp, js = joto.construct_subnet(jz)
    return U, U.numpy_tree(jax_tree_np(jp)), U.numpy_tree(jax_tree_np(js))


def jax_tree_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("case", ["trained", "subnet", "ultranet",
                                  "ultranet_subnet"])
def test_oto_metrics_equal(base, case, shared_bits):
    from quantized_vit_tpu.graph import OTO as JOTO
    from quantized_vit_tpu.models import VisionTransformer as JV
    from quantized_vit_tpu_torch.graph import OTO
    from quantized_vit_tpu_torch.models import VisionTransformer

    if case.startswith("ultranet"):
        from quantized_vit_tpu.graph.costs import ultranet_cost_report as jur
        from quantized_vit_tpu.models import UltraNet as JU
        from quantized_vit_tpu_torch.graph import ultranet_cost_report

        U, params, stats = _ultranet_trees(case)
        tp = U.torch_tree(params)
        want = jur(params)
        _close(ultranet_cost_report(tp), want)
        assert list(ultranet_cost_report(tp)["per_layer"]) == list(
            want["per_layer"])
        joto = JOTO(JU(), params, batch_stats=stats)
        oto = OTO(U.port_model(params, stats), tp)
        for name in METRICS:
            _close(getattr(oto, name)(tp), getattr(joto, name)(params))
        full = ultranet_cost_report(U.torch_tree(
            U.trained_like(0, batch=1)[1]))
        assert (want["total_macs"] < full["total_macs"]) == (
            case == "ultranet_subnet")
        return
    jcfg, jp = _trees(base, case)
    tp = A.torch_tree(jp)
    joto = JOTO(JV(jcfg), jp)
    oto = OTO(VisionTransformer(_port_cfg(jcfg), device="cpu"), tp)
    for name in METRICS:
        _close(getattr(oto, name)(tp), getattr(joto, name)(jp))
    # the report is memoised on the tree object
    assert oto._report(tp) is oto._report(tp)
    assert oto._report(dict(tp)) is not oto._report(tp)


def test_subnet_costs_less(base):
    _, jp = _trees(base, "trained")
    jcfg2, jp2 = _trees(base, "subnet")
    full = vit_cost_report(_port_cfg(base[0].cfg), A.torch_tree(jp))
    sub = vit_cost_report(_port_cfg(jcfg2), A.torch_tree(jp2))
    assert sub["total_macs"] < full["total_macs"]
    assert sub["num_params"] < full["num_params"]

