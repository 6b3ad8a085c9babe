"""Port parity: the integer export (``serve/vit_int4.py:_export_layer``,
``export_vit_int4``) against the JAX package, on the tiny quantized ViT
with per-layer bit widths and on its compressed subnets
(``tests/torch_a1_params.py``): every layer's levels (packed int4 or
int8), ``scale``, ``bias``, ``act``, ``fmt``, ``top`` and ``act_pow``
bit-identical, packed and unpacked, including a layer trained above 8
bits (requantized to 8, with a warning), a 6-bit layer (int8 storage)
and a pruned fc2 of odd depth (int8 beside an int4 fc1). The saved
artifact loads in both packages; the exported subnet's plain-path logits
equal the JAX XLA forward's within 1e-4 (the parity contract of
``tests/test_torch_vit_int4.py``); the latency entry refuses a
non-uniform subnet in both packages and takes a uniform one. UltraNet's
integer tables (``artifact/ultranet.py:export_ultranet_int``) on its full
net and on a subnet: ``inc``, ``bias`` and the last bias bit-equal, the
weight levels equal off rounding ties (tanh differs by ulps)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu.artifact import load_vit_int4_artifact as jload
from quantized_vit_tpu.artifact import save_vit_int4_artifact as jsave
from quantized_vit_tpu.serve import export_vit_int4 as jexport
from quantized_vit_tpu.serve import prepare_latency_artifact as jlatency
from quantized_vit_tpu.serve import vit_int4_forward as jforward
from quantized_vit_tpu_torch.artifact import (load_vit_int4_artifact,
                                              save_vit_int4_artifact)
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.serve import (export_vit_int4,
                                           prepare_latency_artifact,
                                           vit_int4_forward,
                                           vit_int4_forward_latency)

from tests import torch_a1_params as A

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def base():
    return A.jax_params()


def _case(base, case):
    """(JAX cfg, JAX params, port cfg, port params) of a case."""
    jmodel, jp = base
    if case != "full":
        seed, target, div = {"subnet": (A.ODD_SEED, None, 1),
                             "uniform": (1, 0.5, 2)}[case]
        joto, oto, jz, tz = A.zeroed(jmodel, jp, seed, target, div)
        jm2, jp2 = joto.construct_subnet(jz)
        m2, tp2 = oto.construct_subnet(tz)
        return jm2.cfg, jp2, m2.cfg, tp2
    return jmodel.cfg, jp, ViTConfig(**A.TINY), A.torch_tree(jp)


def _export_both(base, case, pack):
    jcfg, jp, cfg, tp = _case(base, case)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jexport(jcfg, jp, pack_weights=pack)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = export_vit_int4(cfg, tp, pack_weights=pack)
    return (jcfg, want, [str(w.message) for w in jw]), (
        cfg, got, [str(w.message) for w in tw])


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("case", ["full", "subnet", "uniform"])
def test_export_bit_identical(base, case, pack):
    (_, want, jwarn), (_, got, twarn) = _export_both(base, case, pack)
    A.assert_artifacts_equal(got, want)
    # the head was trained above 8 bits: requantized, with the warning
    assert twarn == jwarn and any("above 8 bits" in m for m in twarn)
    assert got["head"].fmt == "int8" and got["head"].top == 127
    fmts = {name: e.fmt for name, e in A.artifact_layers(got)}
    assert fmts["blocks_0/proj"] == "int8"  # a 6-bit weight
    if pack:
        assert fmts["blocks_1/qkv"] == "int4"
    if case == "subnet":  # hidden 111 in block 1: an odd fc2 depth
        assert got["blocks"][1]["fc2"].w.shape[0] % 2 == 1
        assert (fmts["blocks_1/fc1"], fmts["blocks_1/fc2"]) == (
            ("int4", "int8") if pack else ("int8", "int8"))


def test_artifact_loads_in_both_packages(base, tmp_path):
    (jcfg, want, _), (cfg, got, _) = _export_both(base, "subnet", True)
    save_vit_int4_artifact(str(tmp_path / "port"), got, cfg)
    jsave(str(tmp_path / "jax"), want, jcfg)
    j_from_port, jcfg2 = jload(str(tmp_path / "port"))
    t_from_jax, cfg2 = load_vit_int4_artifact(str(tmp_path / "jax"),
                                              device="cpu")
    t_from_port, cfg3 = load_vit_int4_artifact(str(tmp_path / "port"),
                                               device="cpu")
    A.assert_artifacts_equal(t_from_jax, want)
    A.assert_artifacts_equal(t_from_port, want)
    A.assert_artifacts_equal(j_from_port, want)
    assert cfg2.hidden_per_block == cfg3.hidden_per_block == \
        jcfg2.hidden_per_block == cfg.hidden_per_block
    assert cfg2.heads_per_block == cfg.heads_per_block


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("case", ["subnet", "uniform"])
def test_exported_subnet_logits_match_jax(base, case, pack):
    (jcfg, want, _), (cfg, got, _) = _export_both(base, case, pack)
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jforward(want, jnp.asarray(x), jcfg, use_pallas=False))
    out = vit_int4_forward(got, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_latency_entry_uniform_only(base):
    """A non-uniform subnet is refused by the latency entry in both
    packages, with the same message; a uniform one (the same sparsity in
    every block, every layer at 4 bits) serves, its logits equal to the
    plain forward's."""
    (jcfg, want, _), (cfg, got, _) = _export_both(base, "subnet", True)
    with pytest.raises(ValueError) as jerr:
        jlatency(want, jcfg)
    with pytest.raises(ValueError) as terr:
        prepare_latency_artifact(got, cfg)
    assert str(terr.value) == str(jerr.value)
    assert "uniform" in str(terr.value)
    # every layer at 4 bits: the same static metadata in every block
    from quantized_vit_tpu.models import init_quant_params_tree

    four = (base[0], init_quant_params_tree(base[1], init_bits=4.0))
    (jcfg, want, _), (cfg, got, _) = _export_both(four, "uniform", True)
    jlatency(want, jcfg)
    lat, meta = prepare_latency_artifact(got, cfg)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    ref = vit_int4_forward(got, x, cfg, float_dtype=torch.bfloat16)
    out = vit_int4_forward_latency(lat, x, cfg, meta,
                                   float_dtype=torch.bfloat16,
                                   images_layout="nhwc")
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("case", ["ultranet", "ultranet_subnet"])
def test_export_ultranet_tables(case):
    import jax

    from quantized_vit_tpu.artifact import export_ultranet_int as juexport
    from quantized_vit_tpu_torch.artifact import export_ultranet_int

    from tests import torch_ultranet_params as U

    _, params, stats, _ = U.trained_like(0, batch=1)
    if case == "ultranet_subnet":
        joto, _, jz, _ = U.zeroed(params, stats, 1, 0.4, 2)
        _, params, stats = joto.construct_subnet(jz)
        params, stats = (jax.tree.map(np.asarray, t) for t in (params, stats))
    want = jax.tree.map(np.asarray, juexport(params, stats))
    got = export_ultranet_int(U.torch_tree(params), U.torch_tree(stats))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.endswith("kernel_int"):
            th = np.tanh(params[k[:6]]["kernel"].astype(np.float64))
            U.held_at_ties(w, g, th / np.abs(th).max() * 7, k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
