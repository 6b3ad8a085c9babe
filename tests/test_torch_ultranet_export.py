"""Port parity: UltraNet's export side against the JAX package, on the CPU
(``artifact/ultranet.py``, ``artifact/hls.py``, ``artifact/native.py``,
``interop/npz_export.py``, ``interop/torch_import.py``, ``cli/export.py``'s
``ultranet``, ``hls`` and ``refnpz`` targets, ``cli/_common.py``'s ``.pt``
reader), on the trees of ``tests/torch_ultranet_params.py``.

Tolerances. Artifacts cross between the packages unchanged, bit for bit.
The FPGA headers are byte-identical when written from the same integer
tables (the JAX export's own tables, recorded as it writes); the port's
own export from the params gives the same bytes where its tables equal
JAX's, which they do off rounding ties (tanh differs by ulps; the tables
test is in ``tests/test_torch_export.py``). The reference npz's members
(the .npy bytes) and config.json are byte-identical. The native packer
equals its numpy path."""

import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from quantized_vit_tpu.artifact import export_ultranet_int as jexport
from quantized_vit_tpu.artifact import hls as jhls
from quantized_vit_tpu.artifact import load_ultranet_artifact as jload
from quantized_vit_tpu.artifact import save_ultranet_artifact as jsave
from quantized_vit_tpu.artifact import native as jnative
from quantized_vit_tpu.artifact import generate_ultranet_config as jtable
from quantized_vit_tpu.artifact import UltraNetExportConfig as JExp
from quantized_vit_tpu.cli import export as jcli
from quantized_vit_tpu.interop import export_reference_ultranet as jrefnpz
from quantized_vit_tpu.interop import ultranet_params_to_torch as jto_torch
from quantized_vit_tpu.opt.checkpoint import load_checkpoint as jload_ckpt
from quantized_vit_tpu_torch.artifact import (UltraNetExportConfig,
                                              export_ultranet_hls,
                                              export_ultranet_int,
                                              generate_ultranet_config,
                                              hls_texts,
                                              load_ultranet_artifact,
                                              save_ultranet_artifact,
                                              write_hls)
from quantized_vit_tpu_torch.artifact import native
from quantized_vit_tpu_torch.cli import export as tcli
from quantized_vit_tpu_torch.interop import (export_reference_ultranet,
                                             load_torch_checkpoint,
                                             normalize_state_dict,
                                             ultranet_params_from_torch,
                                             ultranet_params_to_torch)
from quantized_vit_tpu_torch.models import UltraNet, UltraNetInt
from quantized_vit_tpu_torch.opt.checkpoint import save_checkpoint
from quantized_vit_tpu_torch.quant import weight_quantize_int
from quantized_vit_tpu_torch.utils._gxx import so_path

from tests import torch_ultranet_params as U

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def net():
    _, params, stats, _ = U.trained_like(0, batch=1)
    return params, stats


def _pruned(params, stats, drop=(0, 5)):
    """conv_2 without channels ``drop`` (its BN sliced, conv_3's inputs
    too): a GETA subnet's widths."""
    keep = np.setdiff1d(np.arange(64), drop)
    p = jax.tree.map(np.copy, params)
    s = jax.tree.map(np.copy, stats)
    p["conv_2"]["kernel"] = p["conv_2"]["kernel"][..., keep]
    for nm in ("scale", "bias"):
        p["bn_2"][nm] = p["bn_2"][nm][keep]
    for nm in ("mean", "var"):
        s["bn_2"][nm] = s["bn_2"][nm][keep]
    p["conv_3"]["kernel"] = p["conv_3"]["kernel"][:, :, keep]
    return p, s


def _case(net, case):
    return net if case == "full" else _pruned(*net)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_geometry_table_equal():
    for exp_kw, channels in (({}, None), ({"l_shift": 6, "a_bit": 3},
                                          [16, 32, 62, 64, 64, 60, 64, 8])):
        assert generate_ultranet_config(
            UltraNetExportConfig(**exp_kw), channels) == jtable(
                JExp(**exp_kw), channels)


@pytest.mark.parametrize("case", ["full", "pruned"])
def test_artifact_round_trips_both_ways(net, case, tmp_path):
    """JAX's artifact loads in the port and the port's in JAX, arrays and
    dtypes bit-equal (the port's own tables equal JAX's off ties), the
    same manifest meta."""
    params, stats = _case(net, case)
    jsave(str(tmp_path / "jax"), params, stats)
    save_ultranet_artifact(str(tmp_path / "port"), U.torch_tree(params),
                           U.torch_tree(stats))
    t_from_jax, t_meta = load_ultranet_artifact(str(tmp_path / "jax"),
                                                device="cpu")
    j_from_port, j_meta = jload(str(tmp_path / "port"))
    j_own, j_own_meta = jload(str(tmp_path / "jax"))
    assert U.trees_equal(j_own, t_from_jax)
    assert set(j_from_port) == set(j_own)
    for k in j_own:  # the port's own tables: equal off ties
        if k.endswith("kernel_int"):
            w = np.tanh(U.numpy_tree(params)[k[:6]]["kernel"].astype(
                np.float64))
            U.held_at_ties(j_own[k], j_from_port[k],
                           w / np.abs(w).max() * 7, k)
        else:
            np.testing.assert_array_equal(np.asarray(j_from_port[k]),
                                          np.asarray(j_own[k]))
        assert np.asarray(j_from_port[k]).dtype == np.asarray(j_own[k]).dtype
    assert t_meta == j_meta == j_own_meta


def _recording(monkeypatch):
    """Record the integer tables JAX's ``export_ultranet_hls`` computes."""
    rec = {}
    wq, bq = jhls.weight_quantize_int, jhls.bn_act_quantize_int

    def w_(kernel, bit):
        out = wq(kernel, bit=bit)
        rec.setdefault("w", []).append(np.asarray(out))
        return out

    def b_(*a, **k):
        out = bq(*a, **k)
        rec.setdefault("ib", []).append(tuple(np.asarray(o) for o in out))
        return out

    monkeypatch.setattr(jhls, "weight_quantize_int", w_)
    monkeypatch.setattr(jhls, "bn_act_quantize_int", b_)
    return rec


_HLS_FILES = ("param.h", "config.h", "last_bias.npy", "last_bias.bin")


@pytest.mark.parametrize("case", ["full", "pruned"])
def test_hls_headers_byte_identical(net, case, tmp_path, monkeypatch):
    """From the same integer tables the port writes JAX's four files byte
    for byte (``pruned``: conv_2 at 62 channels, its PE degraded to
    gcd(62, 8) = 2). The port's own export from the params: the same
    bytes where its tables equal JAX's (checked off ties)."""
    params, stats = _case(net, case)
    rec = _recording(monkeypatch)
    jtexts = jhls.export_ultranet_hls(params, stats, str(tmp_path / "jax"))
    tables = {}
    for i, w in enumerate(rec["w"]):
        tables[f"conv_{i}_kernel_int"] = w
        if i < 8:
            tables[f"conv_{i}_inc"], tables[f"conv_{i}_bias_int"] = \
                rec["ib"][i]
    channels = [int(params[f"conv_{i}"]["kernel"].shape[-1])
                for i in range(8)]
    texts = hls_texts(tables, generate_ultranet_config(
        UltraNetExportConfig(), channels))
    assert texts == jtexts
    write_hls(str(tmp_path / "same"), texts, params["conv_8"]["bias"])
    for f in _HLS_FILES:
        assert _read(tmp_path / "same" / f) == _read(tmp_path / "jax" / f), f
    if case == "pruned":
        assert "#define CONV_2_PE 2 " in texts["config"]
    own = export_ultranet_hls(U.torch_tree(params), U.torch_tree(stats),
                              str(tmp_path / "port"))
    flips = 0
    for i in range(9):
        w = np.tanh(params[f"conv_{i}"]["kernel"].astype(np.float64))
        mine = weight_quantize_int(torch.from_numpy(np.array(
            params[f"conv_{i}"]["kernel"])), 4).numpy()
        flips += U.held_at_ties(tables[f"conv_{i}_kernel_int"], mine,
                                w / np.abs(w).max() * 7, f"conv_{i}")
    if flips == 0:
        assert own == jtexts
        for f in _HLS_FILES:
            assert _read(tmp_path / "port" / f) == _read(
                tmp_path / "jax" / f), f


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.mark.parametrize("case", ["full", "pruned"])
def test_reference_npz_byte_identical(net, case, tmp_path):
    """``ultranet_4w4a.npz`` (each member's .npy bytes; the zip's own
    timestamps are the write's) and ``config.json`` byte-identical, from
    tensors as from numpy arrays."""
    params, stats = _case(net, case)
    jnpz, jcfg = jrefnpz(params, stats, str(tmp_path / "jax"))
    tnpz, tcfg = export_reference_ultranet(U.torch_tree(params),
                                           U.torch_tree(stats),
                                           str(tmp_path / "port"))
    members = _npz_members(jnpz)
    assert len(members) == 50
    assert _npz_members(tnpz) == members
    assert _read(tcfg) == _read(jcfg)
    with np.load(tnpz) as z:
        assert z["arr_0"].shape == (16, 3, 3, 3)  # OIHW


def test_native_packer_matches_numpy():
    """The library builds under build/native/<hash>/ (not into the source
    tree); pack, unpack and the level quantizer equal their numpy paths
    and the JAX package's functions."""
    assert native.native_available()
    so = so_path(native._SRC, native._SO)
    assert so.exists() and "build" in so.parts and "native" in so.parts
    assert not list((native._SRC.parent).glob("*.so"))
    rng = np.random.default_rng(9)
    lv = rng.integers(-8, 8, (96, 40)).astype(np.int8)
    packed = native.pack_int4_host(lv)
    np.testing.assert_array_equal(packed, native._pack_int4_np(lv))
    np.testing.assert_array_equal(packed, jnative.pack_int4_host(lv))
    np.testing.assert_array_equal(native.unpack_int4_host(packed), lv)
    np.testing.assert_array_equal(native._unpack_int4_np(packed), lv)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    scale = rng.uniform(0.05, 0.3, 48).astype(np.float32)
    q = native.quantize_levels_host(w, scale, -8, 7)
    np.testing.assert_array_equal(
        q, native._quantize_levels_np(w, scale, -8, 7))
    np.testing.assert_array_equal(q, jnative.quantize_levels_host(
        w, scale, -8, 7))
    with pytest.raises(ValueError, match="even"):
        native.pack_int4_host(lv[:3])


def test_params_from_torch_state_dict(net, tmp_path):
    """A state dict JAX's ``ultranet_params_to_torch`` wrote with
    ``torch.save`` (plain, under a "model" wrapper, with "module."
    prefixes) reads back into the same trees; the port's
    ``ultranet_params_to_torch`` writes JAX's state dict."""
    params, stats = net
    sd = jto_torch(params, stats)
    mine = ultranet_params_to_torch(U.torch_tree(params),
                                    U.torch_tree(stats))
    assert list(mine) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(mine[k], np.asarray(sd[k]))
    tens = {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}
    payloads = {"plain": tens, "wrapped": {"model": tens, "epoch": 3},
                "module": {f"module.{k}": v for k, v in tens.items()}}
    for name, payload in payloads.items():
        path = tmp_path / f"{name}.pt"
        torch.save(payload, path)
        p2, s2 = ultranet_params_from_torch(load_torch_checkpoint(str(path)))
        assert U.trees_equal(params, p2) and U.trees_equal(stats, s2), name
    assert list(normalize_state_dict(payloads["module"])) == list(sd)
    with pytest.raises(KeyError, match="unexpected UltraNet key"):
        ultranet_params_from_torch({"head.weight": np.zeros(2)})


def _checkpoints(net, tmp_path):
    """The same trees as a port checkpoint and as the reference's .pt."""
    params, stats = net
    ckpt = str(tmp_path / "ckpt" / "ultranet")
    save_checkpoint(ckpt, U.torch_tree(params), None,
                    {"batch_stats": stats})
    pt = tmp_path / "ultranet_4w4a.pt"
    torch.save({k: torch.as_tensor(np.asarray(v))
                for k, v in jto_torch(params, stats).items()}, pt)
    return {"ckpt": ckpt, "pt": str(pt)}


@pytest.mark.parametrize("source", ["ckpt", "pt"])
@pytest.mark.parametrize("target", ["ultranet", "hls", "refnpz"])
def test_cli_targets(net, tmp_path, target, source):
    """``cli.export`` ultranet / hls / refnpz with ``--device cpu`` on a
    port checkpoint (params, stats in its extra) and on a reference .pt:
    the JAX CLI's output on the same input (the integer artifact's tables
    off ties, the headers byte for byte where the tables equal, the npz
    members and config.json byte for byte)."""
    inp = _checkpoints(net, tmp_path)[source]
    if source == "ckpt":  # the JAX package reads the port's checkpoint
        jp, _, jextra = jload_ckpt(inp)
        assert U.trees_equal(jextra["batch_stats"], U.torch_tree(net[1]))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.main([target, "--checkpoint", inp, "--out", jout])
    tcli.main([target, "--checkpoint", inp, "--out", tout, "--device",
               "cpu"])
    if target == "ultranet":
        want, wmeta = jload(jout)
        got, gmeta = load_ultranet_artifact(tout, device="cpu")
        assert gmeta == wmeta and set(got) == set(want)
        for k in want:
            if k.endswith("kernel_int"):
                w = np.tanh(net[0][k[:6]]["kernel"].astype(np.float64))
                U.held_at_ties(want[k], got[k].numpy(),
                               w / np.abs(w).max() * 7, k)
            else:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
    elif target == "hls":
        assert "const ap_uint<12> conv_0_w" in _read(
            os.path.join(tout, "param.h")).decode()
        want_k = jexport(*net)
        got_k = export_ultranet_int(*map(U.torch_tree, net))
        if all(np.array_equal(np.asarray(want_k[k]), got_k[k].numpy())
               for k in want_k):
            for f in _HLS_FILES:
                assert _read(os.path.join(tout, f)) == _read(
                    os.path.join(jout, f)), f
    else:
        assert _npz_members(os.path.join(tout, "ultranet_4w4a.npz")) == \
            _npz_members(os.path.join(jout, "ultranet_4w4a.npz"))
        cfg = json.loads(_read(os.path.join(tout, "config.json")))
        assert cfg["conv_0"]["in_shape"] == [3, 160, 320]
        assert _read(os.path.join(tout, "config.json")) == _read(
            os.path.join(jout, "config.json"))


def test_cli_refuses_without_stats_and_other_pt(tmp_path):
    ckpt = str(tmp_path / "nostats")
    save_checkpoint(ckpt, {"conv_0": {"kernel": torch.zeros(3, 3, 3, 16)}})
    with pytest.raises(SystemExit, match="batch_stats"):
        tcli.main(["ultranet", "--checkpoint", ckpt, "--out",
                   str(tmp_path / "o"), "--device", "cpu"])
    # a reference ViT state dict loads (as a ViT tree, without BN
    # statistics) and stops where the JAX CLI stops
    torch.save({"head.weight": torch.zeros(2, 2)}, tmp_path / "vit.pt")
    with pytest.raises(SystemExit, match="batch_stats"):
        tcli.main(["hls", "--checkpoint", str(tmp_path / "vit.pt"), "--out",
                   str(tmp_path / "o"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="batch_stats"):
        jcli.main(["hls", "--checkpoint", str(tmp_path / "vit.pt"), "--out",
                   str(tmp_path / "o")])


def test_ultranet_entry_points_default_to_the_card(net, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params, stats = net
    save_ultranet_artifact(str(tmp_path / "a"), U.torch_tree(params),
                           U.torch_tree(stats))
    for fn in (UltraNet, UltraNetInt,
               lambda: load_ultranet_artifact(str(tmp_path / "a"))):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
    ckpt = _checkpoints(net, tmp_path)["ckpt"]
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["ultranet", "--checkpoint", ckpt, "--out",
                   str(tmp_path / "o")])
