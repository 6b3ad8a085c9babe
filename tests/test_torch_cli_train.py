"""Port parity: the training CLI and its plumbing (``cli/train.py``,
``cli/_common.py``, ``cli/export.py``'s ``vit`` target) against the JAX
package's, and train -> export -> serve end to end on the CPU.

The flags (every one, with its default), the cosine schedule, the model
presets, the synthetic and npz datasets (equal byte for byte) and
``vit_config_from_dict`` are compared with the JAX functions directly.
Both ``cli.train`` mains then run 2 epochs of ``vit_tiny_test`` at img 32
(the port with ``--device cpu``) with a schedule that prunes within them,
from one initial checkpoint (``--weights``, the JAX init; the packages
draw their own inits from different generators) and on the same data:
the same files and JSON keys, the losses within ``LOSS_RTOL``, the same
accuracies, sparsity, compressed widths, MACs and parameter counts. The
port's own run (its init) is then held to the JAX run's files and keys;
its ``compressed`` checkpoint exports through ``cli.export vit`` into the
artifact the JAX export makes of the same checkpoint (read by the JAX
package's checkpoint reader): levels, formats and tops equal, the scales
of the layers requantized to 8 bits within 2 f32 ulps (their trained
t != 1 goes through an f32 exp and log, which XLA and PyTorch round
apart), which ``cli.serve`` serves on the CPU, every answer equal to a
direct forward."""

import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

from quantized_vit_tpu.cli import _common as jcommon
from quantized_vit_tpu.cli import train as jtrain
from quantized_vit_tpu.cli.eval import vit_config_from_dict as jcfg_from
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu_torch.cli import _common as common
from quantized_vit_tpu_torch.cli import export as texport
from quantized_vit_tpu_torch.cli import serve as tserve
from quantized_vit_tpu_torch.cli import train as ttrain
from quantized_vit_tpu_torch.models import QuantConfig

from tests import torch_a1_params as A

torch.set_num_threads(1)

# the two runs' epoch-mean f32 losses: the first forward agrees to an ulp
# or so; the updates of the 32-bit quantizers' steps d differ after it
# (UNCOMPARED), which moves the later losses by ~1.3e-6 relative
LOSS_RTOL = 1e-5
# the history fields not compared: the wall time, and the average bit
# width, which the learned bit widths decide: GETA's Adam steps on the
# 32-bit quantizers' step sizes d, whose gradients are sums of rounding
# residuals that XLA and PyTorch round apart (an ulp of exp/log;
# tests/test_torch_qat_vit.py), so the bits reduced from them differ (as
# do the BOPs and weight bits of the cost reports and the bit_dict values)
UNCOMPARED = {"avg_wt_bit", "seconds"}

TINY_FLAGS = ["--model", "vit_tiny_test", "--img-size", "32", "--epochs",
              "2", "--synthetic-samples", "16", "--batch-size", "4",
              "--no-tensorboard", "--projection-start-epochs", "0.25",
              "--projection-epochs", "0.5", "--projection-periods", "1",
              "--pruning-epochs", "0.5", "--pruning-periods", "1"]


def _files(out):
    return {str(p.relative_to(out)) for p in out.rglob("*")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' runs from one initial checkpoint (the port's init at
    ``--seed``, which the JAX checkpoint reader reads): {"jax": dir,
    "port": dir}."""
    from quantized_vit_tpu_torch.models import (init_quant_params_tree,
                                                tree_map)
    from quantized_vit_tpu_torch.opt.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("runs")
    args = ttrain.parse_args(TINY_FLAGS)
    model, _ = common.build_model(args, QuantConfig(enabled=True),
                                  device="cpu", seed=args.seed)
    save_checkpoint(str(d / "init"), init_quant_params_tree(
        tree_map(lambda p: p.detach().clone(), model.param_tree()),
        init_bits=args.max_bit))
    flags = TINY_FLAGS + ["--weights", str(d / "init")]
    jtrain.main(flags + ["--out-dir", str(d / "jax")])
    ttrain.main(flags + ["--device", "cpu", "--out-dir", str(d / "port")])
    return {k: d / k for k in ("jax", "port")}


def _history(out):
    return json.loads((out / "history.json").read_text())


def _meta(out, name):
    return pickle.loads((out / f"{name}.meta.pkl").read_bytes())


def test_train_flags_equal_jax():
    for argv in ([], TINY_FLAGS, ["--use-kd", "--fused-vjp", "--variant",
                                  "sgd", "--matmul-dtype", "bfloat16"]):
        got = vars(ttrain.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == vars(jtrain.parse_args(argv))


@pytest.mark.parametrize("epochs", [1, 2, 5, 90])
def test_cosine_lr_equal(epochs):
    for e in range(epochs + 1):
        assert ttrain.cosine_lr(e, epochs, 3e-4, 0.01) == \
            jtrain.cosine_lr(e, epochs, 3e-4, 0.01)


@pytest.mark.parametrize("model", ["vit_b16", "vit_b32", "vit_l16",
                                   "vit_tiny_test", "vit_small_test"])
def test_model_presets_equal(model):
    args = ttrain.parse_args(["--model", model, "--img-size", "64"])
    _, jcfg = jcommon.build_model(args, JQ(enabled=True))
    cfg = common.model_config(args, QuantConfig(enabled=True))
    for f in dataclasses.fields(cfg):
        if f.name != "quant":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.quant == dataclasses.asdict(jcfg.quant) | {
        "weight_clip": list(jcfg.quant.weight_clip),
        "act_clip": list(jcfg.quant.act_clip)}


def test_datasets_equal_jax(tmp_path):
    args = ttrain.parse_args(["--img-size", "32", "--synthetic-samples",
                              "10", "--num-classes", "7"])
    for got, want in zip(common.build_datasets(args),
                         jcommon.build_datasets(args)):
        assert np.array_equal(got.images, want.images)
        assert got.images.dtype == want.images.dtype
        assert np.array_equal(got.labels, want.labels)
    rng = np.random.default_rng(2)
    path = tmp_path / "d.npz"
    np.savez(path, train_images=rng.standard_normal((6, 8, 8, 3)).astype(
        np.float32), train_labels=np.arange(6), test_images=np.zeros(
        (2, 8, 8, 3), np.float32), test_labels=np.ones(2))
    args = ttrain.parse_args(["--dataset", "npz", "--data-path", str(path)])
    for got, want in zip(common.build_datasets(args),
                         jcommon.build_datasets(args)):
        assert np.array_equal(got.images, want.images)
        assert np.array_equal(got.labels, want.labels)


def test_unported_inputs_name_their_item(tmp_path):
    # a reference ViT state dict (UltraNet's ``layers.{i}`` ones load)
    torch.save({"blocks.0.attn.qkv.weight": torch.zeros(6, 2)},
               tmp_path / "model.pt")
    with pytest.raises(NotImplementedError, match="interop"):
        common.load_params_any(str(tmp_path / "model.pt"), device="cpu")
    for target in ("torch", "onnx"):
        with pytest.raises(NotImplementedError, match="Other model families"):
            texport.main([target, "--checkpoint", "c", "--out", "o"])


def test_train_on_image_folder_equals_jax(tmp_path):
    """``--dataset folder``: both CLIs train one epoch on a generated
    class-per-subfolder tree from one initial checkpoint; the same files,
    the losses within LOSS_RTOL, the same accuracies."""
    from quantized_vit_tpu_torch.models import (init_quant_params_tree,
                                                tree_map)
    from quantized_vit_tpu_torch.opt.checkpoint import save_checkpoint
    from tests.test_torch_data_folder import write_tree

    data = write_tree(tmp_path / "data", classes=2, per_class=10, seed=3)
    flags = [f for f in TINY_FLAGS if f != "--synthetic-samples"]
    flags = flags[:flags.index("16")] + flags[flags.index("16") + 1:]
    flags[flags.index("--epochs") + 1] = "1"
    flags += ["--dataset", "folder", "--data-path", data, "--num-classes",
              "2"]
    args = ttrain.parse_args(flags)
    model, _ = common.build_model(args, QuantConfig(enabled=True),
                                  device="cpu", seed=args.seed)
    save_checkpoint(str(tmp_path / "init"), init_quant_params_tree(
        tree_map(lambda p: p.detach().clone(), model.param_tree()),
        init_bits=args.max_bit))
    flags += ["--weights", str(tmp_path / "init")]
    jtrain.main(flags + ["--out-dir", str(tmp_path / "jax")])
    ttrain.main(flags + ["--device", "cpu", "--out-dir",
                         str(tmp_path / "port")])
    jout, out = tmp_path / "jax", tmp_path / "port"
    assert _files(out) == _files(jout)
    want, got = _history(jout), _history(out)
    assert len(got["history"]) == len(want["history"]) == 1
    g, w = got["history"][0], want["history"][0]
    for k in ("loss", "ce_loss"):
        np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, atol=0)
        assert np.isfinite(g[k])
    for k in ("acc", "val_top1", "val_top5"):
        assert g[k] == w[k], k


def test_vit_config_from_dict_equal():
    from quantized_vit_tpu.models import ViTConfig as JC

    jcfg = JC(img_size=32, patch_size=16, embed_dim=64, depth=2,
              num_heads=2, num_classes=10, quant=JQ(enabled=True),
              heads_per_block=(2, 1), hidden_per_block=(196, 111))
    d = json.loads(json.dumps(dataclasses.asdict(jcfg)))  # lists, as saved
    got, want = common.vit_config_from_dict(d), jcfg_from(d)
    assert got.heads_per_block == want.heads_per_block == (2, 1)
    assert got.hidden_per_block == want.hidden_per_block == (196, 111)
    assert got.quant_config == QuantConfig(**{
        k: getattr(want.quant, k) for k in dataclasses.asdict(want.quant)})


def test_train_run_equals_jax(runs):
    """The two runs from one init: files, keys and the numbers that do not
    hang on the learned bit widths or the clock (:data:`UNCOMPARED`)."""
    jout, out = runs["jax"], runs["port"]
    assert _files(out) == _files(jout)
    want, got = _history(jout), _history(out)
    assert set(got) == set(want)
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert set(g) == set(w)
        for k in ("loss", "ce_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, atol=0)
        rest = set(w) - UNCOMPARED - {"loss", "ce_loss", "group_sparsity"}
        assert {k: g[k] for k in rest} == {k: w[k] for k in rest}
        np.testing.assert_allclose(g["group_sparsity"], w["group_sparsity"],
                                   rtol=1e-12)
    assert got["history"][-1]["group_sparsity"] > 0
    for side in ("full", "compressed"):
        assert set(got[side]) == set(want[side])
        for k in ("macs", "params"):
            assert got[side][k] == want[side][k], (side, k)
    assert got["compressed"]["macs"] < got["full"]["macs"]
    jm, m = _meta(jout, "compressed"), _meta(out, "compressed")
    assert jm["opt_state"] is m["opt_state"] is None
    assert set(m["extra"]) == set(jm["extra"]) == {"bit_dict", "subnet"}
    sub, jsub = m["extra"]["subnet"], jm["extra"]["subnet"]
    assert set(sub) == set(jsub)
    assert json.loads(json.dumps(sub)) == json.loads(json.dumps(jsub))
    assert any(h < 256 for h in sub["hidden_per_block"])
    assert set(m["extra"]["bit_dict"]) == set(jm["extra"]["bit_dict"])
    for name in ("best", "final"):
        assert set(_meta(out, name)["extra"]) == set(
            _meta(jout, name)["extra"]), name


def test_train_export_serve_end_to_end(runs, tmp_path):
    from quantized_vit_tpu.cli.eval import vit_config_from_dict
    from quantized_vit_tpu.opt.checkpoint import load_checkpoint
    from quantized_vit_tpu.serve import export_vit_int4 as jexport
    from quantized_vit_tpu_torch.artifact import load_vit_int4_artifact
    from quantized_vit_tpu_torch.serve import vit_int4_forward

    # the port's own init; files and keys as the JAX run's
    jout, out = runs["jax"], tmp_path / "train"
    history = ttrain.main(TINY_FLAGS + ["--device", "cpu", "--out-dir",
                                        str(out)])
    assert _files(out) == _files(jout)
    hist, jhist = _history(out), _history(jout)
    assert set(hist) == set(jhist) and len(hist["history"]) == 2
    assert all(set(r) == set(jhist["history"][0]) for r in hist["history"])
    assert set(hist["full"]) == set(hist["compressed"]) == set(jhist["full"])
    assert hist["history"] == json.loads(json.dumps(history))
    assert hist["history"][-1]["group_sparsity"] > 0
    assert hist["compressed"]["macs"] < hist["full"]["macs"]

    def tags(o):
        return {json.loads(ln)["tag"] for ln in
                (o / "tb" / "metrics.jsonl").read_text().splitlines()}

    assert tags(out) == tags(jout) == set(jhist["history"][0])
    meta, jmeta = _meta(out, "compressed"), _meta(jout, "compressed")
    assert meta["opt_state"] is None
    assert set(meta["extra"]) == set(jmeta["extra"])
    assert set(meta["extra"]["subnet"]) == set(jmeta["extra"]["subnet"])
    assert set(_meta(out, "best")["extra"]) == set(_meta(jout, "best")
                                                   ["extra"])

    # export: the port's CLI against the JAX export of the same checkpoint
    art_dir = tmp_path / "art"
    texport.main(["vit", "--checkpoint", str(out / "compressed"), "--out",
                  str(art_dir), "--device", "cpu"])
    art, cfg = load_vit_int4_artifact(str(art_dir), device="cpu")
    jparams, _, jextra = load_checkpoint(str(out / "compressed"))
    jcfg = vit_config_from_dict(jextra["subnet"])
    assert cfg.hidden_per_block == jcfg.hidden_per_block
    assert cfg.heads_per_block == jcfg.heads_per_block
    # trained quantizers (t != 1) requantized to 8 bits: their steps
    # within an ulp (an f32 exp and log), every level and the rest exact
    A.assert_artifacts_equal(art, jexport(jcfg, jparams), ulps=2)

    # serve: the artifact behind the batcher, answers = direct forwards
    res = tserve.main(["--artifact", str(art_dir), "--device", "cpu",
                       "--requests", "6", "--max-batch", "4"])
    assert res["requests"] == 6 and res["device"] == "cpu"
    direct = vit_int4_forward(art, torch.from_numpy(res["images"]), cfg,
                              images_layout="nhwc").numpy()
    np.testing.assert_allclose(res["answers"], direct, atol=1e-5, rtol=0)


def test_metrics_writer_and_trace(tmp_path):
    """``utils/logging.py``: the JSONL mirror as the JAX writer writes it
    (timestamps aside), a torch.profiler trace written where
    ``profile_trace`` is asked, and ``device_kernel_times`` summing a
    trace's kernel events by name."""
    import gzip

    from quantized_vit_tpu.utils.logging import MetricsWriter as JWriter
    from quantized_vit_tpu_torch.utils.logging import (MetricsWriter,
                                                       device_kernel_times,
                                                       profile_trace)

    rows = []
    for cls, d in ((MetricsWriter, tmp_path / "t"), (JWriter, tmp_path / "j")):
        w = cls(str(d), use_tensorboard=False)
        assert not w.has_tensorboard
        w.add_scalars({"loss": 2.5, "acc": 1, "name": "x"}, step=3)
        w.add_scalar("lr", 1e-4, 4)
        w.close()
        rows.append([{k: v for k, v in json.loads(ln).items() if k != "ts"}
                     for ln in (d / "metrics.jsonl").read_text().splitlines()])
    assert rows[0] == rows[1] and len(rows[0]) == 3

    with profile_trace(str(tmp_path / "prof")) as where:
        torch.ones(8).add_(1)
    assert where == str(tmp_path / "prof")
    assert len(list((tmp_path / "prof").glob("*.trace.json.gz"))) == 1
    assert device_kernel_times(str(tmp_path / "prof")) == {}  # no card
    with profile_trace(str(tmp_path / "off"), enabled=False) as where:
        assert where is None
    assert not (tmp_path / "off").exists()
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "gather_bulk_kernel", "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "gather_bulk_kernel", "dur": 7},
        {"ph": "X", "cat": "kernel", "name": "mlp_kernel.2", "dur": 3},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add_", "dur": 11}]}
    (tmp_path / "k").mkdir()
    with gzip.open(tmp_path / "k" / "trace_1.trace.json.gz", "wt") as f:
        json.dump(trace, f)
    assert device_kernel_times(str(tmp_path / "k")) == {
        "gather_bulk_kernel": 12.0, "mlp_kernel": 3.0}
