"""The port's serving front on the CPU: the continuous batcher and the
serve CLI answer requests, each answer equal to a direct forward of the
same image (every op is row- or image-independent, so batch composition
does not change a result), and ``chip_smoke.py`` runs all its phases as a
CPU rehearsal at a tiny size (plain versions only, no timings of a card).
"""

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch.artifact import save_vit_int4_artifact
from quantized_vit_tpu_torch.cli import serve
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.serve import (ContinuousBatcher,
                                           random_vit_int4_artifact,
                                           vit_int4_forward)
from quantized_vit_tpu_torch.utils import patchify_batch

torch.set_num_threads(1)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_classes=10)


def _direct(art, cfg, images, **kw):
    x = torch.from_numpy(patchify_batch(images, cfg.patch_size))
    return vit_int4_forward(art, x, cfg, images_layout="patches",
                            **kw).numpy()


def test_batcher_answers_equal_direct_forward():
    cfg = ViTConfig(**SMALL)
    art = random_vit_int4_artifact(cfg, seed=0, device="cpu")
    images = np.random.default_rng(0).standard_normal(
        (11, 32, 32, 3)).astype(np.float32)

    def forward(batch):
        return vit_int4_forward(
            art, torch.from_numpy(patchify_batch(batch, 16)), cfg,
            images_layout="patches")

    batcher = ContinuousBatcher(forward, max_batch=4, max_delay_ms=20)
    assert batcher.buckets == [1, 2, 4]
    with batcher:
        futs = [batcher.submit(img) for img in images]
        got = np.stack([f.result(timeout=60) for f in futs])
    np.testing.assert_array_equal(got, _direct(art, cfg, images))
    assert batcher.stats["requests"] == 11
    assert sum(batcher.stats["batch_hist"].values()) == \
        batcher.stats["batches"]
    # a stopped batcher rejects instead of leaving a future pending
    with pytest.raises(RuntimeError):
        batcher.submit(images[0]).result(timeout=5)


@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8"])
def test_serve_cli_answers_equal_direct_forward(tmp_path, uint8):
    cfg = ViTConfig(**SMALL)
    art = random_vit_int4_artifact(cfg, seed=1, device="cpu")
    save_vit_int4_artifact(str(tmp_path), art, cfg)
    argv = ["--artifact", str(tmp_path), "--requests", "12", "--max-batch",
            "4", "--device", "cpu"]
    out = serve.main(argv + (["--input-uint8"] if uint8 else []))
    assert out["requests"] == 12 and out["answers"].shape == (12, 10)
    kw = dict(float_dtype=serve.SERVE_DTYPE)
    images = out["images"]
    if uint8:
        images = images.astype(np.float32)
        kw["input_scale"] = 1.0 / 255.0
    np.testing.assert_array_equal(out["answers"],
                                  _direct(art, cfg, images, **kw))


def test_serve_cli_refuses_mesh(tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP"):
        serve.build_forward(serve.parse_args(
            ["--artifact", str(tmp_path), "--mesh-model", "2",
             "--device", "cpu"]))


def test_chip_smoke_rehearsal_on_cpu(tmp_path, monkeypatch):
    """Every phase of chip_smoke.py at a tiny size on the CPU (the kernel
    wrappers take their plain versions there, so the comparisons are
    trivially equal; what this checks is the script's control flow), the
    training phase included: 13 GETA steps through warmup, range
    projection, two pruning periods and fix, to the target sparsity."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    monkeypatch.setattr(chip_smoke, "ITERS", 2)
    monkeypatch.setattr(chip_smoke, "CFG_KW", SMALL)
    monkeypatch.setattr(chip_smoke, "ART_DIR", str(tmp_path / "art"))
    monkeypatch.setattr(chip_smoke, "TRAIN_CKPT", str(tmp_path / "ckpt"))
    record = {"device": "cpu"}
    chip_smoke.run(record)
    names = [k["name"] for k in record["kernels"]]
    assert names == ["fused_quant_matmul", "fused_mlp", "attention_block",
                     "patch_finalize", "attention_qkv", "block_stack",
                     "quant_bwd"]
    train = record["train"]
    assert train["steps"] == chip_smoke.TRAIN_STEPS
    assert set(train["phases"]) == {"warmup", "range", "fix"}
    assert train["num_zero_groups"] == train["target_redundant_groups"] > 0
    assert train["bit_layers_frozen"] and train["checkpoint_roundtrip"]
    assert train["plain_vs_k7"]["ok"]
    assert {"k7", "plain"} == set(record["train_timing"]["step"])
    # K7 timed on the inputs of every quantizer site of one step
    timed = sum(len(v["sites"]) for v in
                record["train_timing"]["k7_by_shape"].values())
    assert timed == sum(n for _, _, n in chip_smoke.k7_sites(
        chip_smoke.main_cfg()))
    k7 = record["kernels"][-1]
    assert all(isinstance(k7[f], float) and k7[f] > 0
               for f in ("ms", "plain_ms", "bound_ms"))
    assert all(r["ok"] for r in record["parity"])
    assert record["serve"]["answers_equal_direct"]
    small = record["serve"]["small_flushes"]
    assert small["answers_equal_direct"]
    assert {1, 2} <= set(small["batch_hist"])
    routes = {(f["forward"], f["batch"]) for f in record["forward"]}
    assert {("chain,int8-stored", b) for b in (1, 2, 3)} <= routes
    assert ("latency,int4-packed", 1) in routes
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) for k in record["kernels"])
