"""The port's serving front on the CPU: the continuous batcher and the
serve CLI answer requests, each answer equal to a direct forward of the
same image (every op is row- or image-independent, so batch composition
does not change a result), and ``chip_smoke.py`` runs all its phases as a
CPU rehearsal at a tiny size (plain versions only, no timings of a card).
"""

import re

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


def _jax_mesh_forward(art_dir, images, mode, float_dtype):
    """The JAX serve CLI's mesh forward (mesh (1, 2)) on the same artifact
    and float images, at ``float_dtype`` ("bfloat16" its own, "float32"
    the exact yardstick; tp reduce-scatters in it too)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from quantized_vit_tpu.artifact import load_vit_int4_artifact
    from quantized_vit_tpu import serve as jserve

    art, cfg = load_vit_int4_artifact(art_dir)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                ("data", "model"))
    x = jax.device_put(jnp.asarray(patchify_batch(images, cfg.patch_size)),
                       NamedSharding(mesh, P(("data", "model"))))
    float_dtype = getattr(jnp, float_dtype)
    kw = dict(use_pallas=False, float_dtype=float_dtype,
              images_layout="patches")
    if mode == "tp":
        art_m = jserve.shard_tp_artifact(
            jserve.prepare_tp_artifact(art, cfg, 2), mesh)
        return np.asarray(jserve.vit_int4_forward_tp(
            art_m, x, cfg, mesh, comm_dtype=float_dtype, **kw), np.float32)
    art_m = jserve.shard_fsdp_artifact(
        jserve.prepare_fsdp_artifact(art, cfg, 2), mesh)
    return np.asarray(jserve.vit_int4_forward_fsdp(art_m, x, cfg, mesh,
                                                   **kw), np.float32)


@pytest.fixture(scope="module")
def mesh_artifact(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_art"))
    cfg = ViTConfig(**SMALL)
    save_vit_int4_artifact(d, random_vit_int4_artifact(cfg, seed=4,
                                                       device="cpu"), cfg)
    return d


@pytest.mark.parametrize("mode,uint8", [("tp", False), ("fsdp", False),
                                        ("tp", True), ("fsdp", True)],
                         ids=["tp", "fsdp", "tp-uint8", "fsdp-uint8"])
def test_serve_cli_mesh_answers_like_jax(mesh_artifact, mode, uint8):
    """``--mesh-model 2 --device cpu``: this process and one spawned
    worker answer 10 requests (buckets 2 and 4: --max-batch 5 is capped at
    4). fsdp: every answer equal to the port's single-device bf16 forward
    of the same image; both modes against the JAX CLI's mesh forward, the
    bf16 criterion of tests/serve/test_vit_tp.py:58-84 (no further from
    the f32 forward than 1.5x the JAX bf16 forward's deviation).
    ``--input-uint8`` is honoured: the images are uint8, scaled by 1/255
    on the device (the JAX mesh branch ignores the flag; the yardsticks
    here take the scaled images)."""
    argv = ["--artifact", mesh_artifact, "--requests", "10", "--max-batch",
            "5", "--device", "cpu", "--mesh-model", "2", "--mesh-mode", mode]
    out = serve.main(argv + (["--input-uint8"] if uint8 else []))
    assert out["requests"] == 10 and out["answers"].shape == (10, 10)
    assert out["mesh_model"] == 2 and out["mesh_mode"] == mode
    assert set(out["batch_hist"]) <= {2, 4}
    assert sum(out["batches_per_worker"]) == out["batches"] + 2  # warm-up
    images = out["images"]
    if uint8:
        assert images.dtype == np.uint8
        images = (torch.from_numpy(images).to(torch.float32) * torch.full(
            (), 1.0 / 255.0, dtype=torch.float32)).numpy()
    if mode == "fsdp":
        from quantized_vit_tpu_torch.artifact import load_vit_int4_artifact

        art, cfg = load_vit_int4_artifact(mesh_artifact, device="cpu")
        np.testing.assert_array_equal(out["answers"], _direct(
            art, cfg, images, float_dtype=serve.MESH_DTYPE))
    exact = _jax_mesh_forward(mesh_artifact, images, mode, "float32")
    served = _jax_mesh_forward(mesh_artifact, images, mode, "bfloat16")
    dev_port = np.abs(out["answers"] - exact).max()
    assert dev_port <= 1.5 * np.abs(served - exact).max() + 1e-6, dev_port


def test_mesh_buckets_stay_divisible():
    """The JAX CLI's mesh buckets (tests/cli/test_cli_drivers.py:267-300):
    multiples of N up to the capped max batch, which divides by N."""
    assert serve.mesh_buckets(4, 6) == ([4], 4)
    assert serve.mesh_buckets(2, 5) == ([2, 4], 4)
    assert serve.mesh_buckets(2, 8) == ([2, 4, 8], 8)
    assert serve.mesh_buckets(4, 12) == ([4, 8, 12], 12)
    assert serve.mesh_buckets(3, 2) == ([3], 3)
    for n in (1, 2, 3, 4):
        for mb in range(1, 20):
            buckets, cap = serve.mesh_buckets(n, mb)
            b = ContinuousBatcher(lambda x: x, max_batch=cap,
                                  buckets=buckets)
            assert all(k % n == 0 for k in b.buckets), (n, mb, b.buckets)


def test_serve_cli_mesh_refusals(tmp_path):
    cfg = ViTConfig(**SMALL)
    save_vit_int4_artifact(str(tmp_path), random_vit_int4_artifact(
        cfg, seed=1, device="cpu"), cfg)
    args = serve.parse_args(["--artifact", str(tmp_path), "--mesh-model",
                             "-1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs N >= 1"):
        serve.build_forward(args)
    # --mesh-model 1: this process alone, the TP forward at tp = 1
    out = serve.main(["--artifact", str(tmp_path), "--requests", "3",
                      "--max-batch", "2", "--device", "cpu",
                      "--mesh-model", "1"])
    assert out["answers"].shape == (3, 10) and out["batches_per_worker"] == []


def test_chip_smoke_rehearsal_on_cpu(tmp_path, monkeypatch):
    """Every phase of chip_smoke.py at a tiny size on the CPU (the kernel
    wrappers take their plain versions there, so the comparisons are
    trivially equal; what this checks is the script's control flow), the
    training phase included: 13 GETA steps through warmup, range
    projection, two pruning periods and fix, to the target sparsity; and
    phase 12's model families at small batches and widths."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    monkeypatch.setattr(chip_smoke, "ITERS", 2)
    # width 128: the FSDP phase's packed int4 rows (64) split into two
    # tile-aligned shards of 32
    monkeypatch.setattr(chip_smoke, "CFG_KW", dict(SMALL, embed_dim=128))
    # ViT-H/14's phase at head_dim 80, shrunk: 4 patches of 14, 4 heads
    # (width 320: its FSDP forward's int8 rows split into two tile-aligned
    # shards)
    monkeypatch.setattr(chip_smoke, "VIT_H_KW", dict(
        img_size=28, patch_size=14, embed_dim=320, depth=2, num_heads=4,
        num_classes=10))
    monkeypatch.setattr(chip_smoke, "VIT_H_BATCHES", (1, 2, 4))
    # the FSDP phase: tp = 2 as two spawned gloo processes (128 rows do
    # not split into 4 tile-aligned shards of packed int4)
    monkeypatch.setattr(chip_smoke, "GATHER_TPS", (1, 2))
    # phase 9: tp = 1 here and 2 spawned (4 spawned processes would add
    # their start-up to the rehearsal's time)
    monkeypatch.setattr(chip_smoke, "MESH_TPS", (1, 2))
    monkeypatch.setattr(chip_smoke, "MESH_ITERS", 1)
    monkeypatch.setattr(chip_smoke, "MESH_CLI_REQUESTS", 6)
    # phase 3b: ViT-H's attention branch at batch 8 and the GEMMs at M =
    # 8 x 16 rows keep their batches at these widths
    # phase 3d: the ablation tools at small shapes (the attention tool
    # keeps its 224 rows and 208 keys, which the tool's mask needs)
    monkeypatch.setattr(chip_smoke, "ABLATION_SHAPES", {
        "exp_pro": (64, 64, 256), "exp_pro2": (64, 64, 256),
        "exp_epilogue": (64, 64, 256), "exp_fc1": (64, 64, 256),
        "exp_attn": (2, 224, 208, 2, 16), "exp_attn2": (4, 32, 2, 16, 27)})
    # phase 11: UltraNet at the JAX tests' 32 x 64, batch 4
    monkeypatch.setattr(chip_smoke, "ULTRA_HW", (32, 64))
    monkeypatch.setattr(chip_smoke, "ULTRA_BATCH", 4)
    # phase 12: the families at small batches; ResNet at one block a
    # stage, the encoder and the Llama-style block at width 64, 2 blocks
    for name, value in (("CIFAR_BATCH", 8), ("BERT_BATCH", 2),
                        ("BERT_SEQ", 16), ("AE_BATCH", 2), ("AE_HW", 16),
                        ("LORA_DIMS", (64, 96, 500)), ("LORA_ROWS", 64),
                        ("RESNET_KW", dict(stage_sizes=(1, 1, 1))),
                        ("BERT_KW", dict(vocab_size=1000, embed_dim=64,
                                         depth=2, num_heads=4))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "ART_DIR", str(tmp_path / "art"))
    monkeypatch.setattr(chip_smoke, "TRAIN_CKPT", str(tmp_path / "ckpt"))
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "FOLDER_DIR", str(tmp_path / "folder"))
    # phase 8's cli.eval runs the vit_b16 preset on the card; here the
    # preset stands for the shrunk configuration
    from quantized_vit_tpu_torch.cli import eval as ceval
    monkeypatch.setattr(ceval, "model_config", lambda args, quant: ViTConfig(
        **dict(SMALL, embed_dim=128), quant=quant))
    record = {"device": "cpu"}
    chip_smoke.run(record)
    names = [k["name"] for k in record["kernels"]]
    assert names == ["fused_quant_matmul", "ln_quant_levels", "fused_mlp",
                     "attention_block",
                     "patch_finalize", "attention_qkv", "block_stack",
                     "fused_mlp_chunked", "attention_qkv_proj",
                     "int4_matmul", "int8_matmul", "quant_matmul_fa",
                     "flash_attention", "gather_rows", "fused_mlp_gather",
                     "exp_pro", "exp_pro2", "exp_attn", "exp_attn2",
                     "exp_epilogue", "exp_fc1", "quant_bwd"]
    # phase 3d: every mode of the six ablation tools, one parity row each
    abl = [r for r in record["parity"] if r["kernel"] in chip_smoke.ABLATIONS]
    assert len(abl) == 6 + 7 + 10 + 3 + 7 + 8 and all(r["ok"] for r in abl)
    # phase 3b's kernel paths at the shrunk widths, every check passed
    paths = record["paths"]
    k13 = {f"k13_{m}{s}" for m in ("vitb_b4", "vith_b1", "vith_b8")
           for s in ("", ":int8")}
    assert set(paths["launches"]) == {"bench_preamble", "vith_branch_b8",
                                      "vith_branch_b8_k3", "profile_kernels",
                                      "lsfq_fc1"} | k13
    assert len(paths["checks"]) == 2 + 3 * 4 + 2 + len(k13)
    assert all(c["ok"] for c in paths["checks"].values())
    assert [f["batch"] for f in record["forward"]
            if f["forward"].startswith("vit_h14")] == [1, 2, 4]
    # phase 3c: the FSDP forward at tp = 1 and 2 equals the single-device
    # one; the spawned processes' parity rows joined phase 2's
    fsdp = [f for f in record["forward"] if f["forward"].startswith("fsdp")]
    assert [f["forward"].split(",")[0] for f in fsdp] == [
        "fsdp_rdma", "fsdp_rdma_vith14"]
    assert all(f["logits_equal"] for f in fsdp)
    assert record["fsdp"]["tp2"]["logits_equal"]
    assert record["fsdp"]["vith_tp2"]["logits_equal"]
    # K15 at both widths, in process and spawned
    k15 = [r["case"] for r in record["parity"]
           if r["kernel"] == "fused_mlp_gather"]
    assert any(c.startswith("vith[") and "tp=2" in c for c in k15)
    assert any(c.startswith("vith[") and "tp=1" in c for c in k15)
    # K14's unaligned and ViT-H rows, in process and spawned
    k14 = [r["case"] for r in record["parity"]
           if r["kernel"] == "gather_rows"]
    for tp in (1, 2):
        assert any("(odd," in c and f"tp={tp}" in c for c in k14)
        assert any("(int8,d320" in c and f"tp={tp}" in c for c in k14)
    # phase 7: the trained params through construct_subnet, export,
    # save/load and the routes; the uniform subnet through the latency
    # entry too
    sub = record["subnet"]
    assert set(sub["uniform"]["forwards"]) == {"b4", "b1", "b3", "latency"}
    assert {"b4", "b1", "b3"} <= set(sub["geta"]["forwards"])
    assert ("latency" in sub["geta"]["forwards"]) != (
        "latency_refused" in sub["geta"])
    assert sub["geta"]["macs"][1] < sub["geta"]["macs"][0]
    # the yardsticks timed beside the subnets, every forward's logits equal
    # to the plain path's
    for ref in ("geta_unpruned", "random_int8", "random_int4"):
        assert set(sub[ref]["forwards"]) == {"b4", "b1", "b3"}
    assert all(f["logits_equal"] for f in record["forward"]
               if f["forward"].startswith(("subnet_", "full_")))
    assert len(set(sub["uniform"]["hidden_per_block"])) == 1
    assert {re.search(r"tp=(\d+)", r["case"]).group(1)
            for r in record["parity"]
            if r["kernel"] in ("gather_rows", "fused_mlp_gather")} == {"1",
                                                                       "2"}
    assert set(record["overlap"]["sweep"]) == {"4MB", "8MB", "16MB", "31MB"}
    # phase 8: HESSO to its target with its subnet served, the CRIC
    # reset, the CLIs equal to direct evaluation, the RPC front
    hesso = record["hesso"]
    assert hesso["steps"] == chip_smoke.HESSO_STEPS
    assert hesso["num_zero_groups"] == hesso["target_redundant_groups"] > 0
    assert hesso["pruned_rows_zero"] and hesso["subnet"]["logits_equal"]
    assert hesso["pruning_period"][-1] == 2
    cric = record["cric"]
    assert cric["reset_bit_for_bit"] and cric["pruned_rows_zero"]
    assert cric["final_redundant"] == cric["target_redundant_groups"] > 0
    assert {1, 2} <= {r["cycle"] for r in cric["rows"]}
    cli = record["cli"]
    assert set(cli["eval"]) == {"full", "subnet"}
    assert all(v["equal"] for v in cli["eval"].values())
    assert cli["predict"]["equal"] and "isn't RGB" in cli["gray_refused"]
    rpc = record["rpc"]
    assert rpc["answers_equal_direct"]
    assert rpc["local"]["requests"] > 0 and rpc["remote"]["requests"] > 0
    assert rpc["local"]["requests"] + rpc["remote"]["requests"] == 64
    assert rpc["worker_exit_after_shutdown"] == 0
    # phase 9: TP within the bf16 criterion, column FSDP equal to the
    # single-device forward, the health check, the collectives a block,
    # the mesh CLI in both modes
    mesh = record["mesh"]
    depth = chip_smoke.main_cfg().depth
    assert set(mesh["tp"]) == {"1", "2"}
    for tp, r in mesh["tp"].items():
        assert r["fsdp_bf16"]["equal"]
        assert r["tp_f32"]["collectives"] == {
            "all_gather:int8": 2 * depth, "reduce_scatter:float32": 2 * depth}
        assert r["fsdp_bf16"]["collectives"] == {"all_gather:int8": 4 * depth}
        assert all(h["ok"] and h["num_devices"] == int(tp)
                   for h in r["health"])
        # the plain collectives are gloo calls: no fence on the CPU (on
        # the card 8 a block at tp > 1, both sides of each collective)
        assert r["tp_bf16"]["fences"] == 0
    assert all(mesh["cli"][m]["ok"] for m in ("tp", "fsdp"))
    assert mesh["cli"]["fsdp"]["input_uint8"]
    assert [r for r in record["parity"] if r["kernel"] == "ln_quant_levels"]
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
    assert ("chain384,f32,int8-stored", 1) in routes
    assert ("block384,bf16,int8-stored", 4) in routes
    # ViT-H/14 with packed int4 on the chain (K2 at the model width)
    assert {("chain_vith14,bf16,int4-packed", b) for b in (1, 2)} <= routes
    assert ("block_vith14,f32,int8-stored", 4) in routes
    # phase 11: every UltraNet check held; the subnet costs less; the
    # five timings taken
    ultra = record["ultranet"]
    assert ultra["int"]["p_bit_equal"] and all(
        ultra["files_identical"].values())
    assert ultra["subnet"]["macs"][1] < ultra["subnet"]["macs"][0]
    assert set(ultra["ms"]) == {"int_forward", "float_eval", "train_step",
                                "subnet_eval", "bf16_cudnn_yardstick"}
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) for k in record["kernels"])
    # phase 12: each family's steps, its plain-chain step, the card-vs-CPU
    # checks, its subnet; LoRA, the Llama-style block and the converter
    fam = record["families"]
    for name in ("resnet20", "mobilenet", "bert_base", "autoencoder"):
        r = fam[name]
        assert len(r["losses"]) == chip_smoke.FAMILY_STEPS
        assert r["plain_vs_k7"]["ok"] and r["plain_vs_k7"]["loss_equal"]
        assert r["card_vs_cpu"]["layers"] == r["quant_layers"]
        assert r["subnet"]["macs"][1] < r["subnet"]["macs"][0]
        assert set(r["ms"]) == {"eval_forward", "train_step"}
    assert fam["resnet20"]["quant_layers"] == 10  # one block a stage here
    assert fam["llama_block"]["gate_follows_fc1"]
    assert fam["lora_dense"]["lora_b_zero_with_base"]
    assert fam["lora_embedding"]["lora_b_zero_with_base"]
    assert fam["model_to_quantize_model"]["forward_rel"] <= 1e-5
