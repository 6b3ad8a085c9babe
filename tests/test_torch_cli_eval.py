"""Port parity: the inference CLIs (``cli/eval.py``, ``cli/predict.py``)
against the JAX package's, on one JAX-format checkpoint of the tiny
quantized ViT (``vit_tiny_test`` at img 32, ``tests/torch_a1_params.py``)
and a generated image folder.

Both ``cli.eval`` mains (the port with ``--device cpu``) run on the full
checkpoint with and without ``--fp32`` and on a compressed one (a subnet
of the same params, its config in the ``subnet`` meta as ``cli.train``
writes it): top-1, top-5 and the sample count equal, the loss within
``LOSS_RTOL`` relative (the two packages' f32 forwards differ by an ulp
here and there). ``cli.predict`` on an RGB and a grayscale image (which
predict converts): probabilities within ``PROB_ATOL``, the same top-k
order and the same class names."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from quantized_vit_tpu.cli import eval as jeval
from quantized_vit_tpu.cli import predict as jpredict
from quantized_vit_tpu.opt.checkpoint import save_checkpoint as jsave
from quantized_vit_tpu_torch.cli import eval as teval
from quantized_vit_tpu_torch.cli import predict as tpredict

from tests import torch_a1_params as A
from tests.test_torch_data_folder import Image, write_tree

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PROB_ATOL = 1e-5
MODEL_FLAGS = ["--model", "vit_tiny_test", "--img-size", "32",
               "--num-classes", "10"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """The folder (4 classes of 10 images), the full checkpoint and the
    compressed one, all written by the JAX package."""
    root = tmp_path_factory.mktemp("eval")
    data = write_tree(root / "data", classes=4, per_class=10, seed=5,
                      size=(30, 34))
    jmodel, jparams = A.jax_params()
    jsave(str(root / "full"), jparams, None, {"epochs": 1})
    joto, _ = A.otos(jmodel, jparams)
    sparse = joto.random_set_zero_groups(jparams, target_group_sparsity=0.5,
                                         num_group_divisible=2, seed=0)
    sub_model, sub_params = joto.construct_subnet(sparse)
    assert sub_model.cfg.hidden_per_block is not None
    jsave(str(root / "compressed"), sub_params, None,
          {"subnet": dataclasses.asdict(sub_model.cfg)})
    return root, data


@pytest.mark.parametrize("ckpt,extra", [
    ("full", []), ("full", ["--fp32"]), ("compressed", []),
    ("full", ["--batch-size", "8"])],
    ids=["full", "fp32", "subnet", "one-batch"])
def test_eval_equals_jax(run_dir, ckpt, extra, tmp_path):
    root, data = run_dir
    argv = ["--checkpoint", str(root / ckpt), "--dataset", "folder",
            "--data-path", data, "--batch-size", "3", *MODEL_FLAGS, *extra]
    want = jeval.main(argv)
    res = tmp_path / "res" / "eval.json"
    got = teval.main(argv + ["--device", "cpu", "--results", str(res)])
    assert set(got) == set(want) == {"top1", "top5", "loss", "samples"}
    assert got["samples"] == want["samples"] == 8
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert json.loads(res.read_text()) == got


def test_eval_subnet_model_has_the_meta_widths(run_dir):
    root, data = run_dir
    args = teval.parse_args(["--checkpoint", str(root / "compressed"),
                             *MODEL_FLAGS])
    model, params = teval.load_model_for_eval(args, device="cpu")
    assert all(h < 256 for h in model.cfg.hidden_per_block)
    # the model holds the params' tensors themselves
    got = dict(model.named_parameters())
    assert got["head.kernel"].data_ptr() == \
        params["head"]["kernel"].data_ptr()


def test_entry_points_default_to_cuda():
    argv = ["--checkpoint", "c", "--image", "i"]
    assert tpredict.parse_args(argv).device == "cuda"
    assert teval.parse_args(["--checkpoint", "c"]).device == "cuda"


@pytest.fixture(scope="module")
def images(run_dir):
    root, _ = run_dir
    rng = np.random.default_rng(9)
    rgb = root / "one.png"
    Image.fromarray(rng.integers(0, 256, (40, 36, 3)).astype(np.uint8),
                    "RGB").save(rgb)
    gray = root / "gray.png"
    Image.fromarray(rng.integers(0, 256, (28, 28)).astype(np.uint8),
                    "L").save(gray)
    names = root / "classes.json"
    names.write_text(json.dumps({str(i): f"class_{i}" for i in range(10)}))
    return {"rgb": str(rgb), "gray": str(gray), "names": str(names)}


@pytest.mark.parametrize("ckpt", ["full", "compressed"])
@pytest.mark.parametrize("image", ["rgb", "gray"])
def test_predict_equals_jax(run_dir, images, ckpt, image, capsys):
    root, _ = run_dir
    argv = ["--checkpoint", str(root / ckpt), "--image", images[image],
            "--class-index", images["names"], "--topk", "4", *MODEL_FLAGS]
    want = jpredict.main(argv)
    jout = capsys.readouterr().out
    got = tpredict.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want],
                               rtol=0, atol=PROB_ATOL)
    assert [ln.split()[1] for ln in out.splitlines()] == \
        [ln.split()[1] for ln in jout.splitlines()]


def test_load_image_equals_jax(images):
    for k in ("rgb", "gray"):
        got = tpredict.load_image(images[k], 32)
        want = jpredict.load_image(images[k], 32)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
