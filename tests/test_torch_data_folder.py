"""Port parity: the image-folder data path (``utils/data.py``:
``read_split_data``, ``ImageFolderDataset``; ``cli/_common.py``'s
``--dataset folder``) against the JAX package's, on a class-per-subfolder
tree of PNG files written here from a numpy seed.

The split lists must be identical and every batch equal byte for byte (no
tolerance): decoded and normalized in one native pass, through a
``transform``, and as plain [0, 1] floats. A file that is not RGB raises
the JAX package's ValueError on both sides."""

import numpy as np
import pytest
import torch

from quantized_vit_tpu.cli import _common as jcommon
from quantized_vit_tpu.utils import data as jdata
from quantized_vit_tpu_torch.cli import _common as common
from quantized_vit_tpu_torch.cli import train as ttrain
from quantized_vit_tpu_torch.utils import data as tdata
from quantized_vit_tpu_torch.utils import DataLoader

Image = pytest.importorskip("PIL.Image")


def write_tree(root, classes=3, per_class=7, seed=0, size=(20, 24)):
    """``root/c<i>/img<j>.png`` RGB files of seeded noise (sizes vary so
    the resize matters); returns the root as a string."""
    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = root / f"c{c}"
        d.mkdir(parents=True)
        for j in range(per_class):
            h, w = size[0] + j, size[1] + 2 * c
            arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            Image.fromarray(arr, "RGB").save(d / f"img{j}.png")
        (d / "notes.txt").write_text("not an image")
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("folder"))


@pytest.mark.parametrize("val_rate,seed", [(0.2, 0), (0.5, 3), (0.0, 1)])
def test_read_split_data_lists_identical(tree, val_rate, seed):
    got = tdata.read_split_data(tree, val_rate=val_rate, seed=seed)
    want = jdata.read_split_data(tree, val_rate=val_rate, seed=seed)
    assert got == want
    assert len(got[0]) + len(got[2]) == 21


def test_read_split_data_missing_root(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdata.read_split_data(str(tmp_path / "none"))


def _datasets(tree, **kw):
    tp, tl, _, _ = jdata.read_split_data(tree, val_rate=0.2)
    return (tdata.ImageFolderDataset(tp, tl, **kw),
            jdata.ImageFolderDataset(tp, tl, **kw))


def _flip(x):
    return x[:, ::-1] * 2.0 - 1.0


@pytest.mark.parametrize("mode", ["normalize", "imagenet", "transform",
                                  "plain"])
@pytest.mark.parametrize("img_size", [16, 32])
def test_image_folder_get_bytes_equal_jax(tree, mode, img_size):
    kw = {"normalize": dict(normalize=(np.full(3, 0.5, np.float32),) * 2),
          "imagenet": dict(normalize=(tdata.IMAGENET_MEAN,
                                      tdata.IMAGENET_STD)),
          "transform": dict(transform=_flip,
                            normalize=(tdata.IMAGENET_MEAN,
                                       tdata.IMAGENET_STD)),
          "plain": {}}[mode]
    ds, jds = _datasets(tree, img_size=img_size, **kw)
    assert len(ds) == len(jds)
    idx = np.asarray([0, 5, len(ds) - 1, 2])
    (x, y), (jx, jy) = ds.get(idx), jds.get(idx)
    assert x.shape == (4, img_size, img_size, 3)
    assert x.dtype == jx.dtype and x.tobytes() == jx.tobytes()
    assert y.dtype == jy.dtype and np.array_equal(y, jy)


@pytest.mark.parametrize("mode", ["L", "RGBA", "P"])
def test_non_rgb_file_raises(tmp_path, mode):
    p = tmp_path / f"x_{mode}.png"
    Image.new(mode, (8, 8)).save(p)
    for mod in (tdata, jdata):
        ds = mod.ImageFolderDataset([str(p)], [0], img_size=8)
        with pytest.raises(ValueError, match="isn't RGB mode"):
            ds.get(np.asarray([0]))


def test_cli_folder_datasets_equal_jax(tree):
    args = ttrain.parse_args(["--dataset", "folder", "--data-path", tree,
                              "--img-size", "16", "--batch-size", "4"])
    got, want = common.build_datasets(args), jcommon.build_datasets(args)
    for g, w in zip(got, want):
        assert g.paths == w.paths and np.array_equal(g.labels, w.labels)
        batches = list(DataLoader(g, 4, shuffle=True, seed=1,
                                  pad_last=True))
        jbatches = list(jdata.DataLoader(w, 4, shuffle=True, seed=1,
                                         pad_last=True))
        assert len(batches) == len(jbatches) > 0
        for b, jb in zip(batches, jbatches):
            for a, c in zip(b, jb):
                assert a.dtype == c.dtype and a.tobytes() == c.tobytes()


def test_cli_checkpoint_formats_still_refused(tmp_path):
    # a reference ViT state dict (UltraNet's ``layers.{i}`` ones load)
    torch.save({"blocks.0.attn.qkv.weight": torch.zeros(6, 2)},
               tmp_path / "model.pth")
    with pytest.raises(NotImplementedError, match="'Other model families"):
        common.load_params_any(str(tmp_path / "model.pth"), device="cpu")
