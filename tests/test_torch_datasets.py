"""The port's dataset readers against the JAX package's, on files the test
writes: MNIST idx files (plain and gzip) and a PNG image folder. The arrays
must be equal (both decode with PIL, the native decoder switched off in
both, and normalise in float32)."""
import gzip
import struct

import numpy as np
import pytest
from PIL import Image

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu.data import datasets as jax_datasets
from lightning_gan_zoo_tpu.data import native_loader
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.data import datasets
from lightning_gan_zoo_tpu_torch.data import native_loader as port_native_loader


def write_idx(path, array, gz=False):
    array = np.asarray(array, np.uint8)
    head = struct.pack(">HBB", 0, 8, array.ndim) + struct.pack(
        ">" + "I" * array.ndim, *array.shape)
    (gzip.open if gz else open)(path, "wb").write(head + array.tobytes())


def write_mnist(root, n=10, gz=False, seed=0):
    raw = root / "MNIST" / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    sfx = ".gz" if gz else ""
    for prefix in ("train", "t10k"):
        write_idx(raw / f"{prefix}-images-idx3-ubyte{sfx}",
                  rng.integers(0, 256, (n, 28, 28)), gz)
        write_idx(raw / f"{prefix}-labels-idx1-ubyte{sfx}",
                  rng.integers(0, 10, n), gz)


@pytest.mark.parametrize("img_size", [28, 32, 64])
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_mnist_matches_jax(tmp_path, img_size, gz, train):
    write_mnist(tmp_path, gz=gz)
    kw = dict(root=str(tmp_path), train=train, img_size=img_size,
              data_mean=0.5, data_std=0.5)
    got = datasets.MNIST(**kw)
    want = jax_datasets.MNIST(**kw)
    assert len(got) == len(want) == 10
    idx = [3, 0, 9, 3]
    g, w = got.load(idx), want.load(idx)
    assert g["image"].shape == (4, img_size, img_size, 1)
    assert g["image"].dtype == np.float32
    np.testing.assert_array_equal(g["image"], w["image"])
    np.testing.assert_array_equal(g["label"], w["label"])


def test_mnist_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        datasets.MNIST(root=str(tmp_path))


def write_folder(root, n_per_class=3, size=(37, 29), seed=0):
    rng = np.random.default_rng(seed)
    for cls in ("b_cls", "a_cls"):
        (root / cls / "sub").mkdir(parents=True)
        for i in range(n_per_class):
            arr = rng.integers(0, 256, size + (3,), dtype=np.uint8)
            where = root / cls / ("sub" if i == 0 else "")
            Image.fromarray(arr).save(where / f"img_{i}.png")


@pytest.mark.parametrize("n_channels", [1, 3])
def test_image_folder_matches_jax_pil_path(tmp_path, n_channels,
                                           monkeypatch):
    write_folder(tmp_path)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(port_native_loader, "library", lambda: None)
    kw = dict(root=str(tmp_path), img_size=16, n_channels=n_channels,
              data_mean=0.5, data_std=0.5)
    got, want = datasets.ImageFolder(**kw), jax_datasets.ImageFolder(**kw)
    assert [s for s in got.samples] == [s for s in want.samples]
    idx = [5, 0, 2, 3]
    g, w = got.load(idx), want.load(idx)
    assert g["image"].shape == (4, 16, 16, n_channels)
    np.testing.assert_array_equal(g["image"], w["image"])
    np.testing.assert_array_equal(g["label"], w["label"])


def test_image_folder_without_images_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        datasets.ImageFolder(root=str(tmp_path))


@pytest.mark.parametrize("dataset,kind", [("mnist", datasets.MNIST),
                                          ("celeb_a", datasets.ImageFolder)])
def test_conf_targets_build_the_port_readers(tmp_path, dataset, kind):
    """The dataset groups of conf/ resolve to the port's readers (the
    reference-era torchvision names included)."""
    write_mnist(tmp_path / "mnist")
    write_folder(tmp_path / "celeb_a" / "train")
    cfg = compose(CONF_DIR, [
        "+expt=dc_gan", f"dataset={dataset}",
        f"filepaths.mnist_parent_directory={tmp_path / 'mnist'}",
        f"filepaths.celeb_a_root={tmp_path / 'celeb_a'}"])
    for split in ("train", "val"):
        ds = instantiate(cfg.dataset[split], img_size=32)
        assert isinstance(ds, kind) and len(ds) > 0
    node = cfg.dataset.train
    node["_target_"] = {"mnist": "torchvision.datasets.MNIST",
                        "celeb_a": "torchvision.datasets.ImageFolder"}[dataset]
    assert isinstance(instantiate(node, img_size=32), kind)
