"""The port's ImageFolder decodes as the JAX package's does by default:
through the native fastimage library (native/fastimage.cpp), PIL only for
a file the library refuses. PNG and JPEG trees written with PIL at 16, 32
and 64 px, 1 and 3 channels: the two readers' arrays are equal bit for
bit. The PIL-only route the port took before differs at 32 px, which is
what the native route repairs."""
import numpy as np
import pytest
from PIL import Image

from lightning_gan_zoo_tpu.data import datasets as jax_datasets
from lightning_gan_zoo_tpu_torch.data import datasets, native_loader


def write_tree(root, ext, n_per_class=3, size=(83, 71), seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size[0], 0:size[1]]
    for c, cls in enumerate(("a_cls", "b_cls")):
        (root / cls).mkdir(parents=True)
        for i in range(n_per_class):
            # smooth gradients plus noise: JPEG keeps them, so the decoders
            # see real content
            base = (xx * (2 + i) + yy * (3 + c))[..., None] * [1, 2, 3]
            arr = (base + rng.integers(0, 64, size + (3,))) % 256
            Image.fromarray(arr.astype(np.uint8)).save(
                root / cls / f"img_{i}.{ext}", quality=90)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    assert native_loader.available(), "the native decoder did not build"
    out = {}
    for ext in ("png", "jpg"):
        root = tmp_path_factory.mktemp(ext)
        write_tree(root, ext)
        out[ext] = root
    return out


@pytest.mark.parametrize("n_channels", [1, 3])
@pytest.mark.parametrize("img_size", [16, 32, 64])
@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_image_folder_matches_jax_default_route(trees, ext, img_size,
                                                n_channels):
    kw = dict(root=str(trees[ext]), img_size=img_size, n_channels=n_channels,
              data_mean=0.5, data_std=0.5)
    got, want = datasets.ImageFolder(**kw), jax_datasets.ImageFolder(**kw)
    idx = [5, 0, 2, 3]
    g, w = got.load(idx), want.load(idx)
    assert g["image"].shape == (4, img_size, img_size, n_channels)
    assert g["image"].dtype == np.float32
    assert np.array_equal(g["image"], w["image"])
    assert np.array_equal(g["label"], w["label"])
    # the port took the native route, not PIL
    native = native_loader.load_batch([got.samples[i][0] for i in idx],
                                      img_size, n_channels, 0.5, 0.5)
    assert np.array_equal(g["image"], native)


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_pil_only_route_differed_at_32px(trees, ext):
    """The fault repaired: PIL's bilinear resize is not the native one, so
    the port's old PIL-only reader gave other pixels than the JAX run."""
    ds = datasets.ImageFolder(root=str(trees[ext]), img_size=32)
    idx = list(range(len(ds)))
    native = ds.load(idx)["image"]
    pil = ds.load_pil([ds.samples[i][0] for i in idx])
    assert native.shape == pil.shape
    assert not np.array_equal(native, pil)
    assert 0 < np.abs(native - pil).max() < 0.05


def test_refused_file_falls_back_to_pil(tmp_path):
    """A format the native decoder does not read (BMP) goes through PIL, as
    in the JAX package."""
    write_tree(tmp_path, "bmp", n_per_class=1)
    kw = dict(root=str(tmp_path), img_size=16, n_channels=3)
    got = datasets.ImageFolder(**kw).load([0, 1])["image"]
    want = jax_datasets.ImageFolder(**kw).load([0, 1])["image"]
    assert np.array_equal(got, want)
    with pytest.raises(IOError):
        native_loader.load_batch([tmp_path / "a_cls" / "img_0.bmp"], 16, 3,
                                 0.5, 0.5)
