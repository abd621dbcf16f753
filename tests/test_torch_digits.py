"""The digits the port ships (lightning_gan_zoo_tpu_torch/tools/digits.npz)
and the digits yardstick without scikit-learn, on the CPU:

  * ``digits_score.load_digits()`` equals ``sklearn.datasets.load_digits()``
    bit for bit (dtype, shape, every value), and ``--write-digits`` remakes
    the shipped arrays from scikit-learn's ``digits.csv.gz``;
  * the port's ``make_digits_dataset`` writes the idx files of the JAX
    tool (tools/make_digits_dataset.py) byte for byte;
  * with scikit-learn unimportable, as on the card's machine, the data, the
    classifier and ``yardstick_runs dc_gan`` (cut to one epoch) run, and
    nothing tries to import it;
  * ``yardstick_runs --seed`` reaches the untrained generator's weights.

Tests that hold the port against scikit-learn skip without it.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tools.make_digits_dataset as jmake
from lightning_gan_zoo_tpu_torch.tools import digits_score, yardstick_runs

torch.set_num_threads(2)

IDX_FILES = [f"{p}-{k}-ubyte" for p in ("train", "t10k")
             for k in ("images-idx3", "labels-idx1")]


@pytest.fixture(scope="module", autouse=True)
def _two_blas_threads():
    """numpy's BLAS on 2 threads, as torch here: the MLP fit shares the CPU
    with the other test workers."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(2):
        yield


@pytest.fixture
def sklearn_datasets():
    return pytest.importorskip(
        "sklearn.datasets", reason="needs scikit-learn (the digits' source)")


def test_shipped_digits_equal_sklearns(sklearn_datasets):
    ref = sklearn_datasets.load_digits()
    images, labels = digits_score.load_digits()
    for got, want in ((images, ref.images), (labels, ref.target)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    assert (images.dtype, images.shape) == (np.float64, (1797, 8, 8))
    assert labels.dtype == np.int64


def test_write_digits_remakes_the_shipped_file(tmp_path, monkeypatch,
                                               sklearn_datasets):
    """``--write-digits`` on scikit-learn's csv: uint8 arrays equal to the
    shipped ones."""
    src = Path(sklearn_datasets.__file__).parent / "data" / "digits.csv.gz"
    monkeypatch.setattr(digits_score, "DIGITS_FILE", tmp_path / "d.npz")
    assert digits_score.main(["--write-digits", str(src)]) is None
    with np.load(tmp_path / "d.npz") as got, \
            np.load(Path(digits_score.__file__).with_name("digits.npz")) \
            as want:
        assert set(got.files) == set(want.files) == {"images", "labels"}
        for k in want.files:
            assert got[k].dtype == want[k].dtype == np.uint8, k
            assert np.array_equal(got[k], want[k]), k


def test_write_digits_refuses_other_data(tmp_path):
    import gzip
    src = tmp_path / "not_digits.csv.gz"
    with gzip.open(src, "wt") as f:
        f.write("\n".join(",".join(["17"] * 65) for _ in range(1797)))
    with pytest.raises(ValueError, match="not the 1,797"):
        digits_score.write_digits_file(src, tmp_path / "d.npz")
    assert not (tmp_path / "d.npz").exists()


def test_make_digits_dataset_equals_the_jax_tool(tmp_path, sklearn_datasets):
    raw = digits_score.make_digits_dataset(tmp_path / "port")
    want = jmake.make_digits_dataset(tmp_path / "jax")
    for name in IDX_FILES:
        assert (raw / name).read_bytes() == (want / name).read_bytes(), name


def test_digits_yardstick_runs_without_sklearn(tmp_path, monkeypatch):
    """The card's machine has no scikit-learn: with it unimportable, the
    data, the idx files and the classifier come from the shipped file and
    tools/mlp.py, and the dc_gan run cut to one epoch trains and scores
    the untrained generator, epoch 0 and the final state."""
    sk = ["sklearn", *[m for m in sys.modules if m.startswith("sklearn.")]]
    for name in sk:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import sklearn.datasets  # noqa: F401

    images, labels = digits_score.load_digits()
    assert images.shape == (1797, 8, 8) and np.bincount(labels).min() > 150
    raw = digits_score.make_digits_dataset(tmp_path / "data")
    assert sorted(p.name for p in raw.iterdir()) == sorted(IDX_FILES)
    clf, acc = digits_score.train_classifier()
    assert round(acc, 4) == 0.9158     # the card's too (chip_smoke.py)
    monkeypatch.setattr(digits_score, "train_classifier", lambda: (clf, acc))
    monkeypatch.setitem(yardstick_runs.RUNS, "dc_gan",
                        {**yardstick_runs.RUNS["dc_gan"], "keep": (0,)})
    report = yardstick_runs.main(["dc_gan", "--device", "cpu", "--epochs",
                                  "1", "--out", str(tmp_path)])
    assert "skipped" not in report and "sklearn" not in report
    assert report["training"]["epochs_done"] == 1
    scores = report["scores"]
    assert scores["classifier_val_accuracy"] == round(acc, 4)
    for name in ("init", "epoch_0", "final", "real_val"):
        assert np.isfinite(scores[name]["inception_score_digits"]), name
        assert sum(scores[name]["class_coverage"].values()) == \
            scores[name]["n"], name
    loaded = {m for m, mod in sys.modules.items()
              if m.split(".")[0] == "sklearn" and mod is not None}
    assert not loaded


def test_seed_reaches_the_untrained_generator():
    """``yardstick_runs --seed`` scores the untrained row at that seed's
    weights; the recipe's seed is 42."""
    base = digits_score.generate(None, 64, "cpu")
    assert np.array_equal(digits_score.generate(None, 64, "cpu", 42), base)
    assert not np.allclose(digits_score.generate(None, 64, "cpu", 43), base)
