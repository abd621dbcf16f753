"""The port's yardstick tools (lightning_gan_zoo_tpu_torch/tools/) against
the repo's JAX-side tools/, on the CPU:

  * tools/mlp.py against scikit-learn 1.9's MLPRegressor and MLPClassifier
    at the scorers' settings: predictions, loss curve and iteration count
    equal bit for bit (the copy repeats sklearn's arithmetic; the bound
    reached is 0);
  * the shapes dataset and the labelled real views against the JAX tool's
    renders from the same seed (uint8 images: at most 0.5 % of pixels ±1,
    none further; measured: none differ; float views within 1e-6);
  * the commanded-azimuth sweep of both families at tiny widths in float32,
    from the same converted weights and z, within 1e-4; one sweep scored
    through both scorers gives the same pose MAE, r and identity ratio;
  * the digits reduction against ``jax.image.resize(..., "linear")`` and
    the digits score against the tool's for the same images;
  * a tiny π-GAN trained on the port's shapes data through
    run_network_torch.py and scored from its checkpoint.

Tests that need scikit-learn (its MLPs, the digits) skip without it.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import run_network_torch
import tools.digits_score as jdigits
import tools.make_shapes_dataset as jshapes
import tools.shapes_score as jscore
from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.tools import (digits_score, mlp,
                                               make_shapes_dataset,
                                               shapes_score, yardstick_runs)

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _two_blas_threads():
    """numpy's BLAS on 2 threads, as torch here: the MLP fits share the CPU
    with the other test workers."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(2):
        yield


@pytest.fixture
def sklearn_nn():
    """scikit-learn's neural networks: the reference of tools/mlp.py, and
    the source of the digits; a test that needs them skips without it."""
    return pytest.importorskip(
        "sklearn.neural_network",
        reason="needs scikit-learn (the MLPs' reference, the digits data)")


def _regression_data():
    """Azimuth-like targets from 16 × 16 RGB inputs: the regressor's shape
    at a small size."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (260, 16 * 16 * 3)).astype(np.float32)
    y = (x[:, :12].sum(1) * 8 + 220).astype(np.float32)
    return x[:200], y[:200], x[200:]


@pytest.mark.parametrize("max_iter", [300, 12])
def test_mlp_regressor_equals_sklearn(max_iter, sklearn_nn):
    """The shapes regressor's settings (256 ReLU units, adam, random_state
    0), stopped by tol (300) or by max_iter (12)."""
    x, y, x_test = _regression_data()
    kw = dict(hidden_layer_sizes=(256,), max_iter=max_iter, random_state=0)
    with warnings.catch_warnings():     # sklearn's ConvergenceWarning
        warnings.simplefilter("ignore")
        ref = sklearn_nn.MLPRegressor(**kw).fit(x, y)
    mine = mlp.MLPRegressor(**kw).fit(x, y)
    assert mine.n_iter_ == ref.n_iter_
    assert np.array_equal(mine.loss_curve_, ref.loss_curve_)
    got, want = mine.predict(x_test), ref.predict(x_test)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def digits_classifiers():
    """(the port's digits classifier, its accuracy, the JAX tool's
    scikit-learn one, its accuracy): fitted once for the tests below."""
    pytest.importorskip(
        "sklearn.neural_network",
        reason="needs scikit-learn (the MLPs' reference, the digits data)")
    return (*digits_score.train_classifier(), *jdigits.train_classifier())


def test_mlp_classifier_equals_sklearn_on_digits(digits_classifiers):
    """The digits classifier's settings (128 ReLU units, max_iter 400) on
    the digits scorer's data, against scikit-learn's MLPClassifier with the
    same settings (the JAX tool's): the same iterations, loss curve,
    probabilities and accuracy."""
    clf, acc, ref, ref_acc = digits_classifiers
    images, labels = digits_score.load_digits()
    x = (images / 16.0).reshape(len(images), -1).astype(np.float32)
    assert clf.n_iter_ == ref.n_iter_
    assert np.array_equal(clf.loss_curve_, ref.loss_curve_)
    assert np.array_equal(clf.predict_proba(x[-297:]),
                          ref.predict_proba(x[-297:]))
    assert acc == ref_acc == ref.score(x[-297:], labels[-297:])


def _pngs(root):
    return {p.relative_to(root): np.asarray(Image.open(p)).astype(int)
            for p in sorted(root.rglob("*.png"))}


def test_shapes_dataset_equals_the_jax_tool(tmp_path, monkeypatch):
    """40 + 8 images at 32 px from the same seed, as uint8 PNGs."""
    monkeypatch.setattr("sys.argv", ["make_shapes_dataset.py",
                                     str(tmp_path / "jax"), "40", "8", "32"])
    jshapes.main()
    make_shapes_dataset.write_dataset(tmp_path / "port", 40, 8, 32,
                                      device="cpu", log=lambda m: None)
    want, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert len(want) == 48 and set(got) == set(want)
    diff = np.stack([np.abs(got[k] - want[k]) for k in want])
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.005


def test_labelled_real_views_equal_the_jax_tool():
    """The regressor's labelled views: images within 1e-6, azimuths
    equal."""
    want_x, want_y = jscore.labelled_real(70, seed=123, img=32)
    got_x, got_y = shapes_score.labelled_real(70, seed=123, img=32,
                                              device="cpu")
    assert got_x.shape == want_x.shape == (70, 32, 32, 3)
    assert np.array_equal(got_y, want_y)
    np.testing.assert_allclose(got_x, want_x, atol=1e-6)


#: tiny widths in float32 on top of each family's yardstick overrides
TINY = {
    "pigan": ["model.noise_dim=16", "nerf.siren_dim_hidden=32",
              "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
              "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
              "precision=32"],
    "hologan": ["generator.in_planes=4", "discriminator.out_planes=4",
                "model.noise_dim=8", "precision=32"],
}
TO_TORCH = {"pigan": convert.pigan_generator_state_dict,
            "hologan": convert.generator_state_dict}


def _tiny(family):
    fam = dict(shapes_score.FAMILIES[family])
    fam["overrides"] = fam["overrides"] + TINY[family]
    return fam


@pytest.fixture(scope="module")
def sweeps():
    """family → (JAX tool's sweep, the port's sweep, azimuths)."""
    return {f: _both_sweeps(f) for f in ("pigan", "hologan")}


def _both_sweeps(family):
    """(JAX tool's sweep, the port's sweep, azimuths) from the weights the
    JAX tool's init draws and its PRNGKey(11) z: the tool's task is caught
    as the registry builds it, and its init (jitted: eager is slow on the
    CPU) hands its result to both."""
    import lightning_gan_zoo_tpu.config.registry as jax_registry
    fam = _tiny(family)
    made = {}

    def instantiate(*a, **kw):
        made_here = jax_inst(*a, **kw)
        if hasattr(made_here, "initial_extra"):      # the task, not a net
            init = jax.jit(made_here.init)

            def caught(rng):
                made["vars"] = init(rng)
                return made["vars"]
            made_here.init, made["task"] = caught, made_here
        return made_here

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_registry, "instantiate", instantiate)
        want, azim = jscore.sweep_from_ckpt(None, fam)
    g_vars = made["vars"][0]
    z = np.array(made["task"].sample_z(jax.random.PRNGKey(11),
                                       shapes_score.N_OBJS))

    task = shapes_score.build_task(fam, "cpu")
    task.generator.load_state_dict(TO_TORCH[family](jax.device_get(g_vars)))
    got, azim_p = shapes_score.sweep(task, fam, torch.from_numpy(z))
    assert np.array_equal(azim, azim_p)
    return want, got, azim


@pytest.mark.parametrize("family", ["pigan", "hologan"])
def test_sweep_matches_the_jax_tool(family, sweeps):
    want, got, _ = sweeps[family]
    img = shapes_score.FAMILIES[family]["img"]
    assert got.shape == want.shape == (16, 9, img, img, 3)
    assert want.std() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_one_sweep_scores_the_same_through_both_scorers(sweeps, monkeypatch,
                                                         sklearn_nn):
    """The JAX tool's π-GAN sweep through both scorers, each regressor
    fitted on the same 200 labelled views (100 held out; the renders of
    the two rasterizers differ by ~1e-7, test above): pose MAE, r, the
    ceiling and the identity ratio equal."""
    want, _, azim = sweeps["pigan"]
    fit = jscore.train_regressor
    monkeypatch.setattr(jscore, "train_regressor",
                        lambda img: fit(img, n_train=200, n_test=100))
    real = jscore.labelled_real
    monkeypatch.setattr(shapes_score, "labelled_real",
                        lambda n, seed, img, device: real(n, seed, img))
    monkeypatch.setattr(jscore, "sweep_from_ckpt",
                        lambda ckpt, fam: (want, azim))
    monkeypatch.setattr(shapes_score, "sweep_from_ckpt",
                        lambda ckpt, fam, device: (want, azim, None))
    ref = jscore.main(["--init", "--json"])
    out = shapes_score.main(["--init", "--json", "--device", "cpu",
                             "--n-train", "200", "--n-test", "100"])
    for k in ("pose_mae_deg", "pose_convention", "pose_pearson_r",
              "pose_abs_pearson_r", "real_regressor_mae_deg",
              "albedo_intra_view_std", "albedo_inter_object_std",
              "identity_ratio", "family", "n_objects", "n_views"):
        assert out[k] == ref[k], k


def test_digits_reduction_matches_jax_resize():
    """16 → 8 px: antialiased bilinear against jax.image.resize's "linear"
    (which widens its triangle when it downsamples), within 1e-6."""
    x = np.random.default_rng(0).uniform(0, 1, (64, 16, 16)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (64, 8, 8), "linear"))
    got = digits_score.reduce_to_8px(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_digits_score_matches_the_tool(digits_classifiers):
    """The same 200 images (real val digits mixed with noise) through
    both scorers: the same IS, confidence, coverage and accuracy."""
    rng = np.random.default_rng(1)
    images, _ = digits_score.load_digits()
    imgs = np.concatenate([images[-100:] / 16.0,
                           rng.uniform(0, 1, (100, 8, 8))]).astype(np.float32)
    clf, acc, ref_clf, ref_acc = digits_classifiers
    assert acc == ref_acc
    got, want = digits_score.score(clf, imgs), jdigits.score(ref_clf, imgs)
    assert got == want
    assert got["inception_score_digits"] > 1.5


def test_tiny_pigan_trains_on_the_shapes_data_and_scores(tmp_path, capsys,
                                                         monkeypatch):
    """The yardstick recipe at tiny widths on the CPU: the port's shapes
    data at 16 px, the π-GAN yardstick overrides (tiny) through
    run_network_torch.py for one epoch with a checkpoint, then the port's
    scorer on that checkpoint: every key, finite, from epoch 0."""
    make_shapes_dataset.write_dataset(tmp_path / "shapes", 16, 4, 16,
                                      device="cpu", log=lambda m: None)
    fam = _tiny("pigan")
    fam["overrides"] = [o for o in fam["overrides"] if o not in (
        "dataset=synthetic", "save_ckpts=False", "train.img_size=32",
        "resolution_annealing.resolutions=[16,32,32]",
        "variable_batch_size.batch_sizes=[16,16,16]")] + [
        "train.img_size=16", "resolution_annealing.resolutions=[8,16,16]",
        "variable_batch_size.batch_sizes=[4,4,4]"]
    fam["img"] = 16
    assert run_network_torch.main(
        [*fam["overrides"], "dataset=celeb_a",
         f"filepaths.celeb_a_root={tmp_path / 'shapes'}", "save_ckpts=True",
         "train.num_epochs=1", "~figures", f"output_root={tmp_path}",
         "--device", "cpu"]) == 0
    ckpts = tmp_path / "pigan" / "version_0" / "ckpts"
    monkeypatch.setitem(shapes_score.FAMILIES, "pigan", fam)
    capsys.readouterr()
    out = shapes_score.main([str(ckpts), "--json", "--device", "cpu",
                             "--n-train", "64", "--n-test", "32"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert out["epoch"] == 0 and out["family"] == "pigan"
    for k in ("pose_mae_deg", "pose_pearson_r", "real_regressor_mae_deg"):
        assert np.isfinite(out[k]), k


@pytest.mark.parametrize("run", ["pigan", "hologan", "dc_gan"])
def test_yardstick_run_is_its_scorers_model_with_the_recipe(run):
    """Each quality run composes to its scorer's model config (so its
    checkpoints load into the scorer's task) with the evidence recipe's
    dataset, epochs, validation cadence and seed on top."""
    spec = yardstick_runs.RUNS[run]
    base = (shapes_score.FAMILIES[run]["overrides"] if spec["family"]
            else digits_score.OVERRIDES)
    got = compose(CONF_DIR, spec["overrides"])
    want = compose(CONF_DIR, base)
    for section in ("model", "generator", "discriminator", "nerf",
                    "precision"):
        assert got.get(section) == want.get(section), section
    for key in ("img_size", "features_gen", "features_disc", "batch_size"):
        assert got.train[key] == want.train[key], key
    assert got.seed == 42
    epochs, every = {"pigan": (200, 4), "hologan": (600, 8),
                     "dc_gan": (400, 20)}[run]
    assert (got.train.num_epochs, got.val.every_n_epochs) == (epochs, every)
    if spec["family"]:
        assert got.dataset["_target_"].endswith(".ImageFolder")


def test_yardstick_run_seed_sets_the_config_seed(tmp_path):
    """``--seed`` replaces the recipe's seed (42) and nothing else."""
    run = yardstick_runs.RUNS["hologan"]
    base = compose(CONF_DIR, yardstick_runs.run_overrides(run, [], tmp_path))
    got = compose(CONF_DIR, yardstick_runs.run_overrides(run, [], tmp_path,
                                                         seed=43))
    assert (base.seed, got.seed) == (42, 43)
    assert got.to_container() == {**base.to_container(), "seed": 43}


def test_yardstick_run_keeps_the_scored_epoch_and_scores_it(
        tmp_path, monkeypatch, digits_classifiers):
    """The dc_gan run cut to one epoch on the CPU, epoch 0 kept in place of
    380: its checkpoint is copied aside at validation and scored beside the
    untrained generator and the final state."""
    monkeypatch.setitem(yardstick_runs.RUNS, "dc_gan",
                        {**yardstick_runs.RUNS["dc_gan"], "keep": (0,)})
    clf, acc = digits_classifiers[:2]
    monkeypatch.setattr(digits_score, "train_classifier", lambda: (clf, acc))
    report = yardstick_runs.main(["dc_gan", "--device", "cpu", "--epochs",
                                  "1", "--out", str(tmp_path)])
    assert (tmp_path / "dc_gan" / "snapshots" / "epoch_0").is_dir()
    assert report["training"]["epochs_done"] == 1
    scores = report["scores"]
    assert scores["classifier_val_accuracy"] == round(acc, 4)
    for name in ("init", "epoch_0", "final"):
        assert scores[name]["n"] == 512, name
        assert np.isfinite(scores[name]["inception_score_digits"]), name
