"""The plain references against the program at float32, their inputs and
draws, and their FLOP count."""
import numpy as np
import pytest
import torch

from perfbench import harness, spec
from perfbench.reference import plain
from perfbench.tests import tiny
from perfbench.tests.tiny import tiny_cell

SEED = 3_000_000_029
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_init_and_draws_are_the_programs(name):
    """Worked out again from the seed, the reference's weights are the
    program's bit for bit, and so are its z draws."""
    from lightning_gan_zoo_tpu_torch.config import compose
    from lightning_gan_zoo_tpu_torch.runtime import loop
    c = tiny_cell(name)
    cfg = compose(spec.ROOT / "conf", spec.overrides(c, SEED))
    trainer = loop.Trainer(cfg, "cpu")
    ref = spec.reference(c["config"]["name"]).Reference(c["values"], "cpu")
    ref.init_from_seed(SEED)
    for net, mine in ((trainer.task.generator, ref.G),
                      (trainer.task.discriminator, ref.D)):
        theirs, ours = dict(net.named_parameters()), dict(
            mine.named_parameters())
        assert theirs.keys() == ours.keys()
        for k in theirs:
            assert torch.equal(theirs[k], ours[k]), k
    assert torch.equal(trainer.task.sample_z(3), ref.sample_z(3))


@pytest.mark.parametrize("name", CELLS)
def test_images_and_order_are_the_loaders(name):
    """The reference's superstep batch (its module's own, or the default)
    is the one the program's Trainer hands the superstep, leaf by leaf, in
    the first supersteps of epochs 0 and 1."""
    c = harness.prepare(tiny_cell(name))
    for epoch in (0, 1):
        batch, accum, _ = plain.schedule_at(c["values"], epoch)
        ref = spec.reference(c["config"]["name"]).Reference(c["values"],
                                                            "cpu")
        n_micro = (ref.disc_freq + ref.gen_freq) * accum
        for k, want in enumerate(tiny.trainer_batches(c, SEED, epoch, 3)):
            got = harness.superstep_batch(c, SEED, epoch, k, batch, n_micro,
                                          "cpu")
            tiny.assert_same_batch(got, want,
                                   f"epoch {epoch} superstep {k}: ")


def test_synthetic_images_and_order_are_the_loaders(tmp_path):
    """The default batch's images are the synthetic dataset's through the
    loader, stack by stack, under a normalisation that moves them; the
    dataset makes them in memory and never touches its configured root
    (conf/dataset/synthetic.yaml names /tmp/synthetic)."""
    from lightning_gan_zoo_tpu_torch.data.datasets import Synthetic
    from lightning_gan_zoo_tpu_torch.data.pipeline import EpochLoader
    values = dict(tiny_cell("pigan.train16")["values"], **{
        "train.img_size": 16, "train.data_mean": 0.5, "train.data_std": 0.5})
    root = tmp_path / "synthetic"
    ds = Synthetic(n=48, img_size=16, data_mean=0.5, data_std=0.5,
                   root=str(root))
    loader = EpochLoader(ds, 4, n_micro=2, seed=SEED)
    stacks = list(loader.epoch(1))
    for k in range(3):
        got = plain.superstep_batch(values, SEED, 1, k, 4, 2, "cpu")
        want = torch.from_numpy(stacks[k]["image"]).permute(0, 1, 4, 2, 3)
        assert got.keys() == {"image"}
        assert torch.equal(got["image"], want)
    assert not root.exists()


@pytest.mark.parametrize("name", CELLS)
def test_program_at_float32_is_the_reference(name):
    """At float32 the program's first supersteps agree with the
    reference to round-off in every compared number."""
    c = tiny_cell(name)
    run = harness.drive(c, SEED, 0.0, False, "cpu", window=False)
    numbers = harness.check(c, SEED, run["reading"], "cpu")
    assert len(numbers) == 6
    for key, x in numbers.items():
        assert x["value"] < 1e-4, (key, x)


def test_flop_count_by_hand():
    """One matmul and one convolution counted as 2·M·K·N and
    2·B·Cout·Cin·k²·Ho·Wo."""
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    x, w = torch.ones(2, 4, 8, 8), torch.ones(6, 4, 3, 3)
    assert plain.count_flops(
        lambda: (a @ b, torch.nn.functional.conv2d(x, w, padding=1))) == \
        2 * 3 * 5 * 7 + 2 * 2 * 6 * 4 * 9 * 8 * 8


def test_pigan_discriminator_flops_by_hand():
    """The tiny progressive D (32 px, features 8, channels 8, 256, 400,
    400, 400) on two images at 16 px: from_rgb_16 (3+2 coordinates → 256,
    1×1) at 16², block_16 (258 → 400 3×3, 402 → 400 3×3 at 16², the 1×1
    stride-2 shortcut at 8²), block_8 and block_4 (402 → 400 twice at 8²,
    4², shortcuts at 4², 2²), final_conv (402 → 1, 2×2) at 1²;
    2·Cout·Cin·k²·positions each."""
    c = tiny_cell("pigan.train16")
    ref = spec.reference("pigan_small").Reference(c["values"], "cpu")
    ref.init_from_seed(SEED)
    per_image = (2 * 256 * 5 * 256
                 + 2 * 400 * 258 * 9 * 256 + 2 * 400 * 402 * 9 * 256
                 + 2 * 400 * 258 * 64
                 + 2 * (2 * 400 * 402 * 9 * 64) + 2 * 400 * 402 * 16
                 + 2 * (2 * 400 * 402 * 9 * 16) + 2 * 400 * 402 * 4
                 + 2 * 402 * 4)
    with torch.no_grad():
        got = plain.count_flops(lambda: ref.D(
            torch.ones(2, 3, 16, 16), torch.zeros(()), 16))
    assert got == 2 * per_image


def test_pigan_field_flops_by_hand():
    """The tiny π-GAN field (noise 16, 2 FiLM'd layers of 32) at 4 points
    of one sample: the mappings (16→32→32→32, heads 32→64 twice; 16→16×3,
    heads 16→32 twice), the SIREN (3→32, 32→32, 32→32), the α head
    (32→1), the colour layer (35→32) and head (32→3)."""
    c = tiny_cell("pigan.train16")
    ref = spec.reference("pigan_small").Reference(c["values"], "cpu")
    ref.init_from_seed(SEED)
    field = ref.G.nerf_renderer.rad_field
    mapping = 2 * (16 * 32 + 32 * 32 + 32 * 32 + 2 * 32 * 64)
    rgb_mapping = 2 * (3 * 16 * 16 + 2 * 16 * 32)
    rows = 4
    per_row = 2 * (3 * 32 + 32 * 32 + 32 * 32 + 32 + 35 * 32 + 32 * 3)
    with torch.no_grad():
        got = plain.count_flops(lambda: field(
            torch.ones(1, 2, 2, 3), torch.ones(1, 2, 3), torch.ones(1, 16)))
    assert got == mapping + rgb_mapping + rows * per_row


def test_superstep_count_is_linear_in_the_batch():
    """flops_per_superstep counts a batch of one and scales it: the same
    as counting the whole batch."""
    c = tiny_cell("pigan.train16")
    values = c["values"]
    ref = spec.reference("pigan_small").Reference(values, "cpu")
    ref.init_from_seed(SEED)
    one = plain.superstep_batch(values, SEED, 1, 0, 4, 2, "cpu")
    at4 = plain.flops_of_superstep(ref, one, 1)
    assert harness.flops_per_superstep(c, SEED, 1, "cpu") == at4


def test_quantised_products_round_to_e4m3():
    num = plain.Numerics(quant=True)
    x = torch.linspace(-1, 1, 1001)
    q = num.q(x)
    assert (q - x).abs().max() > 1e-3
    assert torch.equal(num.q(q), q)
    assert np.isclose(float(q.abs().max()), 1.0)
