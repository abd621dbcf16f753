"""The check reads each net's first gradient where the optimizer takes it.

Before, the harness worked the gradient out of Adam's first moment over
the first superstep, g = (m₁ − β₁m₀)/(1 − β₁): exact for one update at
β₁ = 0, as ``pigan.train16`` has, but β₁·g₁ + g₂ after HoloGAN's two G
updates at β₁ 0.9, and nothing at all for an optimizer with no first
moment. These tests hold the new reading equal to that formula where the
formula is exact, and show where it was not."""
import contextlib

import torch

from perfbench import harness
from perfbench.harness import patched
from perfbench.tests.tiny import tiny_cell

SEED = 3_000_000_053
NETS = ("discriminator", "generator")


def _moments_plant(freqs: dict, out: dict):
    """A plant that changes nothing and reads every leaf's first-superstep
    gradient as the harness once did: Adam's first moment before the
    net's first update (m₀) and after its ``freqs[net]``-th (m₁), then
    ‖(m₁ − β₁m₀)/(1 − β₁)‖ into ``out``."""
    @contextlib.contextmanager
    def plant(trainer):
        from lightning_gan_zoo_tpu_torch.runtime import steps
        step = steps.optimizer_step
        nets = {net: getattr(trainer.task, net) for net in NETS}
        owner = {id(p): net for net, m in nets.items()
                 for p in m.parameters()}
        calls, before = {}, {}

        def moments(opt, net):
            return {n: (opt.state[p]["exp_avg"].detach().double().clone()
                        if "exp_avg" in opt.state.get(p, {})
                        else torch.zeros_like(p, dtype=torch.float64))
                    for n, p in nets[net].named_parameters()}

        def reading(opt, sched, count):
            net = owner[id(opt.param_groups[0]["params"][0])]
            k = calls.get(net, 0)
            if k == 0:
                before[net] = moments(opt, net)
            step(opt, sched, count)
            calls[net] = k + 1
            if k + 1 == freqs[net]:
                b1 = float(opt.param_groups[0]["betas"][0])
                after = moments(opt, net)
                for n, m1 in after.items():
                    out[f"{net}.{n}"] = float(
                        ((m1 - b1 * before[net][n]) / (1.0 - b1)).norm())

        with patched(steps, "optimizer_step", reading):
            yield
    return plant


def _read(c):
    freqs = {"discriminator": int(c["values"]["optimisation.disc_freq"]),
             "generator": int(c["values"]["optimisation.gen_freq"])}
    from_moments: dict = {}
    run = harness.drive(c, SEED, 0.0, False, "cpu", window=False,
                        plant=_moments_plant(freqs, from_moments))
    return run["reading"], from_moments


def test_one_update_at_beta1_zero_reads_as_the_moments_did():
    """``pigan.train16``'s pattern (one Adam update a net at β₁ 0): the
    gradient at the optimizer's input is the first moment's reading to
    1e-9, leaf by leaf."""
    reading, from_moments = _read(tiny_cell("pigan.train16"))
    assert reading["grad"].keys() == from_moments.keys()
    assert {n.split(".")[0] for n in reading["grad"]} == set(NETS)
    for n, g in reading["grad"].items():
        assert abs(g - from_moments[n]) <= 1e-9 * max(g, 1e-30), n


def test_two_g_updates_at_beta1_09_read_exactly():
    """HoloGAN's pattern (two G updates at β₁ 0.9) on the tiny π-GAN at
    float32: every number of the check reads round-off. The first moment
    would have read G's gradient as β₁·g₁ + g₂ against the reference's g₁,
    a gap of 0.1 or more, the reason the reading moved to the optimizer's
    input."""
    c = tiny_cell("pigan.train16", values={"optimisation.gen_freq": 2,
                                           "optimisation.beta1": 0.9})
    reading, from_moments = _read(c)
    ref = harness.reference_readings(c, SEED, "cpu")
    numbers = harness.compare(reading, ref)
    assert len(numbers) == 6
    for key, v in numbers.items():
        assert v < 1e-4, (key, v)
    g_gaps = harness._leaf_gaps(dict(reading, grad=from_moments), ref,
                                "grad", "generator.")
    assert max(g_gaps.values()) >= 0.1, max(g_gaps.values())
