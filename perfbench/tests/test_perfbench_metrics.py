"""The per-layer readers on hand-made traces, and the frozen yardstick."""
import math

import pytest

from perfbench import spec, trace
from perfbench.trace import Context, Trace


def _reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py",
                            f"reader_{name}").read


def _trace():
    kernels = [("cudnn_conv_fprop", 0.0, 100.0),
               ("vectorized_elementwise_kernel", 50.0, 150.0),
               ("trunk_fwd_kernel", 200.0, 1200.0),
               ("trunk_bwd_chain_kernel", 1300.0, 2300.0),
               ("trunk_bwd_dw_kernel", 2300.0, 3300.0)]
    host = [("lgzt::siren_trunk_fwd", 190.0, 210.0,
             [[128, 8192, 3], [3, 256], [6, 256, 256], [7, 256],
              [128, 6, 256], [128, 6, 256], [], []]),
            ("lgzt::siren_trunk_bwd", 1250.0, 1260.0,
             [[128, 8192, 3], [3, 256], [6, 256, 256], [7, 256],
              [128, 6, 256], [128, 6, 256], [128, 8192, 256], [], []]),
            ("aten::item", 3300.0, 3900.0, [])]
    return Trace(kernels, host, stretch_s=4000e-6, supersteps=2)


def test_idle_share_and_busy():
    t = _trace()
    assert t.busy_s() == pytest.approx(3150e-6)
    ctx = Context(t, untraced_s=1.0, untraced_supersteps=10,
                  flops_per_superstep=None)
    assert _reader("device_idle_share")(ctx) == pytest.approx(
        100 * (1 - 3150 / 4000))


def test_ms_per_step_by_kind():
    ctx = Context(_trace(), 1.0, 10, None)
    assert _reader("conv_ms_per_step")(ctx) == pytest.approx(0.1 / 2)
    assert _reader("elementwise_ms_per_step")(ctx) == pytest.approx(0.1 / 2)


def test_mfu():
    ctx = Context(_trace(), untraced_s=2.0, untraced_supersteps=10,
                  flops_per_superstep=989e12 * 0.01)
    assert _reader("mfu")(ctx) == pytest.approx(100 * 0.05)
    assert _reader("mfu")(Context(_trace(), 2.0, 10, None)) is None


def test_mfu_leaves_the_profiled_stretch_out():
    """A 12-s window of 40 supersteps whose profiled stretch held 4 s
    (start, 16 supersteps, stop and flush): mfu reads the other 24
    supersteps over the other 8 s."""
    from perfbench import harness

    class Prof:
        def events(self):
            return []

    run = {"prof": Prof(), "stretch_s": 3.5, "stretch_wall_s": 4.0,
           "stretch_steps": 16, "t_open": 100.0, "t_close": 112.0,
           "window_steps": 40}
    ctx = harness.trace_context(run, 989e12 * 0.01)
    assert (ctx.untraced_s, ctx.untraced_supersteps) == (8.0, 24)
    assert _reader("mfu")(ctx) == pytest.approx(100 * 0.01 * 24 / 8.0)


def test_trunk_rooflines():
    ctx = Context(_trace(), 1.0, 10, None)
    fwd = trace.trunk_bound_ms(128, 8192, 256, 7)
    bwd = trace.trunk_bound_ms(128, 8192, 256, 7, backward=True)
    assert _reader("trunk_fwd_roofline")(ctx) == pytest.approx(100 * fwd / 1.0)
    assert _reader("trunk_bwd_roofline")(ctx) == pytest.approx(100 * bwd / 2.0)


def test_silent_without_kernels():
    empty = Context(Trace([], [], 1.0, 2), 1.0, 10, 1e12)
    for name in ("device_idle_share", "trunk_fwd_roofline",
                 "trunk_bwd_roofline", "conv_ms_per_step",
                 "elementwise_ms_per_step"):
        assert _reader(name)(empty) is None


def test_breakdown():
    t = _trace()
    top = t.top_device_ops()
    assert top[0][0] in ("trunk_fwd_kernel", "trunk_bwd_chain_kernel",
                         "trunk_bwd_dw_kernel")
    assert math.isclose(sum(s for _, s in top), 3200e-6)
    gaps = dict(t.idle_gaps())
    # both gaps (150..200, 1200..1300 µs) open while no operator runs
    assert gaps["python"] == pytest.approx(150e-6)


def test_trunk_bound_is_kernel_bench_s():
    """utils/kernel_bench.py::trunk_bound's figures at the main path's
    shapes: 0.8338 ms forward, 2.5014 ms backward, 0.8338 ms at Cin 45."""
    assert trace.trunk_bound_ms(128, 8192, 256, 7) == pytest.approx(
        0.8338, abs=5e-5)
    assert trace.trunk_bound_ms(128, 8192, 256, 7, backward=True) == \
        pytest.approx(2.5014, abs=5e-5)
    assert trace.trunk_bound_ms(128, 8192, 256, 7, cin=45) == \
        pytest.approx(0.8338, abs=5e-5)


def test_kinds_are_the_programs():
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench, profiling
    from lightning_gan_zoo_tpu_torch.utils import profile_superstep as ps
    assert trace.KINDS == ps.KINDS
    spans = [(0, 3), (1, 2), (5, 7)]
    assert trace.union_us(spans) == profiling.union_us(spans)
    for cin, bwd in ((3, False), (3, True), (45, False), (45, True)):
        assert trace.trunk_bound_ms(128, 8192, 256, 7, cin, bwd) == \
            pytest.approx(kernel_bench.trunk_bound(
                128, 8192, 256, 7, cin, bwd)["bound_ms"])
