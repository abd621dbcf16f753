"""The readers of the program's spans on a hand-made trace: the Trainer's
input wait, the superstep's host time, and the card's idle gaps put down to
the span open when each gap began."""
import pytest

from perfbench import spec
from perfbench.trace import Context, Trace

SPAN_METRICS = ("input_wait_ms_per_step", "superstep_host_ms",
                "launch_idle_share", "input_idle_share")


def _reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py",
                            f"reader_{name}").read


def _ctx(kernels, host, stretch_us=2000.0, supersteps=2):
    return Context(Trace(kernels, host, stretch_us / 1e6, supersteps),
                   untraced_s=1.0, untraced_supersteps=10,
                   flops_per_superstep=None)


#: µs. The card's gaps: 50–150 opens in the loader wait, 160–300 in the
#: copy (input, 240); 450–500 in D's backward, 800–820 in G's forward,
#: 1200–1300 in the second superstep (launch, 170); 1050–1100 between the
#: supersteps, in no span. Busy 1040 of 2000.
KERNELS = [("k", 0.0, 50.0), ("memcpy", 150.0, 160.0), ("k", 300.0, 450.0),
           ("k", 500.0, 800.0), ("k", 820.0, 1050.0), ("k", 1100.0, 1200.0),
           ("k", 1300.0, 1500.0)]
HOST = [("zoo.loader_wait", 0.0, 100.0, []),
        ("zoo.to_device", 100.0, 180.0, []),
        ("aten::copy_", 110.0, 170.0, []),
        ("zoo.superstep", 200.0, 1000.0, []),
        ("zoo.d.forward", 210.0, 400.0, []),
        ("zoo.d.backward", 400.0, 600.0, []),
        ("aten::convolution_backward", 420.0, 470.0, []),
        ("zoo.d.update", 600.0, 700.0, []),
        ("zoo.g.forward", 700.0, 850.0, []),
        ("zoo.g.backward", 850.0, 950.0, []),
        ("zoo.g.update", 950.0, 1000.0, []),
        ("aten::item", 1020.0, 1080.0, []),
        ("zoo.superstep", 1150.0, 1400.0, [])]


def test_span_readers():
    ctx = _ctx(KERNELS, HOST)
    assert _reader("superstep_host_ms")(ctx) == pytest.approx(
        (800 + 250) / 2 / 1e3)
    assert _reader("input_wait_ms_per_step")(ctx) == pytest.approx(
        (100 + 80) / 1e3 / 2)
    assert _reader("launch_idle_share")(ctx) == pytest.approx(
        100 * 170 / 2000)
    assert _reader("input_idle_share")(ctx) == pytest.approx(100 * 240 / 2000)


@pytest.mark.parametrize("opens_in,launch,input_", [
    ("zoo.d.backward", 50.0, 0.0),
    ("zoo.to_device", 0.0, 50.0),
    ("zoo.superstep", 50.0, 0.0),
    (None, 0.0, 0.0),
])
def test_one_gap_goes_to_the_span_it_opens_in(opens_in, launch, input_):
    """One 50-µs gap, opening at 400 µs: inside D's backward (itself inside
    the superstep) it is launch idle, inside the copy input idle, at the
    instant a superstep opens launch idle, outside every span neither."""
    kernels = [("k", 0.0, 400.0), ("k", 450.0, 1000.0)]
    host = [("zoo.superstep", 500.0, 900.0, []),
            ("zoo.loader_wait", 100.0, 200.0, [])]
    if opens_in == "zoo.d.backward":
        host += [("zoo.superstep", 300.0, 480.0, []),
                 ("zoo.d.backward", 350.0, 420.0, [])]
    elif opens_in == "zoo.to_device":
        host += [("zoo.to_device", 380.0, 410.0, [])]
    elif opens_in == "zoo.superstep":
        host += [("zoo.superstep", 400.0, 480.0, [])]
    ctx = _ctx(kernels, host, stretch_us=1000.0, supersteps=1)
    assert _reader("launch_idle_share")(ctx) == pytest.approx(
        100 * launch / 1000)
    assert _reader("input_idle_share")(ctx) == pytest.approx(
        100 * input_ / 1000)


def test_launch_and_input_within_the_idle_share():
    ctx = _ctx(KERNELS, HOST)
    idle = _reader("device_idle_share")(ctx)
    assert idle == pytest.approx(100 * (1 - 1040 / 2000))
    launch = _reader("launch_idle_share")(ctx)
    input_ = _reader("input_idle_share")(ctx)
    assert launch + input_ <= idle
    # the remainder: the gap between the supersteps and the stretch's
    # edges (after the last kernel)
    assert idle - launch - input_ == pytest.approx(100 * (50 + 500) / 2000)


def test_silent_without_spans():
    """A program that names no span gives nothing to read; without card
    events the idle readers give nothing."""
    plain = _ctx(KERNELS, [h for h in HOST if not h[0].startswith("zoo.")])
    for name in SPAN_METRICS:
        assert _reader(name)(plain) is None
    no_card = _ctx([], HOST)
    assert _reader("launch_idle_share")(no_card) is None
    assert _reader("input_idle_share")(no_card) is None
    assert _reader("superstep_host_ms")(no_card) == pytest.approx(0.525)


def test_span_metrics_are_reported_in_every_cell():
    """No ``workloads`` key: every cell's Trainer emits the spans."""
    for cell in (w["name"] for w in spec.benchmark()["workloads"]):
        assert set(SPAN_METRICS) <= set(spec.metric_readers(cell, True))
