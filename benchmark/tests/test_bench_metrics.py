"""Each per-layer reader gives the right number on a synthetic record, and
the sweep's roofline counts match a hand count."""

import pytest

import harness

H100 = "NVIDIA H100 80GB HBM3"


def _reader(root, name):
    return harness.load_module(root / "benchmark" / "metrics" / f"{name}.py")


def _events():
    # 3 kernels over a 10 ms window: busy 0-2 ms and 3-4 ms (one overlap)
    return [(0.0, 1500.0, "admm_iterations_kernel(float const*)"),
            (1000.0, 2000.0, "void schulz_tc_cta_kernel<1>(float*)"),
            (3000.0, 4000.0, "Memcpy DtoH (Device -> Pageable)")]


@pytest.mark.parametrize("cell", ["fleet", "one_robot", "sweep"])
def test_idle_share(tiny_root, cell):
    r = _reader(tiny_root, f"device_idle.{cell}")
    rec = {"events": _events(), "busy_s": harness.busy_us(_events()) / 1e6,
           "window_s": 0.010}
    assert harness.busy_us(_events()) == pytest.approx(3000.0)
    assert r.read(rec) == pytest.approx(70.0)
    assert r.read({"events": [], "busy_s": 0.0, "window_s": 0.01}) is None


def test_cold_tick_share(tiny_root):
    r = _reader(tiny_root, "cold_tick_share.fleet")
    rec = {"routes": {"warm": 70, "window": 10, "compact": 5, "cold": 15}}
    assert r.read(rec) == pytest.approx(20.0)
    assert r.read({"routes": {}}) is None


def test_replays_and_kernels_per_tick(tiny_root):
    assert _reader(tiny_root, "replays_per_tick.one_robot").read(
        {"ticks": 4, "replays": 9}) == pytest.approx(2.25)
    fleet = _reader(tiny_root, "replays_per_tick.fleet")
    assert fleet.read({"ticks": 4, "replays": 10}) == pytest.approx(2.5)
    # the CPU's eager tick replays nothing
    assert fleet.read({"ticks": 4, "replays": 0}) is None
    k = _reader(tiny_root, "kernels_per_tick.one_robot")
    # the copy is not a kernel
    assert k.read({"traced": 2, "events": _events()}) == pytest.approx(1.0)
    assert k.read({"traced": 0, "events": _events()}) is None


def test_sweep_counts_match_a_hand_count(tiny_root):
    w = harness.load_module(tiny_root / "benchmark" / "metrics"
                            / "_sweep_work.py")
    settings = {"seg_iters": 25, "segments": 3}
    n, m = 120, 200
    # K3: 19 + 20 + 20 Newton-Schulz steps of two n^3 products a scenario
    mm, ew, nb = w.k3_work(2, settings)
    assert mm == 2 * 59 * 4 * n ** 3
    assert nb == 2 * (2 + 3 + 3) * n * n * 4
    # K6: 75 iterations, one product with the inverse each
    mm6, ew6, nb6 = w.k6_work(2, settings)
    assert mm6 == 2 * 75 * 2 * n * n
    assert ew6 == 2 * 75 * (4 * 360 + 12 * m + 6 * n)
    assert nb6 == 2 * 3 * (n * n + n + 3 * m + 2 * (n + 2 * m)) * 4
    least = w.least_seconds((mm, ew, nb), H100)
    assert least == pytest.approx(max(mm / 165e12 + ew / 67e12,
                                      nb / 3.35e12))
    assert w.least_seconds((mm, ew, nb), "some other card") is None


def test_roofline_share(tiny_root):
    w = harness.load_module(tiny_root / "benchmark" / "metrics"
                            / "_sweep_work.py")
    k3 = _reader(tiny_root, "k3_roofline.sweep")
    settings = {"seg_iters": 25, "segments": 3}
    least = w.least_seconds(w.k3_work(4096, settings), H100)
    # two calls, K3 took 4 x its least time in all
    spent_us = 4 * 2 * least * 1e6
    rec = {"events": [(0.0, spent_us, "schulz_tc_cta_kernel")],
           "traced": 2, "batch": 4096, "settings": settings, "kind": H100}
    assert k3.read(rec) == pytest.approx(25.0)
    assert k3.read(dict(rec, kind="cpu")) is None
    k6 = _reader(tiny_root, "k6_roofline.sweep")
    assert k6.read(rec) is None         # no K6 event to read
