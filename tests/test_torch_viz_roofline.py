"""PyTorch port, the tooling: ``utils/viz.py`` with ``main.py rollout
--trace/--plot``, and ``utils/roofline.py``.

- A ``--device cpu`` rollout with ``--trace`` writes the JAX package's
  npz keys (its ``RolloutTrace`` fields plus ``dt``) at one robot's
  shapes; ``plot_rollout`` and the ``-m`` entry render a figure (in the
  style of tests/test_viz.py); without matplotlib ``--plot`` raises an
  ImportError naming it, after ``--trace`` has written its npz.
- The roofline's stage names, matmul and elementwise flops and bytes
  equal the JAX model's for the bench's warm and cold settings
  (bench.py:470-495), the segmented cold settings of
  tests/test_roofline.py and the controller tick; ``device_peaks``
  resolves the H100 SXM card; ``summarize`` is sane (in the style of
  tests/test_roofline.py).
"""

import os
import sys

import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch import main as t_main
from go1_qp_mpc_controller_torch.ctrl import controller as t_ctrl
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.utils import roofline
from go1_qp_mpc_controller_torch.utils import viz
from go1_qp_mpc_controller_tpu.ctrl import controller as j_ctrl
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.ops import admm as j_admm
from go1_qp_mpc_controller_tpu.utils import roofline as j_roofline

torch.set_num_threads(1)
STEPS = 30
# bench.py:470-495's cold and warm settings, tests/test_roofline.py's
# segmented cold settings
SETTINGS = {
    "bench_cold": dict(seg_iters=40, segments=1, polish=False,
                       schulz_l0=1e-6, schulz_hi_tail=1,
                       schulz_impl="pallas"),
    "bench_warm": dict(seg_iters=15, segments=1, polish=False,
                       schulz_refine=1, schulz_impl="pallas"),
    "segmented": dict(seg_iters=30, segments=2, first_seg_iters=20,
                      polish=False, schulz_l0=1e-6, schulz_l0_first=1e-3,
                      schulz_l0_refine=1e-4, schulz_hi_tail=1,
                      schulz_impl="pallas"),
}


@pytest.fixture(scope="module")
def trace_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "rollout.npz")
    t_main.main(["--device", "cpu", "rollout", "--steps", str(STEPS),
                 "--trace", path])
    return path


def test_rollout_trace_has_jax_keys(trace_npz):
    loaded = viz.load_trace(trace_npz)
    assert set(loaded) == set(j_rollout.RolloutTrace._fields) | {"dt"}
    assert float(loaded["dt"]) == 0.002
    assert loaded["root_pos"].shape == (STEPS, 3)
    assert loaded["foot_pos_abs"].shape == (STEPS, 4, 3)
    assert loaded["foot_forces_grf"].shape == (STEPS, 4, 3)
    assert loaded["contacts"].dtype == np.bool_
    assert loaded["terrain_pitch"].shape == (STEPS,)
    for k, v in loaded.items():
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), k


def test_plot_rollout_and_module_entry(trace_npz, tmp_path):
    png = str(tmp_path / "trot.png")
    out = viz.plot_rollout(viz.load_trace(trace_npz), png, title="test")
    assert os.path.getsize(out) > 20_000        # a real rendered figure
    svg = str(tmp_path / "trot.svg")
    viz.plot_rollout(viz.load_trace(trace_npz), svg)
    assert os.path.getsize(svg) > 10_000
    entry = str(tmp_path / "entry.png")
    assert viz.main([trace_npz, entry]) == 0
    assert os.path.exists(entry)


def test_plot_without_matplotlib_names_it(tmp_path, monkeypatch):
    """The card's machine has no matplotlib: ``--trace`` still writes its
    npz, ``--plot`` then raises an ImportError that names matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    npz = str(tmp_path / "t.npz")
    with pytest.raises(ImportError, match="matplotlib"):
        t_main.main(["--device", "cpu", "rollout", "--steps", "2",
                     "--trace", npz, "--plot", str(tmp_path / "t.png")])
    assert set(viz.load_trace(npz)) == set(j_rollout.RolloutTrace._fields) \
        | {"dt"}


def _stages(name, fn):
    t = getattr(roofline, fn)(t_admm.ADMMSettings(**SETTINGS[name]))
    j = getattr(j_roofline, fn)(j_admm.ADMMSettings(**SETTINGS[name]))
    return t, j


@pytest.mark.parametrize("stages_fn", ["warm_tick_stages",
                                       "cold_solve_stages",
                                       "ctrl_tick_stages"])
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_stages_equal_jax(name, stages_fn):
    got, want = _stages(name, stages_fn)
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        assert g.matmul_flops == w.mxu_flops, g.name
        assert g.elementwise_flops == w.vpu_flops, g.name
        assert g.hbm_bytes == w.hbm_bytes, g.name
        assert 0.0 <= g.tf32x3_flops <= g.matmul_flops, g.name


def test_controller_warm_tick_and_ekf_equal_jax():
    got = roofline.ctrl_tick_stages(t_ctrl.WARM_SETTINGS)
    want = j_roofline.ctrl_tick_stages(
        j_ctrl.WARM_SETTINGS._replace(schulz_impl="pallas"))
    assert [(s.name, s.matmul_flops, s.elementwise_flops, s.hbm_bytes)
            for s in got] == [(s.name, s.mxu_flops, s.vpu_flops, s.hbm_bytes)
                              for s in want]


def test_precision_mapping():
    """3xTF32 only on the n = 120 Schulz middles: the cold schedule's
    middle steps (all but hi_tail), none on the one-step warm refine (its
    one step is the FP32 tail), none outside the Schulz stages."""
    cold = {s.name: s for s in roofline.cold_solve_stages(
        t_admm.ADMMSettings(**SETTINGS["bench_cold"]))}
    schulz = cold["schulz_cold"]
    mm = 2.0 * 128 ** 3
    assert schulz.matmul_flops - schulz.tf32x3_flops == 2 * mm   # 1 step
    warm = roofline.warm_tick_stages(
        t_admm.ADMMSettings(**SETTINGS["bench_warm"]))
    assert sum(s.tf32x3_flops for s in warm) == 0.0
    assert all(s.tf32x3_flops == 0.0 for n, s in cold.items()
               if "schulz" not in n)
    assert all(s.tf32x3_flops == 0.0 for s in roofline.ekf_stages())


def test_device_peaks_resolution():
    pk = roofline._peaks_of("NVIDIA H100 80GB HBM3")
    assert pk.known and pk == roofline.H100_SXM
    assert (pk.fp32_flops, pk.tf32_flops, pk.bf16_flops, pk.hbm_bytes) == (
        67e12, 495e12, 989e12, 3.35e12)
    other = roofline._peaks_of("NVIDIA A100-SXM4-80GB")
    assert not other.known and other.name == "NVIDIA A100-SXM4-80GB"
    assert not roofline.device_peaks("cpu").known


def test_summarize_fields_sane():
    peaks = roofline.H100_SXM
    stages = roofline.cold_solve_stages(
        t_admm.ADMMSettings(**SETTINGS["bench_cold"]))
    byts = sum(s.hbm_bytes for s in stages)
    ops = sum((s.matmul_flops - s.tf32x3_flops + s.elementwise_flops)
              / peaks.fp32_flops + 3 * s.tf32x3_flops / peaks.tf32_flops
              for s in stages)
    rate = 0.5 / max(byts / peaks.hbm_bytes, ops)
    out = roofline.summarize(stages, rate, peaks)
    for key in ("mfu", "hbm_frac", "roofline_frac"):
        assert 0.0 < out[key] <= 1.0, (key, out)
    assert out["bound"] in ("operations", "bytes")
    assert out["roofline_items_per_s"] > rate
    assert out["device_peaks_known"]
    np.testing.assert_allclose(out["roofline_frac"], 0.5, rtol=1e-3)
    out2 = roofline.summarize(stages, 2 * rate, peaks)
    np.testing.assert_allclose(out2["roofline_frac"],
                               2 * out["roofline_frac"], rtol=1e-3)
    want = j_roofline.summarize(
        j_roofline.cold_solve_stages(
            j_admm.ADMMSettings(**SETTINGS["bench_cold"])), rate,
        j_roofline._PEAKS["v5lite"])
    for key in ("flops_per_item", "mxu_flops_per_item",
                "hbm_bytes_per_item"):
        assert out[key] == want[key], key
    assert set(out) == set(want)
