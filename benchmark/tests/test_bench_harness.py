"""The run's contract: the last line's keys, the no-JAX check by whole
top-level names, the refusal without a card, and pieces found by name."""

import json

import pytest

import harness
from conftest import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = {"go1_qp_mpc_controller_torch": 1,
              "go1_qp_mpc_controller_torch.ops.admm": 1, "jaxtyping": 1,
              "numpy": 1}
    assert harness.forbidden_modules(loaded) == []
    for bad in ("go1_qp_mpc_controller_tpu", "go1_qp_mpc_controller_tpu.ops",
                "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"):
        assert harness.forbidden_modules(dict(loaded, **{bad: 1})) == [bad]


def test_no_jax_is_loaded_by_the_reference(tiny_root):
    import sys

    from reference import check  # noqa: F401
    assert harness.forbidden_modules(sys.modules) == []


@pytest.mark.parametrize("workload", ["tiny-mpc-fleet-trot-4096",
                                      "tiny-mpc-one-robot-joystick",
                                      "tiny-mpc-sweep-4096"])
def test_last_line_has_the_contract_keys(tiny_root, run_module, capsys,
                                         workload):
    rc, res, err = run_cell(run_module, tiny_root, workload, capsys)
    assert rc == 0, err
    assert list(res)[:5] == KEYS and list(res)[-1] == "compared"
    assert res["correct"] is True, err
    assert res["failed"] == 0 and res["attempted"] > 0
    bench = harness.bench_file(tiny_root)
    want = {m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    # each number compared ends standard error beside its limit
    tail = err.strip().split("\n")[-len(res["compared"]):]
    for line, c in zip(tail, res["compared"]):
        assert line.startswith(f"compared {c['name']}:")
        assert repr(c["limit"]) in line


def test_traced_run_reports_per_layer_metrics(tiny_root, run_module,
                                              capsys):
    rc, res, err = run_cell(run_module, tiny_root, "tiny-mpc-fleet-trot-4096",
                            capsys, trace=1)
    assert rc == 0, err
    # the CPU has no device trace: only the program counter is read
    assert set(res["metrics"]) == {"cold_tick_share.fleet"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(tiny_root, run_module, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run_module.main(["--workload", "mpc-sweep-4096", "--seed", "1",
                          "--seconds", "1"], root=tiny_root)
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "no result" in err


def test_a_new_mix_and_metric_are_new_files(tiny_root, run_module, capsys):
    """A cell, its traffic and a per-layer metric added as new files, with
    no edit to a file that was there, run."""
    bench_dir = tiny_root / "benchmark"
    mix = json.loads((bench_dir / "traffic" / "tiny-fleet-trot.json")
                     .read_text())
    mix.update(vx=[0.2, 0.2], batch=3)
    (bench_dir / "traffic" / "dummy-walk.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "ticks_seen.fleet.py").write_text(
        "def read(record):\n    return float(record['ticks'])\n")
    (bench_dir / "limits" / "dummy-cell.json").write_text(
        (bench_dir / "limits" / "tiny-mpc-fleet-trot-4096.json").read_text())
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    saved = json.dumps(bench)
    bench["workloads"].append({"name": "dummy-cell", "config": "go1-gazebo-mpc",
                               "traffic": "dummy-walk", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-mpc-fleet-trot-4096" in m.get("workloads", []):
            m["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "ticks_seen.fleet", "unit": "ticks",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "fleet_ticks_per_s",
                               "workloads": ["dummy-cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        rc, res, err = run_cell(run_module, tiny_root, "dummy-cell", capsys,
                                trace=1)
    finally:
        (tiny_root / "BENCHMARK.json").write_text(saved)
    assert rc == 0, err
    assert res["metrics"]["ticks_seen.fleet"]["value"] == res["record"]["ticks"]
    # whole episodes of the new mix's three robots
    assert res["attempted"] == 3 * mix["episode_ticks"] * mix[
        "fail_episodes"]
