"""The benchmark's CPU tests run the harness on a copy of the checkout in
a temporary directory: ``benchmark/`` and ``BENCHMARK.json`` copied, the
program linked, and tiny variants of every cell added as new files (the
same traffic at a few robots or scenarios), so that the rest of a run
is driven on the CPU's plain path.

    python3 -m pytest benchmark/tests -q        # CPU; card tests skip
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "benchmark"))
sys.path.insert(1, str(REPO))
PROGRAM = "go1_qp_mpc_controller_torch"
# the tiny sizes of each entry's traffic
TINY = {
    "fleet": dict(batch=6, episode_ticks=150, warmup_ticks=42,
                  check_ticks_per_route=1, fail_episodes=1,
                  trace_seconds=0.5),
    "one_robot": dict(episode_ticks=150, stand_ticks=40, warmup_ticks=20,
                      check_ticks_per_route=3, fail_episodes=1,
                      trace_seconds=0.5),
    "sweep": dict(batch=8, pool=2, warmup_calls=1, check_calls=1,
                  fail_passes=2, trace_seconds=0.5),
}


def make_tiny_root(dest, sizes=None):
    """A checkout at ``dest`` with a ``tiny-<cell>`` beside every cell
    (``sizes``: {entry: traffic keys} over :data:`TINY`'s)."""
    dest = Path(dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / PROGRAM).symlink_to(REPO / PROGRAM)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in list(bench["workloads"]):
        mix = json.loads((dest / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        mix.update(TINY[mix["entry"]])
        mix.update((sizes or {}).get(mix["entry"], {}))
        if "segments" in mix:
            # the same segments, shortened to the tiny episode
            scale = (mix["episode_ticks"] - mix["stand_ticks"]) / sum(
                mix["segments"])
            mix["stand_segment"] = round(mix["stand_segment"] * scale)
            mix["segments"] = [round(n * scale) for n in mix["segments"]]
        (dest / "benchmark" / "traffic" / f"tiny-{w['traffic']}.json") \
            .write_text(json.dumps(mix))
        tiny = dict(w, name=f"tiny-{w['name']}", traffic=f"tiny-{w['traffic']}")
        bench["workloads"].append(tiny)
        shutil.copy(dest / "benchmark" / "limits" / f"{w['name']}.json",
                    dest / "benchmark" / "limits" / f"{tiny['name']}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(tiny["name"])
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(scope="session")
def run_module(tiny_root):
    import harness
    return harness.load_module(tiny_root / "benchmark" / "run.py",
                               "bench_run")


def run_cell(run_module, root, workload, capsys, seed=1234567890123,
             seconds=1.0, trace=0):
    """One run of ``workload`` on the CPU: (exit code, result dict or None,
    standard error)."""
    import torch
    torch.set_num_threads(2)
    rc = run_module.main(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         root=root, device="cpu")
    out, err = capsys.readouterr()
    lines = [ln for ln in out.strip().split("\n") if ln]
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err
