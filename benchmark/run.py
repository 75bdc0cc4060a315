"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration is ``benchmark/configs/<config>.json``,
its traffic ``benchmark/traffic/<traffic>.json``, which names the entry
(``benchmark/entries/<entry>.py``) whose loop drives the program, and its
limits for ``correct`` are ``benchmark/limits/<cell>.json``. Each per-layer
metric is read by ``benchmark/metrics/<metric>.py``.

A run: set-up (load, build or load the kernels, make the inputs on the
device from the seed, warm up the cell's own routes), a window of
``--seconds``, an untimed finish of the whole episodes or passes that
``attempted`` and ``failed`` cover (a fixed number from the traffic file,
so the count does not move with where the window ends), then the
reference check of what the window produced. With
``--trace 0`` the result line holds the cell's end-to-end metrics; with
``--trace 1`` the window's first ``trace_seconds`` (from the traffic file)
run under torch.profiler and the line holds the per-layer metrics. The
last line of standard output is one JSON object; the numbers compared for
``correct`` end standard error, each beside its limit.

Exits 2 without a result when there is no CUDA card (or fewer than the
cell asks for), and 3 when a JAX module was loaded.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import harness  # noqa: E402


def _cache_dirs(root):
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels build into ``build/kernels/`` there)."""
    build = Path(root) / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit():
    """The card's power limit in W from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split("\n")[0]
        return float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def per_layer(bench, cell_name, record):
    """{metric: {"value", "unit"}} of the per-layer metrics that list this
    cell (or list no cells), read by their own files; a reader that
    returns None finds nothing to read and its metric is left out."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, root=None, device=None):
    """One run; returns the exit code. ``root`` is the checkout (default:
    this file's parent's parent); ``device`` None is the CUDA card and
    checks that the cell's cards are there (tests pass "cpu" to drive the
    rest of a run on the plain path)."""
    args = parse(argv)
    root = Path(root) if root is not None else HERE.parent
    _cache_dirs(root)
    bench, work, config, mix, limits = harness.load_cell(root, HERE,
                                                         args.workload)

    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(work["chips"])):
            print(f"no result: the cell needs {work['chips']} CUDA card(s), "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        # one process, one host thread for the program's CPU-side work: the
        # host-paced cells then contend with nothing of their own
        torch.set_num_threads(1)
    else:
        device = torch.device(device)
    # the program under test lives at the checkout's root
    if str(root) not in sys.path:
        sys.path.insert(1, str(root))
    import importlib
    entry = importlib.import_module(f"entries.{mix['entry']}")
    if device.type == "cuda":
        from go1_qp_mpc_controller_torch.ops import _build
        _build.build_all()
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)

    cell = entry.Cell(config, mix, args.seed, device)
    cell.setup()
    tracer = harness.Tracer(
        float(mix["trace_seconds"]) if args.trace else None, device)
    e2e = cell.window(args.seconds, tracer)
    setup_s = cell.started - _START
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.finish()

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    extra = {}
    if args.trace:
        busy = harness.busy_us(tracer.events) / 1e6
        record = dict(cell.record(), events=tracer.events, busy_s=busy,
                      window_s=tracer.window_s, traced=tracer.units,
                      kind=dev["kind"])
        metrics = per_layer(bench, work["name"], record)
        dev.update(busy_s=busy, window_s=tracer.window_s,
                   power_limit_w=_power_limit())
        extra["breakdown"] = harness.breakdown(tracer.events)
        tracer.events = record["events"] = None
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
                   if k in units}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}

    # the reference, once the window has closed and the peak is read
    compared, readings, correct = cell.check(limits)
    extra["readings"] = readings
    extra["record"] = {k: v for k, v in cell.record().items()
                       if k != "settings"}
    found = harness.forbidden_modules()
    if found:
        print("no result: JAX modules were loaded in this run: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for c in compared:
        print(f"compared {c['name']}: {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr)
    print(harness.result_line(correct, cell.attempted(), cell.failed,
                              metrics, dev, compared, extra))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
