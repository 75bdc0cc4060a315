"""What every cell shares: the bench file and its pieces found by name,
the device trace and its reductions, the check that no JAX module was
loaded, and the result line.

Nothing here imports the program; ``run.py`` and the entries do.
"""

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# modules that must never be loaded in a run, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "go1_qp_mpc_controller_tpu")


def bench_file(root):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(root, bench_dir, name):
    """(bench, workload entry, configuration, traffic mix, limits) of the
    cell ``name``: ``BENCHMARK.json`` at the checkout ``root``, the rest
    found by name under ``bench_dir``."""
    bench = bench_file(root)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == work["config"])
    bench_dir = Path(bench_dir)
    return (bench, work, read_json(Path(root) / cfg["file"]),
            read_json(bench_dir / "traffic" / f"{work['traffic']}.json"),
            read_json(bench_dir / "limits" / f"{work['name']}.json"))


def load_module(path, name=None):
    """The Python file ``path`` as a module (metric readers have dots in
    their file names, so they are loaded by path)."""
    name = name or "bench_" + Path(path).stem.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is one of :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def quantile(values, q):
    """The q-quantile (0..1) of ``values`` by linear interpolation between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def kernel_events(prof, cuda_type):
    """[(start_us, end_us, name)] of the device activity in a finished
    torch.profiler ``prof``."""
    events = []
    try:
        raw = prof.profiler.kineto_results.events()
        for ev in raw:
            if ev.device_type() == cuda_type:
                start = ev.start_ns() / 1e3
                events.append((start, start + ev.duration_ns() / 1e3,
                               ev.name()))
        return events
    except AttributeError:
        pass
    for ev in prof.events():
        if ev.device_type == cuda_type:
            events.append((ev.time_range.start, ev.time_range.end, ev.name))
    return events


def is_kernel(name):
    """A device event that runs code on the SMs (not a copy or a fill)."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset")
                or "cudamemcpy" in low or "cudamemset" in low)


def busy_us(events):
    """The union of the events' device intervals, in us."""
    busy, last = 0.0, -math.inf
    for start, end, _ in sorted(events):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy


def short_name(name):
    return name.replace("(anonymous namespace)::", "").split("(")[0][:120]


def breakdown(events):
    """The trace's ``breakdown``: the 10 device operations that took the
    most time, and the 10 longest idle gaps, each named by the device
    operation that ended it (the launch the host was preparing)."""
    by_name = {}
    for start, end, name in events:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (end - start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, last = [], None
    for start, end, name in sorted(events):
        if last is not None and start > last:
            gaps.append((start - last, "before " + short_name(name)))
        last = end if last is None else max(last, end)
    gaps = sorted(gaps, reverse=True)[:10]
    return {"device_ops": [[k, v / 1e6] for k, v in ops],
            "idle_gaps": [[label, g / 1e6] for g, label in gaps]}


def result_line(correct, attempted, failed, metrics, device, compared,
                extra=None):
    """The last line of standard output: the contract's keys, then the
    numbers compared for ``correct`` under a key of their own, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if extra:
        out.update(extra)
    out["compared"] = compared
    return json.dumps(out)


class Tracer:
    """The traced slice of a ``--trace 1`` window: torch.profiler over the
    device, started at the window's start and stopped at the first tick or
    call boundary ``seconds`` later (after a synchronize), so that the
    trace stays small enough to read inside a run's time. A Tracer with
    ``seconds`` None traces nothing; on the CPU it times the slice and
    records no device activity."""

    def __init__(self, seconds, device):
        self.seconds = seconds
        self.device = device
        self.cuda = getattr(device, "type", str(device)) == "cuda"
        self.prof = None
        self.active = False
        self.done = seconds is None
        self.t0 = self.window_s = None
        self.units = 0             # ticks or calls inside the traced slice
        self.events = []

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def start(self):
        if self.done:
            return
        if self.cuda:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self._sync()
            self.prof.__enter__()
            self._sync()
        self.active = True
        self.t0 = time.perf_counter()

    def step(self):
        """Count one tick or call; stop once the slice is long enough."""
        if not self.active:
            return
        self.units += 1
        if time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self):
        if not self.active:
            return
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        if self.prof is not None:
            import torch
            self.prof.__exit__(None, None, None)
            self.events = kernel_events(self.prof,
                                        torch.autograd.DeviceType.CUDA)
            self.prof = None
        self.active = False
        self.done = True
