"""Observability: structured metrics, timers and profiler hooks.

Port of the JAX package's ``utils/metrics.py``:

- MetricsLogger: bounded in-memory ring of structured records with JSONL
  export (thread safe: the host loop's threads log into one logger);
- timed(): wall-clock span that first waits for a tensor's CUDA stream;
- trace(): torch.profiler span exported as a Chrome trace;
- controller_telemetry(): the reference's debug signals (terrain angle in
  degrees, root and foot states, torques, GRFs) from a CtrlState;
- swing_path_points(): sampled swing-foot Bezier paths.
"""

import contextlib
import json
import os
import threading
import time
from collections import deque

import numpy as np
import torch


class MetricsLogger:
    """Bounded structured-metrics ring with JSONL export."""

    def __init__(self, capacity=100000):
        self._records = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def log(self, name, value, step=None, **tags):
        if isinstance(value, torch.Tensor):
            value = float(value)
        record = {"t": time.time(), "name": name, "value": value,
                  "step": step, **tags}
        with self._lock:
            self._records.append(record)

    def records(self, name=None):
        with self._lock:
            records = list(self._records)
        if name is None:
            return records
        return [r for r in records if r["name"] == name]

    def summary(self, name):
        vals = np.array([r["value"] for r in self.records(name)])
        if len(vals) == 0:
            return {}
        return {"count": len(vals), "mean": float(vals.mean()),
                "p50": float(np.percentile(vals, 50)),
                "p99": float(np.percentile(vals, 99)),
                "max": float(vals.max())}

    def dump_jsonl(self, path):
        with open(path, "w") as f:
            for r in self.records():
                f.write(json.dumps(r) + "\n")


@contextlib.contextmanager
def timed(logger, name, sync=None, **tags):
    """Wall-clock span in ms; pass a tensor as ``sync`` to wait for the
    CUDA stream it was produced on first (device work is asynchronous:
    unsynchronized timings lie)."""
    t0 = time.perf_counter()
    yield
    if sync is not None and sync.is_cuda:
        torch.cuda.current_stream(sync.device).synchronize()
    logger.log(name, (time.perf_counter() - t0) * 1000.0, unit="ms", **tags)


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler span (CPU and, with a card, CUDA activity), written
    to ``log_dir/trace.json`` as a Chrome trace (Perfetto loads it)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def controller_telemetry(state, index=0):
    """The reference's debug signals of scenario ``index`` of a batched
    CtrlState (terrain angle in degrees: A1RobotControl.cpp:367-369; foot
    and torque states)."""
    row = lambda t: t[index].detach().cpu().numpy()
    return {
        "terrain_angle_deg": float(row(state.terrain_pitch_angle))
        * 180.0 / np.pi,
        "root_pos": row(state.root_pos).tolist(),
        "root_euler": row(state.root_euler).tolist(),
        "contacts": row(state.contacts).astype(int).tolist(),
        "joint_torques": row(state.joint_torques).tolist(),
        "foot_forces_grf": row(state.foot_forces_grf).tolist(),
    }


def swing_path_points(foot_pos_start, foot_pos_target, num_points=10):
    """Sampled swing-foot Bezier paths for visualization (the RViz
    foot-path marker, A1RobotControl.cpp:120-143: a 10-point LINE_STRIP per
    leg).

    Args:
      foot_pos_start: (4, 3) liftoff points (yaw frame).
      foot_pos_target: (4, 3) planned footholds.
      num_points: samples along each curve.

    Returns:
      (4, num_points, 3) numpy array of path points.
    """
    from go1_qp_mpc_controller_torch.utils import bezier

    start = torch.as_tensor(np.asarray(foot_pos_start, np.float64))
    target = torch.as_tensor(np.asarray(foot_pos_target, np.float64))
    pts = [bezier.swing_foot_pos(torch.tensor(t, dtype=torch.float64),
                                 start, target).numpy()
           for t in np.linspace(0.0, 1.0, num_points)]
    return np.stack(pts, axis=1)
