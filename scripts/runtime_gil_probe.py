#!/usr/bin/env python3
"""How other Python threads slow the runtime's GRF solve down.

Times each runtime step of one preset alone at batch 1 (the fast step,
the estimator's frame, the feeder's plant step and read, each eager and,
on the card, as the runtime replays it from CUDA graphs: p50 wall time,
the stream synchronized), then the GRF solve, eager (the GRF loop's parts,
``ControlLoop._grf_parts``, composed plainly) and as the GRF loop replays
it (the routed graphs ``ControlLoop.warmup`` captured, its outputs
copied), alone and
while ``--threads`` background threads each run a loop of tiny device
operations on streams of their own (standing in for the fast loop, the
estimator and the feeder), once at Python's default GIL switch interval
(5 ms) and once at ``--switch-interval``. Prints one JSON line.

    python3 scripts/runtime_gil_probe.py --preset hardware_qp
    python3 scripts/runtime_gil_probe.py --device cpu
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from go1_qp_mpc_controller_torch.config import presets  # noqa: E402
from go1_qp_mpc_controller_torch.ctrl import controller  # noqa: E402
from go1_qp_mpc_controller_torch.envs import rollout  # noqa: E402
from go1_qp_mpc_controller_torch.runtime import estimator  # noqa: E402
from go1_qp_mpc_controller_torch.runtime import feeder as feeder_lib  # noqa
from go1_qp_mpc_controller_torch.runtime import loop as loop_lib  # noqa
from go1_qp_mpc_controller_torch.utils import graphs  # noqa: E402
from go1_qp_mpc_controller_torch.utils.device import (  # noqa: E402
    new_stream, on_stream, resolve_device, synchronize)


def solve_ms(cl, solve, n):
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        solve()
        synchronize(cl.device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"p50": float(np.percentile(walls, 50)),
            "p90": float(np.percentile(walls, 90))}


def busy(device, stop, counter):
    x = torch.zeros(16, device=device)
    with on_stream(new_stream(device)):
        while not stop.is_set():
            for _ in range(20):
                x = x * 0.5 + 1.0
            synchronize(device)
            counter[0] += 20


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="hardware_qp")
    parser.add_argument("--device", default=None)
    parser.add_argument("--threads", type=int, default=3)
    parser.add_argument("--solves", type=int, default=20)
    parser.add_argument("--switch-interval", type=float, default=1e-4)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    model, params, static = presets.load_preset(args.preset, torch.float32,
                                                device=device)
    carry = rollout.init_carry(model, params, 1, device=device)
    cl = loop_lib.ControlLoop(model, params, static, carry.ctrl,
                              estimate_in_feed=True)
    feeder = feeder_lib.SimFeeder(cl.bridge, model, params, device=device)
    cl.state = feeder.initial_ctrl_state()
    cl.warmup()
    est = cl._est_ready
    est_step = estimator.make_estimator_step(model)
    frame = np.concatenate([[1.0, 0, 0, 0], [0, 0, 9.8],
                            np.zeros(3), cl.state.joint_pos[0].cpu().numpy(),
                            np.zeros(12), np.full(4, 50.0)])
    sensors = cl._sensor_data({"quat": frame[0:4], "acc": frame[4:7],
                               "gyro": frame[7:10],
                               "joint_pos": frame[10:22],
                               "joint_vel": frame[22:34],
                               "foot_force": frame[34:38]})
    zero_cmd = {"tau": np.zeros(12), "kp": np.zeros(12)}
    steps = {
        "fast": lambda: cl.fast_step(cl.state, sensors, cl.params),
        "estimator": lambda: est_step(est._x, est._P, *est._split(
            est._frame(frame, 0.001)), est._mode(0), 0.001),
        "feeder": lambda: (feeder._step_and_read(
            feeder._sim, feeder._forces_z,
            torch.zeros((1, 12), device=device)), feeder._read()),
        # the same steps as the runtime runs them: CUDA graph replays (the
        # estimator's with its K4 launch), copies to and from the host
        "fast_graph": lambda: graphs.clone(cl._fast(cl.state, sensors,
                                                    cl.params)[1]),
        "estimator_graph": lambda: est._update(est._frame(frame, 0.001),
                                               est._mode(0)),
        "feeder_graph": lambda: feeder._advance(zero_cmd)}
    if device.type != "cuda":                # the CPU: no graphs
        for name in ("fast_graph", "estimator_graph", "feeder_graph"):
            del steps[name]
    out = {"preset": args.preset, "device": str(device),
           "threads": args.threads}
    for name, fn in steps.items():
        walls = []
        for _ in range(args.solves):
            t0 = time.perf_counter()
            fn()
            synchronize(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_alone_ms_p50"] = float(np.percentile(walls, 50))
    solves = {
        "": lambda: graphs.compose_stages(cl._grf_parts(), cl.state,
                                          cl.params),
        "graph_": lambda: graphs.clone(controller.run_tick(
            cl._grf, (cl.state, cl.params))[0])}
    for tag, solve in solves.items():
        out[f"{tag}alone_ms"] = solve_ms(cl, solve, args.solves)
    default = sys.getswitchinterval()
    for name, interval in (("default", default),
                           ("short", args.switch_interval)):
        sys.setswitchinterval(interval)
        stop, counter = threading.Event(), [0]
        threads = [threading.Thread(target=busy, args=(device, stop, counter),
                                    daemon=True)
                   for _ in range(args.threads)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        t0, c0 = time.perf_counter(), counter[0]
        for tag, solve in solves.items():
            out[f"{tag}contended_{name}_ms"] = solve_ms(cl, solve,
                                                        args.solves)
        out[f"busy_ops_per_s_{name}"] = ((counter[0] - c0)
                                         / (time.perf_counter() - t0))
        stop.set()
        for t in threads:
            t.join()
        out[f"switch_interval_{name}_s"] = interval
    sys.setswitchinterval(default)
    cl.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
