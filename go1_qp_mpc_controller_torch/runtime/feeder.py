"""Simulated 1 kHz sensor feed for the real-time host loop.

Port of the JAX package's ``runtime/feeder.py``. The reference's hardware
adapter owns a receive thread that unpacks UDP sensor frames at 1 kHz and
publishes them into the shared state (HardwareA1ROS.cpp:253-386). This
module is that thread's simulated stand-in: it steps the SRB plant with the
latest commanded torques from the bridge and pushes raw sensor frames
through ``RtBridge.push_sensors``, so ``main.py loop`` runs a closed loop
end to end (sensors in, torques out) without a robot.

The plant runs on ``device``, the CUDA card unless the caller asks for the
CPU, on a CUDA stream of the feeder thread's own; on the card each plant
tick, in torque or in position mode, is one CUDA graph replay
(``utils/graphs.py``). (The JAX feeder pins the host CPU because a 1 kHz
loop could not ride its remote accelerator's dispatch; a local card has no
such limit.)
"""

import threading
import time

import numpy as np
import torch

from go1_qp_mpc_controller_torch.envs import rollout, srb_sim
from go1_qp_mpc_controller_torch.runtime import bridge as bridge_lib
from go1_qp_mpc_controller_torch.utils import graphs
from go1_qp_mpc_controller_torch.utils.device import (new_stream, on_stream,
                                                       resolve_device)


def _cast(tree, device, dtype):
    """A model / params container (nested NamedTuples of tensors) moved to
    ``device`` with floating leaves in ``dtype``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*[_cast(a, device, dtype) for a in tree])
    return tree.to(device=device,
                   dtype=dtype if tree.is_floating_point() else tree.dtype)


class SimFeeder:
    """Feeds the bridge from an SRB plant at a fixed cadence.

    The feeder holds the plant in a standing contact schedule (all-stance
    contacts, feet pinned): the "hold a stand" scenario. The controller
    sees the hardware sensor layout (quat, IMU, joints, foot forces).

    Args:
      bridge: RtBridge to push frames into (and read commands from).
      model, params: RobotModel / CtrlParams (moved to ``device`` in
        float32).
      height: initial standing height.
      period_s: feed cadence (reference: 1 ms, A1Params.h:12).
      time_scale: real-time factor: the plant advances ``period_s`` of sim
        time every ``period_s / time_scale`` of wall time (Gazebo's RTF;
        keep it equal to the ControlLoop's).
      device: None for the CUDA card (raises without one), or "cpu".
    """

    def __init__(self, bridge, model, params, height=0.3, period_s=0.001,
                 time_scale=1.0, device=None):
        self.bridge = bridge
        self.period = period_s
        self.time_scale = time_scale
        self.device = resolve_device(device)
        self._stop = threading.Event()
        self.ticks = 0
        self.overruns = 0
        self.error = None
        self._engaged = False
        self._stream = new_stream(self.device)

        f32 = torch.float32
        self.model = _cast(model, self.device, f32)
        params = _cast(params, self.device, f32)
        with on_stream(self._stream):
            carry = rollout.init_carry(self.model, params, 1, height=height,
                                       dtype=f32, device=self.device)
            self._ctrl0 = carry.ctrl
            self._sim = carry.sim
            self._forces_z = carry.stance_forces_z
            self._stand_targets = (carry.sim.foot_pos_world
                                   - carry.sim.root_pos[:, None])
            self._contacts = torch.ones((1, 4), dtype=torch.bool,
                                        device=self.device)
            # the torque-mode and the position-mode tick, captured as CUDA
            # graphs on the card (here, before any other thread runs)
            self._tick = graphs.StagedStep(
                graphs.single(self._step_and_read), self._sim,
                self._forces_z,
                torch.zeros((1, 12), dtype=f32, device=self.device))
            self._pd_tick = graphs.StagedStep(
                graphs.single(self._pd_step_and_read), self._sim,
                self._forces_z,
                torch.zeros((1, 48), dtype=f32, device=self.device))
            self._host = self._read()
        self._root_host = self._host[38:41].copy()

    def initial_ctrl_state(self):
        """Batch-1 CtrlState synced to the plant's standing pose (what
        ``rollout.init_carry`` makes for the same scenario)."""
        return self._ctrl0

    def _frame(self, sim, forces_z):
        """(1, 41): the sensor frame of ``sim`` (38 values in the bridge's
        order), then its root position."""
        s = srb_sim.read_sensors(sim, self.model, self._contacts, forces_z,
                                 self.period)
        return torch.cat([s.quat_wxyz, s.imu_acc, s.imu_ang_vel, s.joint_pos,
                          s.joint_vel, s.foot_force, sim.root_pos], dim=-1)

    def _step_and_read(self, sim, forces_z, tau):
        """One torque-mode plant step and the new state's frame."""
        sim, forces_z = srb_sim.step(sim, self.model, tau, self._contacts,
                                     self._stand_targets, self.period)
        return sim, forces_z, self._frame(sim, forces_z)

    def _pd_step_and_read(self, sim, forces_z, cmd):
        """One position-mode plant step under ``cmd`` = (tau, q, kp, kd)
        as one (1, 48) block, and the new state's frame."""
        tau, q, kp, kd = cmd.split(12, dim=-1)
        sim, forces_z = srb_sim.step_pd(sim, self.model, q, kp, kd, tau,
                                        self._contacts, self._stand_targets,
                                        self.period)
        return sim, forces_z, self._frame(sim, forces_z)

    def _read(self):
        """The current frame as a float64 host array."""
        return self._frame(self._sim, self._forces_z)[0].to(
            "cpu", torch.float64).numpy()

    def _advance(self, cmd):
        """One plant step under the bridge's command: torques, or a
        position-mode command (the RL stack's motor loop,
        Go1RLController.cpp:149-166) when it carries nonzero kp. Returns the
        new state's frame on the host (one copy from the card)."""
        dev = lambda a: torch.as_tensor(a[None], dtype=torch.float32).to(
            self.device)
        if np.any(cmd["kp"] != 0.0):
            self._sim, self._forces_z, frame = self._pd_tick(
                self._sim, self._forces_z, dev(np.concatenate(
                    [cmd["tau"], cmd["q"], cmd["kp"], cmd["kd"]])))[1]
        else:
            self._sim, self._forces_z, frame = self._tick(
                self._sim, self._forces_z, dev(cmd["tau"]))[1]
        return frame[0].to("cpu", torch.float64).numpy()

    def run(self, num_ticks=None, duration_s=None):
        """Blocking feed loop on the compensated C++ rate keeper."""
        rate = bridge_lib.RateKeeper(self.period / self.time_scale)
        t_end = time.time() + duration_s if duration_s else None
        try:
            with on_stream(self._stream):
                while not self._stop.is_set():
                    if num_ticks is not None and self.ticks >= num_ticks:
                        break
                    if t_end is not None and time.time() >= t_end:
                        break
                    cmd_tick, cmd = self.bridge.read_command()
                    frame = self._host
                    # the plant holds its pose until the controller ENGAGES
                    # (first nonzero command): the robot stands legs-locked
                    # through the controller's warmup and its 10-tick
                    # zero-torque warmup (A1RobotControl.cpp:292-295)
                    if not self._engaged and cmd_tick > 0:
                        self._engaged = bool(np.any(cmd["tau"] != 0.0)
                                             or np.any(cmd["kp"] != 0.0))
                    if self._engaged:
                        self._host = self._advance(cmd)
                        self._root_host = self._host[38:41].copy()
                    self.bridge.push_sensors(frame[0:4], frame[4:7],
                                             frame[7:10], frame[10:22],
                                             frame[22:34], frame[34:38])
                    self.ticks += 1
                    rate.wait()
            self.overruns = rate.overruns
        except BaseException as exc:
            self.error = exc         # for the caller to check and raise
            raise
        finally:
            rate.close()
        return self.ticks

    def start(self, **kwargs):
        self._thread = threading.Thread(target=self.run, kwargs=kwargs,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if hasattr(self, "_thread"):
            self._thread.join(timeout=5.0)

    @property
    def sim_root_pos(self):
        """Current plant CoM, a (3,) numpy array (for asserting a held
        stand)."""
        return self._root_host.copy()
