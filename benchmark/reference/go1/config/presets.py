"""Config presets: JSON -> (RobotModel, CtrlParams, StaticConfig).

Port of the JAX package's ``config/presets.py`` (the reference's
ROS-parameter-server presets, launch/a1_ctrl.launch:2-7 selecting
{env}_a1_{solver}.yaml, consumed by A1CtrlStates::resetFromROSParam,
A1CtrlStates.h:135-321). The port keeps its own copy of every preset under
``config/presets/`` as JSON (the same values and structured schema as the
JAX package's YAML files), so loading needs no YAML parser. Missing keys
fall back to the reference's code-side defaults.

``StaticConfig`` carries the flags the controller branches on in Python
(solver, terrain adaptation); the tensor-valued parts go into
``RobotModel`` / ``CtrlParams``.
"""

import dataclasses
import json
import os

import numpy as np
import torch

from reference.go1.models import kinematics, types
from reference.go1.utils.device import resolve_device

PRESET_DIR = os.path.join(os.path.dirname(__file__), "presets")


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Controller flags fixed for a run."""
    solver: str = "mpc"            # "mpc" | "qp"
    use_sim_time: bool = True
    use_terrain_adapt: bool = True
    power_level: int = 2
    environment: str = "gazebo"    # gazebo | hardware | isaac


def _read(name):
    with open(os.path.join(PRESET_DIR, name + ".json")) as f:
        return json.load(f)


def load_preset(name, dtype=torch.float32, mpc_dt=None, control_dt=0.002,
                device=None):
    """Load a preset by name (e.g. "gazebo_mpc").

    Args:
      mpc_dt: explicit MPC discretization step; None selects the
        reference's rule (A1RobotControl.cpp:458-467): hardware uses the
        fixed 2.5 ms budget (a slowed thread must not inflate dt and
        overshoot forces), simulation uses the control-thread dt.
      control_dt: the host control-loop period, consumed by the sim rule.
      device: where the tensors live; None is the CUDA card (raises
        without one), "cpu" the plain path.

    Returns:
      (RobotModel, CtrlParams, StaticConfig).
    """
    device = resolve_device(device)
    cfg = _read(name)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=device, dtype=dtype)

    robot = cfg["robot"]
    diag = robot["trunk_inertia_diag"]
    off = robot.get("trunk_inertia_off", [0.0, 0.0, 0.0])
    inertia = np.array([[diag[0], off[0], off[1]],
                        [off[0], diag[1], off[2]],
                        [off[1], off[2], diag[2]]])
    environment = name.split("_")[0]
    geometry = (kinematics.isaac_leg_geometry(dtype, device)
                if environment == "isaac"
                else kinematics.a1_leg_geometry(dtype, device))
    model = types.RobotModel(mass=t(robot["mass"]),
                             trunk_inertia=t(inertia),
                             leg_geometry=geometry,
                             default_foot_pos=t(robot["default_foot_pos"]))

    use_sim = bool(cfg.get("use_sim_time", True))
    if mpc_dt is None:
        # hardware uses the fixed 2.5 ms dt; sim uses the thread dt
        # (A1RobotControl.cpp:458-467)
        mpc_dt = control_dt if use_sim else 0.0025
    params = types.default_ctrl_params(dtype, device)._replace(
        q_weights=t(cfg["mpc"]["q_weights"]),
        r_weights=t(cfg["mpc"]["r_weights"]),
        kp_foot=t(np.tile(cfg["swing"]["kp_foot"], (4, 1))),
        kd_foot=t(np.tile(cfg["swing"]["kd_foot"], (4, 1))),
        km_foot=t(cfg["swing"]["km_foot"]),
        kp_linear=t(cfg["balance_qp"]["kp_linear"]),
        kd_linear=t(cfg["balance_qp"]["kd_linear"]),
        kp_angular=t(cfg["balance_qp"]["kp_angular"]),
        kd_angular=t(cfg["balance_qp"]["kd_angular"]),
        gait_counter_speed=t(cfg["gait"]["counter_speed"]),
        mpc_dt=t(mpc_dt))

    static = StaticConfig(
        solver=cfg.get("solver", "mpc"),
        use_sim_time=use_sim,
        use_terrain_adapt=bool(cfg.get("use_terrain_adapt", True)),
        power_level=int(cfg.get("power_level", 2)),
        environment=environment)
    return model, params, static
