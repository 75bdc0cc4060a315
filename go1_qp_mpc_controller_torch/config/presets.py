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

from go1_qp_mpc_controller_torch.models import kinematics, types
from go1_qp_mpc_controller_torch.utils.device import resolve_device

PRESET_DIR = os.path.join(os.path.dirname(__file__), "presets")


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Controller flags fixed for a run."""
    solver: str = "mpc"            # "mpc" | "qp"
    use_sim_time: bool = True
    use_terrain_adapt: bool = True
    power_level: int = 2
    environment: str = "gazebo"    # gazebo | hardware | isaac


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """RL-stack preset (go1_rl_ctrl_cpp/config/parameters.yaml /
    hardware_parameters.yaml fields)."""
    weights: str = "mass.pt"
    stand_weights: str = "stand_cpp_model.pt"
    action_period: float = 0.004    # action_update_frequency (s)
    deploy_period: float = 0.002    # deployment_frequency (s)
    stiffness: float = 18.0
    damping: float = 10.0
    power_level: int = 10           # go1_hardware_power_level
    use_sim_time: bool = True
    # KF contact-probability normalizer: the Go1 stack's EKF divides foot
    # forces by 1000 (Go1 hardware units, Go1BasicEKF.cpp:83), the A1 MPC
    # stack by 100 (A1BasicEKF.cpp:83)
    contact_force_norm: float = 1000.0


def _read(name):
    with open(os.path.join(PRESET_DIR, name + ".json")) as f:
        return json.load(f)


def available_presets(stack=None):
    """Preset names; ``stack`` filters to "mpc" (controller presets, the
    qp solver variants included) or "rl"."""
    names = sorted(p[:-5] for p in os.listdir(PRESET_DIR)
                   if p.endswith(".json"))
    if stack is None:
        return names
    rl = {n for n in names if n.startswith("rl_")}
    return sorted(rl) if stack == "rl" else sorted(set(names) - rl)


def load_rl_preset(name):
    """Load an RL-stack preset (e.g. "rl_gazebo") -> RLConfig."""
    cfg = _read(name)
    if cfg.get("stack") != "rl":
        raise ValueError(f"{name} is not an RL preset (use load_preset)")
    fields = {f.name for f in dataclasses.fields(RLConfig)}
    return RLConfig(**{k: v for k, v in cfg.items() if k in fields})


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
