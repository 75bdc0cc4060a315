"""Scenario sweeps: batches of randomized condensed-MPC solves, plain
PyTorch in the input's dtype: the generator of the JAX package's
configs[2] distribution (:func:`random_scenarios`, the benchmark's
traffic) and the dense polished solve of ``main.py sweep``'s settings
(:func:`_solve_one`).
"""

from typing import NamedTuple

import numpy as np
import torch

from reference.go1.config import params as CP
from reference.go1.models import srb
from reference.go1.ops import admm
from reference.go1.utils.device import resolve_device


class MpcScenario(NamedTuple):
    """A batch of MPC problems (leading scenario axis on every leaf)."""
    x0: torch.Tensor           # (B, 13) current state
    x_ref: torch.Tensor        # (B, H, 13) reference trajectory
    foot_pos: torch.Tensor     # (B, 4, 3) feet relative to the CoM
    contacts: torch.Tensor     # (B, 4) bool contact flags
    root_rot: torch.Tensor     # (B, 3, 3)
    mass: torch.Tensor         # (B,)
    inertia: torch.Tensor      # (B, 3, 3)
    q_weights: torch.Tensor    # (B, 13)
    r_weights: torch.Tensor    # (B, 12)
    mu: torch.Tensor           # (B,) friction coefficients


class SweepResult(NamedTuple):
    grf: torch.Tensor          # (B, 4, 3) first-step forces (world frame)
    forces_all: torch.Tensor   # (B, 120) the whole horizon's solution
    primal_res: torch.Tensor   # (B,)
    dual_res: torch.Tensor     # (B,)
    stats: dict                # summary statistics of the batch


def discretize(scn, mpc_dt, x0=None):
    """(A_d, B_d) of every scenario, linearized at the euler angles of
    ``x0`` (default the scenarios' own), with B_d shared across the
    horizon."""
    x0 = scn.x0 if x0 is None else x0
    a_c = srb.calculate_A_c(x0[:, 0:3])
    b_c = srb.calculate_B_c(scn.mass[:, None, None], scn.inertia,
                            scn.root_rot, scn.foot_pos)
    return srb.discretize(a_c, b_c, mpc_dt)


def _solve_one(scn, mpc_dt, settings):
    """Condense and solve the batch (the JAX ``_solve_one`` on one device)
    with the dense solve (K3's and K6's plain versions), which honours
    polish and float64 refinement. Returns the ADMMSolution."""
    if (settings.segments == 1 and not settings.polish
            and not settings.refine_f64):
        raise ValueError("the plain copy holds only the dense solve")
    a_d, b_d = discretize(scn, mpc_dt)
    qp = srb.condense_nilpotent_const(a_d, b_d, scn.x0, scn.x_ref,
                                      scn.q_weights, scn.r_weights,
                                      scn.contacts)
    return admm.mpc_solve(qp, settings, mu=scn.mu)


def random_scenarios(seed, batch, dtype=torch.float32, device=None):
    """Randomized stand / trot scenarios (the configs[2] distribution):
    velocity commands, friction, mass, height and contact patterns, drawn
    with numpy from ``seed``. The draws are the JAX package's
    ``random_scenarios(jax.random.PRNGKey(seed), batch, dtype)`` bit for
    bit (it seeds numpy with the key's last word, which is ``seed``)."""
    device = resolve_device(device)
    h = CP.PLAN_HORIZON
    rng = np.random.default_rng(seed)
    mass = rng.uniform(10.0, 18.0, batch)
    heights = rng.uniform(0.22, 0.32, batch)
    vel_cmd = rng.uniform([-0.5, -0.3, 0.0], [0.5, 0.3, 0.0], (batch, 3))
    mu = rng.uniform(0.25, 0.7, batch)
    contacts = rng.uniform(size=(batch, 4)) > 0.4
    contacts[contacts.sum(1) < 2] = True      # at least two legs in stance
    feet = np.tile(np.array([[0.17, 0.15, 0.0], [0.17, -0.15, 0.0],
                             [-0.17, 0.15, 0.0], [-0.17, -0.15, 0.0]]),
                   (batch, 1, 1))
    feet[..., 2] = -heights[:, None]
    x0 = np.zeros((batch, 13))
    x0[:, 5] = heights
    x0[:, 9:12] = vel_cmd * rng.uniform(0.5, 1.0, (batch, 1))
    x0[:, 12] = -9.8
    x_ref = np.zeros((batch, h, 13))
    x_ref[..., 5] = heights[:, None]
    x_ref[..., 9:11] = vel_cmd[:, None, :2]
    x_ref[..., 3] = vel_cmd[:, None, 0] * 0.0025 * np.arange(1, h + 1)
    x_ref[..., 4] = vel_cmd[:, None, 1] * 0.0025 * np.arange(1, h + 1)
    x_ref[..., 12] = -9.8
    inertia = np.tile(np.diag([0.0168, 0.0656, 0.0743]), (batch, 1, 1))
    inertia *= (mass / 15.0)[:, None, None]
    q_weights = np.tile(np.array([80.0, 80.0, 1.0, 0.0, 0.0, 270.0, 1.0,
                                  1.0, 20.0, 20.0, 20.0, 20.0, 0.0]),
                        (batch, 1))
    r_weights = np.full((batch, 12), 1e-5)
    r_weights[:, 2::3] = 1e-6
    t = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    return MpcScenario(
        x0=t(x0), x_ref=t(x_ref), foot_pos=t(feet),
        contacts=torch.as_tensor(contacts).to(device),
        root_rot=torch.eye(3, dtype=dtype, device=device).expand(
            batch, 3, 3),
        mass=t(mass), inertia=t(inertia), q_weights=t(q_weights),
        r_weights=t(r_weights), mu=t(mu))

