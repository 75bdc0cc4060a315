"""PyTorch port, sloped terrain and turning: the two trots of
tests/test_terrain_turning.py (an uphill trot on a 10% grade with terrain
adaptation, a turning trot at 0.4 rad/s) through the port's ``rollout``
against the JAX package's, float64 on the CPU, tick by tick over a short
window: ``TICKS`` ticks with the trot from tick ``WALK_FROM`` (the JAX
tests start it at 100), so that the window holds the stand, the first
stance/swing hand-offs, the plane fit and the yaw reference.

Tolerances (tests/test_torch_rollout.py's): 1e-6 N on forces and
torques, 1e-8 on angles and the terrain pitch, 1e-9 m on positions.
``chip_smoke.py`` runs both JAX tests at their full 1200 ticks with their
criteria on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.ctrl import controller as t_ctrl
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_tpu.ctrl import controller as j_ctrl
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.ops import admm as j_admm

torch.set_num_threads(1)
F64 = torch.float64
DT = 0.002
SETTINGS = dict(seg_iters=25, segments=3)
TICKS = 110
WALK_FROM = 20
SLOPE = 0.1
TOLS = {"joint_torques": 1e-6, "foot_forces_grf": 1e-6, "root_euler": 1e-8,
        "terrain_pitch": 1e-8}
CASES = {"uphill": dict(vx=0.25, yaw_rate=0.0, slope=SLOPE),
         "turning": dict(vx=0.2, yaw_rate=0.4, slope=None)}


def _jax_trace(vx, yaw_rate, slope):
    jm = j_types.default_robot_model(jnp.float64)
    jp = j_types.default_ctrl_params(jnp.float64)
    ground = None if slope is None else jnp.asarray([0.0, slope, 0.0])
    carry = j_rollout.init_carry(jm, jp, height=0.3, dtype=jnp.float64,
                                 ground_coef=ground)

    def command(i, ctrl):
        walk = i >= WALK_FROM
        out = ctrl._replace(
            movement_mode=jnp.where(walk, 1, 0).astype(jnp.int32),
            root_lin_vel_d=jnp.where(walk, jnp.asarray([vx, 0.0, 0.0]),
                                     jnp.zeros(3)),
            root_ang_vel_d=jnp.where(walk, jnp.asarray([0.0, 0.0, yaw_rate]),
                                     jnp.zeros(3)))
        if slope is not None:
            out = out._replace(root_pos_d=ctrl.root_pos_d.at[2].set(
                0.3 + slope * ctrl.root_pos[0]))
        return out

    _, trace = jax.jit(lambda c: j_rollout.rollout(
        c, jm, jp, TICKS, jnp.asarray(DT), solver_type=j_ctrl.MPC,
        settings=j_admm.ADMMSettings(**SETTINGS), command_fn=command,
        estimate=False, use_terrain_adapt=slope is not None,
        ground_coef=ground))(carry)
    return trace


def _port_trace(vx, yaw_rate, slope):
    tm = t_types.default_robot_model(F64, "cpu")
    tp = t_types.default_ctrl_params(F64, "cpu")
    ground = None if slope is None else torch.tensor([0.0, slope, 0.0],
                                                     dtype=F64)
    carry = t_rollout.init_carry(tm, tp, 1, dtype=F64, device="cpu",
                                 ground_coef=ground)

    def command(i, ctrl):
        walk = i >= WALK_FROM
        vel = torch.zeros_like(ctrl.root_lin_vel_d)
        ang = torch.zeros_like(ctrl.root_ang_vel_d)
        if walk:
            vel[:, 0], ang[:, 2] = vx, yaw_rate
        out = ctrl._replace(
            movement_mode=torch.full_like(ctrl.movement_mode, int(walk)),
            root_lin_vel_d=vel, root_ang_vel_d=ang)
        if slope is not None:
            pos_d = ctrl.root_pos_d.clone()
            pos_d[:, 2] = 0.3 + slope * ctrl.root_pos[:, 0]
            out = out._replace(root_pos_d=pos_d)
        return out

    stats = {}
    _, trace = t_rollout.rollout(
        carry, tm, tp, TICKS, DT, solver_type=t_ctrl.MPC,
        settings=t_admm.ADMMSettings(**SETTINGS), command_fn=command,
        estimate=False, use_terrain_adapt=slope is not None,
        ground_coef=ground, stats=stats)
    return trace, stats


@pytest.mark.parametrize("case", list(CASES))
def test_trot_matches_jax(case):
    want = _jax_trace(**CASES[case])
    got, stats = _port_trace(**CASES[case])
    assert {"warm", "cold"} <= set(stats)
    contacts = got.contacts[:, 0]
    assert contacts[WALK_FROM - 1].all() and not contacts[WALK_FROM:].all()
    for name in got._fields:
        g = getattr(got, name)[:, 0].numpy().astype(np.float64)
        w = np.asarray(getattr(want, name)).astype(np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOLS.get(name, 1e-9),
                                   err_msg=name)
    assert np.isfinite(got.root_pos.numpy()).all()
    if case == "uphill":
        # the plane fit has already seen the grade
        assert float(got.terrain_pitch[-1, 0].abs()) > 0.03
    else:
        assert float(got.root_euler[-1, 0, 2]) > 0.0
