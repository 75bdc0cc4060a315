"""PyTorch port, the per-scenario closed loop: ``rollout.rollout`` against
the JAX package's ``rollout`` under vmap, float64, batch 2.

MPC: 100 standing ticks, then a trot at 0.3 m/s with the EKF in the loop
and the polished cold settings of ``main.py rollout`` /
tests/test_walking.py, so that every route of ``compute_grf_mpc`` occurs
(the young-carry and flip ticks cold through the dense polished solve,
the post-flip window, steady warm ticks). QP: 150 standing ticks of the
balance-QP stance controller. The traces agree tick by tick within the
tolerances of tests/test_torch_rollout.py: 1e-6 N on forces and torques,
1e-9 m on positions.
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
DT = 0.002
BATCH = 2
SETTINGS = dict(seg_iters=25, segments=3)
TOLS = {"joint_torques": 1e-6, "foot_forces_grf": 1e-6,
        "terrain_pitch": 1e-8, "root_euler": 1e-8}


def _perturbation(seed=0):
    rng = np.random.default_rng(seed)
    return (0.005 * rng.normal(size=BATCH),
            0.01 * rng.normal(size=(BATCH, 3)))


def _jax_trace(solver_type, steps, estimate, walk_from):
    jm = j_types.default_robot_model(jnp.float64)
    jp = j_types.default_ctrl_params(jnp.float64)
    jc = j_rollout.init_carry(jm, jp, height=0.3, dtype=jnp.float64)
    dz, dv = _perturbation()

    def command(i, ctrl):
        walk = i >= walk_from
        return ctrl._replace(
            movement_mode=jnp.where(walk, 1, 0).astype(jnp.int32),
            root_lin_vel_d=jnp.where(walk, jnp.asarray([0.3, 0.0, 0.0]),
                                     jnp.zeros(3)))

    def one(dzi, dvi):
        c = jc._replace(sim=jc.sim._replace(
            root_pos=jc.sim.root_pos.at[2].add(dzi),
            root_lin_vel=jc.sim.root_lin_vel + dvi))
        return j_rollout.rollout(
            c, jm, jp, steps, jnp.asarray(DT), solver_type=solver_type,
            settings=j_admm.ADMMSettings(**SETTINGS), command_fn=command,
            estimate=estimate)[1]

    trace = jax.jit(jax.vmap(one))(jnp.asarray(dz), jnp.asarray(dv))
    # (B, T, ...) -> (T, B, ...), the port's layout
    return jax.tree.map(lambda a: np.swapaxes(np.asarray(a), 0, 1), trace)


def _port_trace(solver_type, steps, estimate, walk_from, stats):
    model = t_types.default_robot_model(torch.float64, "cpu")
    params = t_types.default_ctrl_params(torch.float64, "cpu")
    c = t_rollout.init_carry(model, params, BATCH, dtype=torch.float64,
                             device="cpu")
    dz, dv = _perturbation()
    c = c._replace(sim=c.sim._replace(
        root_pos=c.sim.root_pos + torch.nn.functional.pad(
            torch.tensor(dz)[:, None], (2, 0)),
        root_lin_vel=c.sim.root_lin_vel + torch.tensor(dv)))

    def command(i, ctrl):
        walk = i >= walk_from
        vel = torch.zeros_like(ctrl.root_lin_vel_d)
        vel[:, 0] = 0.3 if walk else 0.0
        return ctrl._replace(
            movement_mode=torch.full_like(ctrl.movement_mode, int(walk)),
            root_lin_vel_d=vel)

    return t_rollout.rollout(c, model, params, steps, DT,
                             solver_type=solver_type,
                             settings=t_admm.ADMMSettings(**SETTINGS),
                             command_fn=command, estimate=estimate,
                             stats=stats)[1]


@pytest.mark.parametrize("mode", ["mpc_trot_ekf", "qp_stand"])
def test_rollout_matches_jax_f64(mode):
    if mode == "mpc_trot_ekf":
        args = (150, True, 100)
        j_type, t_type = j_ctrl.MPC, t_ctrl.MPC
    else:
        args = (150, False, 10 ** 6)
        j_type, t_type = j_ctrl.QP, t_ctrl.QP
    want = _jax_trace(j_type, *args)
    stats = {}
    got = _port_trace(t_type, *args, stats)
    if mode == "mpc_trot_ekf":
        assert {"warm", "window", "cold"} <= set(stats)
        con = got.contacts.numpy()
        assert con[99].all() and not con[100:].all()   # contacts flipped
    for name in got._fields:
        w = np.asarray(getattr(want, name)).astype(np.float64)
        g = getattr(got, name).numpy().astype(np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOLS.get(name, 1e-9),
                                   err_msg=name)
