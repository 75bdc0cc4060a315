"""PyTorch port, the slice as a whole: the batched closed-loop rollout.

``rollout_batched`` of the port against the JAX package's, float64, batch
3, with the EKF in the loop: 100 standing ticks, then a trot at 0.3 m/s
from tick 100, so that contacts flip and the compact, window and warm
routes all occur (with 3 scenarios the compact sub-batch never
overflows). The traces agree tick by tick to float64 round-off as
the closed loop carries it (1e-6 N on forces and torques, 1e-9 m on
positions; measured ~3e-8 N and ~4e-13 m). Also: a float32 trot stays
healthy (the gate of tests/test_batched_transition.py), the port imports
neither JAX nor the JAX package, and ``init_carry`` refuses to fall back
to the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.ops import admm as j_admm

torch.set_num_threads(1)
DT = 0.002
COLD = dict(seg_iters=30, segments=2, first_seg_iters=20, polish=False,
            schulz_l0=1e-6, schulz_l0_first=1e-3, schulz_l0_refine=1e-4,
            schulz_hi_tail=1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _perturbation(batch, seed=0):
    rng = np.random.default_rng(seed)
    return 0.005 * rng.normal(size=batch), 0.01 * rng.normal(size=(batch, 3))


def _port_carry(batch, dtype, dz, dv):
    model = t_types.default_robot_model(dtype, "cpu")
    params = t_types.default_ctrl_params(dtype, "cpu")
    c = t_rollout.init_carry(model, params, batch, dtype=dtype, device="cpu")
    sim = c.sim._replace(
        root_pos=c.sim.root_pos + torch.nn.functional.pad(
            torch.tensor(dz, dtype=dtype)[:, None], (2, 0)),
        root_lin_vel=c.sim.root_lin_vel + torch.tensor(dv, dtype=dtype))
    return c._replace(sim=sim), model, params


def _port_command(vx, start):
    def command(i, ctrl):
        walk = i >= start
        vel = torch.zeros_like(ctrl.root_lin_vel_d)
        vel[:, 0] = vx if walk else 0.0
        return ctrl._replace(
            movement_mode=torch.full_like(ctrl.movement_mode, int(walk)),
            root_lin_vel_d=vel)
    return command


def test_rollout_matches_jax_f64():
    batch, steps = 3, 150
    dz, dv = _perturbation(batch)
    jm = j_types.default_robot_model(jnp.float64)
    jp = j_types.default_ctrl_params(jnp.float64)
    jc = j_rollout.init_carry(jm, jp, height=0.3, dtype=jnp.float64)
    jc = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), jc)
    jc = jc._replace(sim=jc.sim._replace(
        root_pos=jc.sim.root_pos.at[:, 2].add(dz),
        root_lin_vel=jc.sim.root_lin_vel + dv))

    def j_command(i, ctrl):
        walk = i >= 100
        return ctrl._replace(
            movement_mode=jnp.where(walk, 1, 0).astype(jnp.int32),
            root_lin_vel_d=jnp.where(walk, jnp.asarray([0.3, 0.0, 0.0]),
                                     jnp.zeros(3)))

    settings = j_admm.ADMMSettings(schulz_impl="auto", **COLD)
    _, want = jax.jit(lambda c: j_rollout.rollout_batched(
        c, jm, jp, steps, jnp.asarray(DT), settings=settings,
        command_fn=j_command))(jc)

    carry, model, params = _port_carry(batch, torch.float64, dz, dv)
    stats = {}
    _, got = t_rollout.rollout_batched(
        carry, model, params, steps, DT,
        settings=t_admm.ADMMSettings(schulz_impl="auto", **COLD),
        command_fn=_port_command(0.3, 100), stats=stats)
    assert {"compact", "window", "warm"} <= set(stats)
    tols = {"joint_torques": 1e-6, "foot_forces_grf": 1e-6,
            "terrain_pitch": 1e-8, "root_euler": 1e-8}
    for name in got._fields:
        w = np.asarray(getattr(want, name)).astype(np.float64)
        g = getattr(got, name).numpy().astype(np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=tols.get(name, 1e-9),
                                   err_msg=name)
    con = got.contacts.numpy()
    assert con[99].all() and not con[100].all()   # contacts flipped


def test_trot_rollout_walks_f32():
    """Float32 batched trot with the EKF in the loop: finite, height
    within 0.05 m of 0.3, forward speed within 15% of the 0.3 m/s command,
    contacts flipped (the gate of tests/test_batched_transition.py)."""
    batch = 3
    dz, dv = _perturbation(batch, seed=1)
    carry, model, params = _port_carry(batch, torch.float32, dz, dv)
    _, trace = t_rollout.rollout_batched(
        carry, model, params, 700, DT,
        settings=t_admm.ADMMSettings(schulz_impl="auto", **COLD),
        command_fn=_port_command(0.3, 100))
    pos = trace.root_pos.numpy()
    vel = trace.root_lin_vel.numpy()
    assert np.isfinite(pos).all()
    assert np.all(np.abs(pos[200:, :, 2] - 0.3) < 0.05)
    np.testing.assert_allclose(vel[400:, :, 0].mean(), 0.3, rtol=0.15)
    con = trace.contacts.numpy()
    assert (con[150:, 0].min(axis=0) == 0).any()


def test_port_imports_no_jax():
    """In a fresh interpreter, one CPU tick of the port (batched, per
    scenario with the polished dense solve, and at horizon 20 on the
    stagewise solver), a small sweep, the same sweep over a world-1 mesh,
    and the mesh, horizon, viz, roofline and oracle modules load neither
    JAX nor the JAX package."""
    code = (
        "import sys, torch\n"
        "from go1_qp_mpc_controller_torch.envs import rollout\n"
        "from go1_qp_mpc_controller_torch.models import types\n"
        "from go1_qp_mpc_controller_torch.ops import admm\n"
        "m = types.default_robot_model(device='cpu')\n"
        "p = types.default_ctrl_params(device='cpu')\n"
        "c = rollout.init_carry(m, p, 2, device='cpu')\n"
        "from go1_qp_mpc_controller_torch.ops import admm_iterations\n"
        "s = admm.ADMMSettings(polish=False, schulz_impl='auto')\n"
        "rollout.rollout_batched(c, m, p, 1, 0.002, settings=s)\n"
        "rollout.rollout(c, m, p, 1, 0.002)\n"
        "short = admm.ADMMSettings(seg_iters=2, segments=1, polish=False)\n"
        "c20 = rollout.init_carry(m, p, 1, device='cpu', horizon=20)\n"
        "rollout.rollout(c20, m, p, 1, 0.002, horizon=20, settings=short)\n"
        "from go1_qp_mpc_controller_torch.parallel import sweep\n"
        "sweep.make_sweep_fn('cpu', 0.0025, short)(\n"
        "    sweep.random_scenarios(0, 2, device='cpu'))\n"
        "from go1_qp_mpc_controller_torch.parallel import horizon, mesh\n"
        "mesh.init_distributed('cpu')\n"
        "sweep.make_sweep_fn(mesh.make_mesh(1), 0.0025, short)(\n"
        "    sweep.random_scenarios(0, 2, device='cpu'))\n"
        "torch.distributed.destroy_process_group()\n"
        "from go1_qp_mpc_controller_torch.utils import roofline, viz\n"
        "from go1_qp_mpc_controller_torch.compat import oracle\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('go1_qp_mpc_controller_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_init_carry_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: init_carry would use it")
    model = t_types.default_robot_model(device="cpu")
    params = t_types.default_ctrl_params(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_rollout.init_carry(model, params, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_types.default_robot_model()
