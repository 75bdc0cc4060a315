"""PyTorch port, the multi-device layer (``parallel/mesh.py``,
``parallel/horizon.py`` and the mesh form of ``parallel/sweep.py``) on
four gloo ranks on the CPU, held against the JAX package on its virtual
CPU devices (the way tests/test_sharding.py holds the JAX mesh).

The four ranks are spawned once for the module: each runs the sweep on a
(4 x 1) and a (2 x 2) mesh, the horizon-sharded LQR solve over a
(1 x 4) mesh and four ticks of the sharded controller step on the
(4 x 1) mesh; rank 0 gathers the results into an npz. JAX is imported
only inside the tests, so the ranks (which import this module to find
their worker) never load it. All float64:

- the sweeps' GRFs and forces within 1e-6 N of JAX's ``make_sweep_fn``
  on a mesh of four devices (JAX's own test_mpc_axis_hessian_psum_matches
  tolerance), the data-only mesh within 1e-8 of the one-process port, the
  stats equal;
- the mpc-axis partials summed serially for n = 2 and 5 within 1e-10
  (relative) of JAX's ``_condense_mpc_sharded`` under ``shard_map`` and
  of the unsharded condensation;
- ``lqr_solve_sharded`` at H = 40 over 4 ranks within 1e-8 of JAX's
  ``stagewise._lqr_solve``;
- the sharded controller step at batch 16 (one flagged scenario taking
  its shard's compacted cold route on the last tick) within 1e-10 of the
  one-process ``control_step_batched`` and 1e-8 (x scale) of JAX's
  ``make_sharded_control_step``;
- ``main.py sweep --mpc-parallel 2`` at world size 1 raises JAX's
  ``ValueError``.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from go1_qp_mpc_controller_torch import main as t_main
from go1_qp_mpc_controller_torch.ctrl import controller as t_ctrl
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.envs import srb_sim as t_sim
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.ops import stagewise as t_stagewise
from go1_qp_mpc_controller_torch.parallel import horizon as t_horizon
from go1_qp_mpc_controller_torch.parallel import mesh as t_mesh
from go1_qp_mpc_controller_torch.parallel import sweep as t_sweep

torch.set_num_threads(1)
F64 = torch.float64
WORLD = 4
MPC_DT = 0.0025
DT = 0.002
SWEEP = dict(seg_iters=25, segments=3)      # main.py sweep's settings
SWEEP_BATCH = 8
SWEEP_MESHES = {"data4": 1, "data2_mpc2": 2}   # name: mpc_parallel
CTRL = dict(seg_iters=25, segments=3)
CTRL_BATCH = 16
CTRL_TICKS = 4
FLIPPED = 5              # its carried contacts flip before the last tick
LQR_H = 40
LQR_BATCH = 2
JOIN_S = 150


def _lqr_inputs():
    """A stable random closed-loop system in the stagewise shapes
    (tests/test_sharding.py's, two scenarios), float64 numpy."""
    rng = np.random.default_rng(11)
    b, h = LQR_BATCH, LQR_H
    return {"a_d": np.eye(13) + 0.01 * rng.normal(size=(b, 13, 13)),
            "b_d": 0.02 * rng.normal(size=(b, h, 13, 12)),
            "qs": rng.uniform(0.1, 2.0, (b, 13)),
            "rbar": np.stack([np.diag(rng.uniform(0.5, 2.0, 12))
                              for _ in range(b)]),
            "g": rng.normal(size=(b, h, 12)),
            "c_lin": rng.normal(size=(b, h, 13))}


def _ctrl_noise():
    """Start perturbations of the controller batch: height and velocity."""
    rng = np.random.default_rng(3)
    return (0.005 * rng.normal(size=CTRL_BATCH),
            0.01 * rng.normal(size=(CTRL_BATCH, 3)))


def _port_carry():
    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    c = t_rollout.init_carry(model, params, CTRL_BATCH, height=0.3,
                             dtype=F64, device="cpu")
    dz, dv = _ctrl_noise()
    pos = c.sim.root_pos.clone()
    pos[:, 2] += torch.as_tensor(dz)
    sim = c.sim._replace(root_pos=pos,
                         root_lin_vel=c.sim.root_lin_vel
                         + torch.as_tensor(dv))
    return model, params, c._replace(sim=sim)


def _port_tick(c, model, step):
    sensors = t_sim.read_sensors(c.sim, model, c.ctrl.contacts,
                                 c.stance_forces_z, DT)
    ctrl = step(t_ctrl.sensor_update(c.ctrl, model, sensors, DT))
    sim, fz = t_sim.step(c.sim, model, ctrl.joint_torques, ctrl.contacts,
                         ctrl.foot_pos_target_last_time, DT)
    return t_rollout.RolloutCarry(ctrl=ctrl, sim=sim, stance_forces_z=fz)


def _flip(c, row):
    qc = c.ctrl.qp_warm_contacts.clone()
    qc[row] = ~qc[row]
    return c._replace(ctrl=c.ctrl._replace(qp_warm_contacts=qc))


def _ctrl_outputs(ctrl):
    return (ctrl.foot_forces_grf, ctrl.joint_torques, ctrl.qp_warm_minv)


def _worker(rank, init_file, out_path):
    """One gloo rank: the sweeps, the sharded LQR and the sharded control
    step; rank 0 writes every gathered result to ``out_path``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        scn = t_sweep.random_scenarios(0, SWEEP_BATCH, F64, "cpu")
        for name, mpc in SWEEP_MESHES.items():
            mesh = t_mesh.make_mesh(mpc)
            res = t_sweep.make_sweep_fn(mesh, MPC_DT,
                                        t_admm.ADMMSettings(**SWEEP))(scn)
            out[f"{name}_mesh"] = np.array([mesh.shape["data"],
                                            mesh.shape["mpc"]])
            for key in ("grf", "forces_all", "primal_res", "dual_res"):
                out[f"{name}_{key}"] = getattr(res, key).numpy()
            for key, v in res.stats.items():
                out[f"{name}_stats_{key}"] = np.asarray(float(v))

        mesh = t_mesh.make_mesh(WORLD)                  # (1 x 4)
        lq = {k: torch.as_tensor(v) for k, v in _lqr_inputs().items()}
        fac = t_stagewise._riccati_factor(lq["a_d"], lq["b_d"], lq["qs"],
                                          lq["rbar"])
        s = LQR_H // WORLD
        loc = slice(mesh.index("mpc") * s, (mesh.index("mpc") + 1) * s)
        u_loc = t_horizon.lqr_solve_sharded(
            {k: v[:, loc] for k, v in fac.items()}, lq["a_d"],
            lq["b_d"][:, loc], lq["g"][:, loc], lq["c_lin"][:, loc],
            mesh.group("mpc"))
        parts = [torch.empty_like(u_loc) for _ in range(WORLD)]
        dist.all_gather(parts, u_loc, group=mesh.group("mpc"))
        out["lqr_u"] = torch.cat(parts, 1).numpy()

        mesh = t_mesh.make_mesh(1)                      # (4 x 1)
        model, params, carry = _port_carry()
        step = t_mesh.make_sharded_control_step(
            mesh, model, params, DT, settings=t_admm.ADMMSettings(**CTRL),
            use_terrain_adapt=False)
        local = t_mesh.scenario_sharding(mesh, carry)
        size = CTRL_BATCH // WORLD
        lo = mesh.index("data") * size
        for k in range(CTRL_TICKS):
            if k == CTRL_TICKS - 1 and lo <= FLIPPED < lo + size:
                local = _flip(local, FLIPPED - lo)
            local = _port_tick(local, model, step)
            for name, v in zip(("grf", "tau", "minv"), t_mesh.replicated(
                    mesh, _ctrl_outputs(local.ctrl))):
                out[f"ctrl_{name}_{k}"] = v.numpy()
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' gathered results (one spawn for the module)."""
    d = tmp_path_factory.mktemp("mesh")
    out_path = str(d / "ranks.npz")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(d / "rendezvous"), out_path))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_S)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive, f"ranks {alive} did not finish in {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", sorted(SWEEP_MESHES))
def test_mesh_sweep_matches_jax(ranks, name):
    """The world-4 sweep on a (4 x 1) and a (2 x 2) mesh against JAX's
    ``make_sweep_fn`` on a mesh of four devices: GRFs and the whole
    horizon's forces within 1e-6 N, the same stats; the data-only mesh
    within 1e-8 of the one-process port."""
    import jax
    import jax.numpy as jnp

    from go1_qp_mpc_controller_tpu.ops import admm as j_admm
    from go1_qp_mpc_controller_tpu.parallel import mesh as j_mesh
    from go1_qp_mpc_controller_tpu.parallel import sweep as j_sweep

    mpc = SWEEP_MESHES[name]
    mesh = j_mesh.make_mesh(mpc_parallel=mpc, devices=jax.devices()[:WORLD])
    want = j_sweep.make_sweep_fn(mesh, MPC_DT, j_admm.ADMMSettings(**SWEEP))(
        j_sweep.random_scenarios(jax.random.PRNGKey(0), SWEEP_BATCH,
                                 jnp.float64))
    assert dict(mesh.shape) == dict(zip(("data", "mpc"),
                                        ranks[f"{name}_mesh"].tolist()))
    for key in ("grf", "forces_all"):
        np.testing.assert_allclose(ranks[f"{name}_{key}"],
                                   np.asarray(getattr(want, key)),
                                   atol=1e-6, rtol=0, err_msg=key)
    assert float(ranks[f"{name}_stats_num_solves"]) == float(
        want.stats["num_solves"]) == SWEEP_BATCH
    for key in ("max_primal_res", "max_dual_res"):
        np.testing.assert_allclose(float(ranks[f"{name}_stats_{key}"]),
                                   float(want.stats[key]), rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    if mpc == 1:
        one = t_sweep.make_sweep_fn("cpu", MPC_DT,
                                    t_admm.ADMMSettings(**SWEEP))(
            t_sweep.random_scenarios(0, SWEEP_BATCH, F64, "cpu"))
        for key in ("grf", "forces_all", "primal_res", "dual_res"):
            np.testing.assert_allclose(ranks[f"{name}_{key}"],
                                       getattr(one, key).numpy(), atol=1e-8,
                                       rtol=0, err_msg=key)
        for key, v in one.stats.items():
            assert float(ranks[f"{name}_stats_{key}"]) == float(v), key


@pytest.mark.parametrize("n", [2, 5])
def test_mpc_partials_match_jax(n):
    """The n members' partial B'QB / B'Q(Ax0 - xref) summed serially (no
    group) against JAX's ``_condense_mpc_sharded`` under ``shard_map`` on
    a (1 x n) mesh and against the port's unsharded condensation: 1e-10
    relative, float64."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from go1_qp_mpc_controller_tpu.parallel import mesh as j_mesh
    from go1_qp_mpc_controller_tpu.parallel import sweep as j_sweep

    batch = 6
    scn = t_sweep.random_scenarios(5, batch, F64, "cpu")
    a_d, b_d = t_sweep.discretize(scn, MPC_DT)
    b_list = b_d[:, None].expand(-1, 10, -1, -1)
    parts = [t_sweep._condense_mpc_partial(a_d, b_list, scn, k, n)
             for k in range(n)]
    got = t_sweep._mpc_qp(sum(p[0] for p in parts), sum(p[1] for p in parts),
                          scn)
    dense = t_sweep.srb.condense_nilpotent_const(
        a_d, b_d, scn.x0, scn.x_ref, scn.q_weights, scn.r_weights,
        scn.contacts)

    mesh = j_mesh.make_mesh(mpc_parallel=n, devices=jax.devices()[:n])
    j_scn = j_sweep.MpcScenario(*[jnp.asarray(v.numpy()) for v in scn])
    j_a, j_b = jnp.asarray(a_d.numpy()), jnp.asarray(b_list.numpy())
    one = lambda a1, b1, s1: j_sweep._condense_mpc_sharded(a1, b1, s1, n)
    fn = jax.jit(shard_map(lambda a, b, s: jax.vmap(one)(a, b, s),
                           mesh=mesh, in_specs=P(), out_specs=P(),
                           check_vma=False))
    want = fn(j_a, j_b, j_scn)
    for key in ("hessian", "gradient"):
        g = getattr(got, key).numpy()
        for ref in (np.asarray(getattr(want, key)),
                    getattr(dense, key).numpy()):
            np.testing.assert_allclose(g, ref, atol=1e-10 * np.abs(ref).max(),
                                       rtol=0, err_msg=key)
    for key in ("lb", "ub"):
        assert np.array_equal(getattr(got, key).numpy(),
                              np.asarray(getattr(want, key)))
        assert torch.equal(getattr(got, key), getattr(dense, key))


def test_lqr_solve_sharded_matches_jax(ranks):
    """``lqr_solve_sharded`` at H = 40 over 4 ranks (10 stages each)
    against JAX's sequential ``stagewise._lqr_solve``: 1e-8."""
    import jax.numpy as jnp

    from go1_qp_mpc_controller_tpu.ops import stagewise as j_stagewise

    lq = {k: jnp.asarray(v) for k, v in _lqr_inputs().items()}
    for b in range(LQR_BATCH):
        fac = j_stagewise._riccati_factor(lq["a_d"][b], lq["b_d"][b],
                                          lq["qs"][b], lq["rbar"][b])
        want = j_stagewise._lqr_solve(fac, lq["a_d"][b], lq["b_d"][b],
                                      lq["g"][b], lq["c_lin"][b])
        np.testing.assert_allclose(ranks["lqr_u"][b], np.asarray(want),
                                   atol=1e-8, rtol=0)


def test_sharded_control_step(ranks):
    """Four ticks of ``make_sharded_control_step`` on the (4 x 1) mesh,
    scenario FLIPPED's carried contacts flipped before the last tick (its
    shard takes the compacted cold route), against the one-process
    ``control_step_batched`` (1e-10) and JAX's
    ``make_sharded_control_step`` on four devices (1e-8 x scale)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from go1_qp_mpc_controller_tpu.ctrl import controller as j_ctrl
    from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
    from go1_qp_mpc_controller_tpu.envs import srb_sim as j_sim
    from go1_qp_mpc_controller_tpu.models import types as j_types
    from go1_qp_mpc_controller_tpu.ops import admm as j_admm
    from go1_qp_mpc_controller_tpu.parallel import mesh as j_mesh

    model, params, c1 = _port_carry()
    single = lambda s: t_ctrl.control_step_batched(
        s, model, params, DT, settings=t_admm.ADMMSettings(**CTRL),
        use_terrain_adapt=False)

    j64 = jnp.float64
    j_model = j_types.default_robot_model(j64)
    j_params = j_types.default_ctrl_params(j64)
    dt = jnp.asarray(DT, j64)
    mesh = j_mesh.make_mesh(mpc_parallel=1, devices=jax.devices()[:WORLD])
    sharded = j_mesh.make_sharded_control_step(
        mesh, j_model, j_params, dt,
        settings=j_admm.ADMMSettings(**CTRL), use_terrain_adapt=False)
    c = j_rollout.init_carry(j_model, j_params, height=0.3, dtype=j64)
    jc = jax.tree.map(lambda a: jnp.broadcast_to(a, (CTRL_BATCH,) + a.shape),
                      c)
    dz, dv = _ctrl_noise()
    jc = jc._replace(sim=jc.sim._replace(
        root_pos=jc.sim.root_pos.at[:, 2].add(dz),
        root_lin_vel=jc.sim.root_lin_vel + dv))

    @jax.jit
    @jax.vmap
    def observe(cs, sm, fz):
        sensors = j_sim.read_sensors(sm, j_model, cs.contacts, fz, dt)
        return j_ctrl.sensor_update(cs, j_model, sensors, dt)

    @jax.jit
    @jax.vmap
    def plant(sm, tau, con, tgt):
        return j_sim.step(sm, j_model, tau, con, tgt, dt)

    # every tick hands the step the scenario-sharded layout it compiled for
    spread = NamedSharding(mesh, P(j_mesh.DATA_AXIS))

    def j_tick(cc):
        ctrl = observe(cc.ctrl, cc.sim, cc.stance_forces_z)
        ctrl = sharded(jax.device_put(ctrl, spread))
        sim, fz = plant(cc.sim, ctrl.joint_torques, ctrl.contacts,
                        ctrl.foot_pos_target_last_time)
        return j_rollout.RolloutCarry(ctrl=ctrl, sim=sim, stance_forces_z=fz)

    for k in range(CTRL_TICKS):
        if k == CTRL_TICKS - 1:
            c1 = _flip(c1, FLIPPED)
            qc = jc.ctrl.qp_warm_contacts
            jc = jc._replace(ctrl=jc.ctrl._replace(
                qp_warm_contacts=qc.at[FLIPPED].set(~qc[FLIPPED])))
        c1 = _port_tick(c1, model, single)
        jc = j_tick(jc)
        j_out = (jc.ctrl.foot_forces_grf, jc.ctrl.joint_torques,
                 jc.ctrl.qp_warm_minv)
        for name, one, want in zip(("grf", "tau", "minv"),
                                   _ctrl_outputs(c1.ctrl), j_out):
            got = ranks[f"ctrl_{name}_{k}"]
            np.testing.assert_allclose(got, one.numpy(), atol=1e-10, rtol=0,
                                       err_msg=f"{name} tick {k}")
            want = np.asarray(want)
            np.testing.assert_allclose(
                got, want, atol=1e-8 * max(1.0, np.abs(want).max()), rtol=0,
                err_msg=f"{name} tick {k} against JAX")


def test_main_sweep_mpc_parallel_2_raises_at_world_1():
    """One process is a world of one: ``--mpc-parallel 2`` raises JAX's
    ValueError (and tears its group down)."""
    with pytest.raises(ValueError, match="1 devices not divisible by mpc=2"):
        t_main.main(["--device", "cpu", "sweep", "--batch", "8",
                     "--mpc-parallel", "2"])
    assert not dist.is_initialized()
