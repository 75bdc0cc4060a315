"""PyTorch port, the one-robot steps in the parts that the card captures
as CUDA graphs (``utils/graphs.py``): ``controller.grf_mpc_pre`` ->
route read -> one of ``controller.grf_mpc_branches`` -> health read ->
"health" re-solve -> ``controller.grf_mpc_finish``.

- In float64 the parts, composed as the captured path composes them (every
  route on the whole batch of 1), equal bit for bit the per-scenario
  routing that ``compute_grf_mpc`` ran before the split (kept here as
  ``_routed_reference``: each route on its gathered sub-batch, scattered
  back), over a batch-1 trot that visits the warm, window and cold routes
  and over a tick whose negated carried inverse forces the health
  re-solve; ``compute_grf_mpc`` itself gives the same bits.
- One robot's rollout tick through the parts (``rollout.rollout`` at
  batch 1, on the CPU their plain composition) equals the JAX package's
  jitted, unbatched ``control_step`` tick to round-off (1e-8 x scale,
  tests/test_torch_control_step.py's tolerance) on each route, and with
  a forced ``warm_mode`` (no health re-solve) on a carry that fails the
  health gate.
- The launch-count bookkeeping of ``utils/graphs.py`` (a capture's moves
  of the counters taken back, added on every replay) on stand-in counter
  modules.
- ``ControlLoop.warmup()`` builds a step for every route (on the CPU the
  plain composition) and each route's step runs.
"""

import types as pytypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.config import presets as t_presets
from go1_qp_mpc_controller_torch.ctrl import controller as t_ctrl
from go1_qp_mpc_controller_torch.envs import replay as t_replay
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.envs import srb_sim as t_sim
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.runtime import loop as t_loop
from go1_qp_mpc_controller_torch.utils import graphs
from go1_qp_mpc_controller_tpu.ctrl import controller as j_ctrl
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.envs import srb_sim as j_sim
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.ops import admm as j_admm

torch.set_num_threads(1)
F64 = torch.float64
DT = 0.002
SETTINGS = dict(seg_iters=25, segments=3)      # main.py's polished cold
TROT_TICKS, WALK_AT = 130, 40


def _routed_reference(states, model, params, settings):
    """``compute_grf_mpc``'s "auto" routing as it was before the split
    into parts: each route on the sub-batch that takes it (gathered, then
    scattered back) unless the whole batch takes it, the health re-solve
    always on the gathered rejects."""
    states, lazy = t_ctrl._condensed(states, model, params, True)
    batch = lazy.gradient.shape[0]
    warm_in, transition, window = t_ctrl._transition_test(states, lazy,
                                                          params)
    branches = dict(zip(("cold", "warm", "window"), t_ctrl._grf_branches(
        settings, t_ctrl.WARM_SETTINGS)))
    route = torch.where(transition, 2, torch.where(window, 1, 0))
    counts = torch.bincount(route, minlength=3).tolist()
    x_sol = warm_out = bad = None
    routes = []
    for code, name in enumerate(("warm", "window", "cold")):
        if counts[code] == 0:
            continue
        routes.append(name)
        if counts[code] == batch:
            x_sol, warm_out, bad = branches[name](lazy, warm_in)
            break
        idx = torch.sort((route != code).to(torch.int32),
                         stable=True)[1][:counts[code]]
        x_r, w_r, bad_r = branches[name](t_ctrl._take(lazy, idx),
                                         t_ctrl._take(warm_in, idx))
        if x_sol is None:
            x_sol = torch.empty_like(lazy.gradient)
            warm_out = t_admm.WarmState(*[torch.empty_like(a)
                                          for a in warm_in])
            bad = torch.zeros_like(transition)
        x_sol[idx] = x_r
        for full, sub in zip(warm_out, w_r):
            full[idx] = sub
        bad[idx] = bad_r
    if counts[0] + counts[1] > 0:
        n_bad = int(bad.sum())
        if n_bad:
            routes.append("health")
            neutral = warm_in._replace(x=torch.zeros_like(warm_in.x),
                                       y=torch.zeros_like(warm_in.y))
            idx = torch.sort((~bad).to(torch.int32), stable=True)[1][:n_bad]
            x_b, w_b, _ = branches["cold"](t_ctrl._take(lazy, idx),
                                           t_ctrl._take(neutral, idx))
            x_sol = t_ctrl._scatter(x_sol, idx, x_b)
            warm_out = t_admm.WarmState(*[t_ctrl._scatter(a, idx, b)
                                          for a, b in zip(warm_out, w_b)])
    return t_ctrl._finish_grf(states, x_sol, warm_out, lazy.gradient), routes


def _split(states, model, params, settings):
    """The parts as the captured one-robot path runs them: pre, one route
    read, the route's solve on the whole batch, the health read and the
    "health" solve when it is set (``controller.routed_rule`` by
    ``controller.grf_routing``), the finish."""
    _, read, recheck = t_ctrl.grf_routing(t_ctrl.WARM_SETTINGS)
    pre = t_ctrl.grf_mpc_pre(states, model, params, True)
    solves = t_ctrl.grf_mpc_branches(settings, t_ctrl.WARM_SETTINGS)
    run = lambda key: (pre, pre.route) if key == "pre" else solves[key](pre)
    routes, (x_sol, warm_out) = t_ctrl.routed_rule(read, recheck)(run)
    return t_ctrl.grf_mpc_finish(pre, x_sol, warm_out), list(routes)


def _same_bits(got, want):
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert torch.equal(a, b), i


def _negate_minv(carry):
    """The carried KKT inverse negated: the warm solve fails its basin
    test and its health gate (a health re-solve)."""
    return carry._replace(ctrl=carry.ctrl._replace(
        qp_warm_minv=-carry.ctrl.qp_warm_minv))


@pytest.fixture(scope="module")
def port():
    return (t_types.default_robot_model(F64, "cpu"),
            t_types.default_ctrl_params(F64, "cpu"),
            t_admm.ADMMSettings(**SETTINGS))


def _walk(i, ctrl):
    vel = torch.zeros_like(ctrl.root_lin_vel_d)
    vel[:, 0] = 0.25 if i >= WALK_AT else 0.0
    return ctrl._replace(movement_mode=torch.full_like(
        ctrl.movement_mode, int(i >= WALK_AT)), root_lin_vel_d=vel)


@pytest.mark.parametrize("case", ["trot", "health"])
def test_split_grf_step_equals_routed_eager_bits(port, case):
    model, params, settings = port
    carry = t_rollout.init_carry(model, params, 1, dtype=F64, device="cpu")
    seen = set()
    ticks = TROT_TICKS if case == "trot" else 60
    for i in range(ticks):
        if case == "health" and i == ticks - 1:
            carry = _negate_minv(carry)
        ctrl = _walk(i, carry.ctrl) if case == "trot" else carry.ctrl
        carry = carry._replace(ctrl=ctrl)
        states = t_rollout._sense(carry, model, DT, True)
        states = t_ctrl.swing.generate_swing_legs_ctrl(
            t_ctrl.gait.update_plan(states, params, model), params, DT)
        want, routes = _routed_reference(states, model, params, settings)
        got, split_routes = _split(states, model, params, settings)
        assert split_routes == routes
        _same_bits(got, want)
        _same_bits(t_ctrl.compute_grf_mpc(states, model, params, settings),
                   want)
        seen.update(routes)
        ctrl = t_ctrl.torque.compute_joint_torques(got, params)
        carry, _ = t_rollout._plant(carry, ctrl, model, DT, None)
    if case == "trot":
        assert {"warm", "window", "cold"} <= seen, seen
    else:
        assert "health" in seen, seen


# ---- the split one-robot tick against JAX's unbatched jitted tick -------

def _jax_tick(warm_mode):
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    dt = jnp.asarray(DT, jnp.float64)
    settings = j_admm.ADMMSettings(**SETTINGS)

    def one(c):
        sensors = j_sim.read_sensors(c.sim, model, c.ctrl.contacts,
                                     c.stance_forces_z, dt)
        ctrl = j_ctrl.sensor_update(c.ctrl, model, sensors, dt)
        ctrl = j_ctrl.control_step(ctrl, model, params, dt,
                                   settings=settings, warm_mode=warm_mode)
        sim, fz = j_sim.step(c.sim, model, ctrl.joint_torques, ctrl.contacts,
                             ctrl.foot_pos_target_last_time, dt)
        return j_rollout.RolloutCarry(ctrl=ctrl, sim=sim, stance_forces_z=fz)

    return jax.jit(one)


@pytest.fixture(scope="module")
def jax_tick():
    return _jax_tick("auto")


@pytest.fixture(scope="module")
def standing(jax_tick):
    """One robot standing past the young-carry window (JAX, float64)."""
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    c = j_rollout.init_carry(model, params, height=0.3, dtype=jnp.float64)
    c = c._replace(sim=c.sim._replace(
        root_pos=c.sim.root_pos.at[2].add(0.004),
        root_lin_vel=c.sim.root_lin_vel + 0.01))
    for _ in range(50):
        c = jax_tick(c)
    return c


def _edit(c, route):
    """The next tick's route: a contact flip (cold), a negated carried
    inverse (warm, then the health re-solve), the post-flip window, or
    the steady warm tick."""
    ctrl = c.ctrl
    if route == "cold":
        ctrl = ctrl._replace(qp_warm_contacts=~ctrl.qp_warm_contacts)
    elif route == "health":
        ctrl = ctrl._replace(qp_warm_minv=-ctrl.qp_warm_minv)
    elif route == "window":
        ctrl = ctrl._replace(
            qp_warm_contacts=jnp.asarray([True, False, False, True]),
            movement_mode=jnp.asarray(1, ctrl.movement_mode.dtype),
            gait_counter=jnp.asarray([10.0, 130.0, 130.0, 10.0]))
    return c._replace(ctrl=ctrl)


def _port_tick(c, port, **kw):
    """One batch-1 ``rollout`` tick of the port from JAX's carry ``c``:
    (the next carry, the routes taken)."""
    model, params, settings = port
    nd = jax.tree.map(lambda a: np.asarray(a)[None], c)
    carry = t_rollout.RolloutCarry(
        ctrl=convert.from_numpy(t_types.CtrlState, nd.ctrl._asdict(), "cpu",
                                F64),
        sim=convert.from_numpy(t_sim.SimState, nd.sim._asdict(), "cpu", F64),
        stance_forces_z=torch.tensor(nd.stance_forces_z))
    stats = {}
    got, _ = t_rollout.rollout(carry, model, params, 1, DT, settings=settings,
                               stats=stats, **kw)
    return got, stats


def _assert_tick_close(got, want):
    for name in ("foot_forces_grf", "joint_torques", "qp_warm_x",
                 "qp_warm_y", "qp_warm_rho", "qp_warm_minv",
                 "qp_warm_contacts", "qp_warm_grad", "estimator_x"):
        w = np.asarray(getattr(want.ctrl, name)).astype(np.float64)
        g = getattr(got.ctrl, name)[0].numpy().astype(np.float64)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    np.testing.assert_allclose(got.sim.root_pos[0].numpy(),
                               np.asarray(want.sim.root_pos), atol=1e-12)


@pytest.mark.parametrize("route", ["warm", "window", "cold", "health"])
def test_split_tick_matches_jax_unbatched(jax_tick, standing, port, route):
    c = _edit(standing, route)
    got, stats = _port_tick(c, port)
    taken = {"health": "warm"}.get(route, route)
    assert stats[taken] == 1 and len(stats) <= 2, stats
    assert ("health" in stats) >= (route == "health"), stats
    _assert_tick_close(got, jax_tick(c))


@pytest.mark.parametrize("warm_mode", ["warm", "cold"])
def test_forced_mode_tick_matches_jax_unbatched(standing, port, warm_mode):
    """A forced ``warm_mode`` takes its one branch and no health re-solve,
    as JAX's ``control_step(warm_mode=...)`` does, also on a negated
    carried inverse whose warm solve fails the health gate."""
    c = _edit(standing, "health")
    got, stats = _port_tick(c, port, warm_mode=warm_mode)
    assert stats == {warm_mode: 1}, stats
    _assert_tick_close(got, _jax_tick(warm_mode)(c))


# ---- the launch-count bookkeeping ----------------------------------------

def _stand_ins():
    return {"k1": pytypes.SimpleNamespace(
                launches=3, route_launches={"cta": 1, "fp32": 2}),
            "k2": pytypes.SimpleNamespace(launches=5)}


def _launch(module, route=None, n=1):
    module.launches += n
    if route is not None:
        module.route_launches[route] += n


@pytest.mark.parametrize("replays", [0, 1, 7])
def test_capture_bookkeeping_counts_each_replay(replays):
    """The sequence a capture runs (``graphs._capture``): warm-up launches
    stay counted (and are summed apart), the capture's moves are taken
    back, every replay adds them again."""
    mods = _stand_ins()
    warm = {}
    before = graphs.snapshot(mods)
    _launch(mods["k1"], "cta", 2)                     # two warm-up runs
    warmed = graphs.snapshot(mods)
    graphs.merge_counts(warm, graphs.count_delta(before, warmed))
    _launch(mods["k1"], "cta")                        # the capture's run
    _launch(mods["k1"], "fp32")
    _launch(mods["k2"])
    step = graphs.count_delta(warmed, graphs.snapshot(mods))
    assert step == {"k1": (2, {"cta": 1, "fp32": 1}), "k2": (1, {})}
    graphs.add_counts(mods, step, -1)
    assert graphs.snapshot(mods) == warmed
    for _ in range(replays):
        graphs.add_counts(mods, step)
    assert mods["k1"].launches == 5 + 2 * replays
    assert mods["k1"].route_launches == {"cta": 3 + replays,
                                         "fp32": 2 + replays}
    assert mods["k2"].launches == 5 + replays
    assert warm == {"k1": (2, {"cta": 2})}
    graphs.merge_counts(warm, {"k1": (1, {"fp32": 1}), "k2": (4, {})})
    assert warm == {"k1": (3, {"cta": 2, "fp32": 1}), "k2": (4, {})}


def test_count_delta_lists_only_what_moved():
    mods = _stand_ins()
    before = graphs.snapshot(mods)
    assert graphs.count_delta(before, graphs.snapshot(mods)) == {}
    _launch(mods["k2"], n=3)
    assert graphs.count_delta(before, graphs.snapshot(mods)) == {
        "k2": (3, {})}


@pytest.mark.parametrize("a,keys", [(3.0, ["pos"]), (-1.0, ["neg"]),
                                    (-20.0, ["neg", "big"])])
def test_routed_step_on_the_cpu_is_the_plain_composition(a, keys):
    """On the CPU a routed ``StagedStep`` runs pre, reads the route, runs
    the branch on pre's outputs and, where ``recheck`` names a further
    branch and the flag is set, that one (``controller.routed_rule``):
    ``graphs.compose_stages``'s result."""
    def branch(scale):
        return (lambda args, mids: (mids[0][0][0] * scale,
                                    mids[0][0][0] < -10.0), ("pre",))

    stages = graphs.Stages(
        {"pre": (lambda args, mids: ((args[0] + args[1],),
                                     (args[0] > 0).to(torch.int64)), ()),
         "neg": branch(-1.0), "pos": branch(2.0), "big": branch(0.0)},
        t_ctrl.routed_rule(lambda code: ("neg", "pos")[int(code[0])],
                           {"neg": "big"}))
    step = graphs.StagedStep(stages, torch.ones(1), torch.ones(1))
    args = (torch.full((1,), a), torch.ones(1))
    got_keys, out = step(*args)
    want_keys, want = graphs.compose_stages(stages, *args)
    assert list(got_keys) == list(want_keys) == keys
    assert torch.equal(out[0], want[0])


# ---- ControlLoop.warmup ----------------------------------------------------

@pytest.mark.parametrize("preset,dual", [("gazebo_mpc", True),
                                         ("gazebo_mpc", False),
                                         ("hardware_qp", True)])
def test_warmup_builds_a_step_for_every_route(preset, dual):
    model, params, static = t_presets.load_preset(preset, F64, device="cpu")
    cl = t_loop.ControlLoop(model, params, static,
                            t_types.init_ctrl_state(model, 1, F64, "cpu"))
    try:
        cl.warmup(dual=dual)
        step = cl._grf if dual else cl._full
        assert isinstance(step, graphs.StagedStep)
        if static.solver == "qp":
            assert set(step.stages.parts) == {"qp"}
            assert cl._fast is not None
            out = t_ctrl.run_tick(step, (cl.state, cl.params))
            assert torch.isfinite(out[0][0]).all()
            return
        assert set(step.stages.parts) == {"pre", "warm", "window", "cold",
                                          "health"}
        args = ((cl.state, cl.params) if dual else
                (cl.state, cl.model, cl.params, cl._sensor_data({
                    "quat": [1.0, 0, 0, 0], "acc": [0, 0, 9.8],
                    "gyro": np.zeros(3),
                    "joint_pos": cl.state.joint_pos[0].numpy(),
                    "joint_vel": np.zeros(12),
                    "foot_force": np.full(4, 50.0)})))
        keys, _ = step(*args)
        assert keys == ("cold",)              # the young carry
        # every route, each part on pre's outputs (on the card the
        # replays; here their plain composition)
        parts = step.stages.parts
        pre = parts["pre"][0](args, ())
        for name in ("warm", "window", "cold", "health"):
            out = parts[name][0](args, (pre,))
            assert all(torch.isfinite(t).all()
                       for t in pytree.tree_leaves(out[0])
                       if t.is_floating_point()), name
        assert (cl._fast is not None) == dual
    finally:
        cl.close()


def test_replay_parts_equal_the_eager_replay_tick(port):
    """``replay_rollout``'s batch-1 tick through its parts equals the
    eager sensor update + ``control_step`` bit for bit (float64)."""
    model, params, settings = port
    carry = t_rollout.init_carry(model, params, 1, dtype=F64, device="cpu")
    sensors = t_sim.read_sensors(carry.sim, model, carry.ctrl.contacts,
                                 carry.stance_forces_z, DT)
    log = t_replay.SensorLog(*[torch.stack([leaf] * 3) for leaf in sensors])
    state, got = t_replay.replay_rollout(carry.ctrl, model, params, log, DT,
                                         settings=settings)
    want_state = carry.ctrl
    for t in range(3):
        want_state = t_ctrl.sensor_update(want_state, model, sensors, DT)
        want_state = t_ctrl.control_step(want_state, model, params, DT,
                                         settings=settings)
        assert torch.equal(got["joint_torques"][t], want_state.joint_torques)
    _same_bits(state, want_state)
