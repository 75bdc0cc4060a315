"""The controller tick: sensors -> estimation -> plan -> GRF -> torques.

Port of the JAX package's ``ctrl/controller.py``. Every function takes a
batch of scenarios (a leading axis ``B`` on every ``CtrlState`` leaf):

- :func:`sensor_update` runs the observe + EKF stage (kernel K2 on CUDA);
- :func:`control_step_batched` chains plan -> swing -> MPC GRF solve ->
  torques, with :func:`compute_grf_mpc_batched` routing the GRF solve
  three ways over the whole batch (warm / compacted cold sub-batch /
  whole-batch cold);
- :func:`control_step` is the per-scenario tick (the JAX package's
  ``control_step`` under vmap): MPC (:func:`compute_grf_mpc`, each
  scenario routed warm / window / cold on its own; with
  ``receding_horizon`` the averaged-euler, receding-foothold condensation
  solved cold each tick), the long-horizon MPC
  (:func:`compute_grf_mpc_stagewise`, a ``horizon`` other than 10) or the
  balance QP (:func:`compute_grf_qp`).

The lazy-factor solve programs reach kernel K1; the dense polished cold
solve, the receding variant and the balance QP reach K3, through
``ops/admm.py``; the stagewise solver's Riccati pass reaches K3 at n = 12
(``ops/stagewise.py``).

The JAX package routes with ``lax.cond`` / ``lax.switch`` on device
predicates; here the routing is host branching, so a tick waits on the
device at most twice (see :func:`compute_grf_mpc_batched` and
:func:`compute_grf_mpc`). At batch 1 the per-scenario tick comes in
fixed-shape parts (:func:`grf_mpc_pre`, :func:`grf_mpc_branches`,
:func:`grf_mpc_finish`; :func:`grf_parts`, :func:`tick_parts`), which the
one-robot paths capture as CUDA graphs, one per route
(``utils/graphs.StagedStep``); :func:`grf_routing` is the one routing
rule of both, :func:`routed_rule` its host side. The batched tick comes
in fixed-shape parts too (:func:`grf_batched_parts`,
:func:`tick_batched_parts`: the whole batch or the gathered
``compact_k`` sub-batch), routed by :func:`batched_routing`, which
:func:`compute_grf_mpc_batched` and :func:`control_step_batched` compose
plainly and ``envs/rollout.py::rollout_batched`` captures on the card.
"""

from typing import NamedTuple

import torch

from go1_qp_mpc_controller_torch.config import params as P
from go1_qp_mpc_controller_torch.ctrl import gait, swing, terrain, torque
from go1_qp_mpc_controller_torch.models import kinematics, srb, types
from go1_qp_mpc_controller_torch.ops import admm, observe_ekf, qp, stagewise
from go1_qp_mpc_controller_torch.utils import graphs, rotations
from go1_qp_mpc_controller_torch.utils.device import pin_f32_matmuls

# Schedules and routing thresholds, copied from the JAX package's
# controller.py, whose comments record the measurements behind each.
# schulz_impl "auto" takes K1 (the CUDA kernel on float32 CUDA tensors).
WARM_SETTINGS = admm.ADMMSettings(seg_iters=20, segments=1, polish=False,
                                  schulz_refine=1, schulz_impl="auto")
ROBUST_WARM_SETTINGS = admm.ADMMSettings(seg_iters=40, segments=1,
                                         polish=False,
                                         schulz_l0_refine=1e-4,
                                         schulz_impl="pallas",
                                         adapt_warm_rho=True,
                                         rho_min=0.02, rho_max=50.0)
WARM_RHO_MIN = 0.02
WARM_RHO_MAX = 50.0
WARM_DRIFT_TOL = 0.2
WARM_YOUNG_TICKS = 40
WARM_POSTFLIP_TICKS = 10.0
WARM_POSTFLIP_COLD_TICKS = 3.0
WINDOW_WARM_SETTINGS = admm.ADMMSettings(seg_iters=80, segments=1,
                                         polish=False, schulz_refine=1,
                                         schulz_impl="auto")
WARM_PREFLIP_TICKS = 2.0
_WARM_HEALTH_PRIM_REL = 8e-4
_WARM_HEALTH_DUAL_REL = 0.15

MPC = 1   # stance_leg_control_type values (A1CtrlStates.h:330)
QP = 0


class SensorData(NamedTuple):
    """Raw per-tick sensor sample, batch first."""
    quat_wxyz: torch.Tensor    # (B, 4) IMU orientation
    imu_acc: torch.Tensor      # (B, 3) body-frame accelerometer
    imu_ang_vel: torch.Tensor  # (B, 3) body-frame gyro
    joint_pos: torch.Tensor    # (B, 12)
    joint_vel: torch.Tensor    # (B, 12)
    foot_force: torch.Tensor   # (B, 4) contact sensor normal forces


def _gait_speed(params):
    return torch.clamp(torch.amax(params.gait_counter_speed), min=1e-6)


def _post_flip(state, params, ticks=WARM_POSTFLIP_TICKS):
    """(B,) bool: within ``ticks`` control ticks after any leg's
    stance/swing hand-off."""
    phase = torch.remainder(state.gait_counter, params.counter_per_gait)
    cps = params.counter_per_swing
    since = torch.where(phase >= cps, phase - cps, phase)
    return ((state.movement_mode != 0)
            & (torch.amin(since, dim=-1) < ticks * _gait_speed(params)))


def _pre_flip(state, params, ticks=WARM_PREFLIP_TICKS):
    """(B,) bool: within ``ticks`` control ticks before any leg's next
    stance/swing hand-off."""
    phase = torch.remainder(state.gait_counter, params.counter_per_gait)
    cps = params.counter_per_swing
    until = torch.where(phase >= cps, params.counter_per_gait - phase,
                        cps - phase)
    return ((state.movement_mode != 0)
            & (torch.amin(until, dim=-1) <= ticks * _gait_speed(params)))


def sensor_update(state, model, sensors, dt, estimate=True,
                  contact_force_norm=100.0):
    """Ingest sensors, refresh kinematics and run the KF for a batch.

    With ``estimate`` the whole observe + EKF stage is kernel K2
    (``observe_ekf.observe_ekf``: one launch on float32 CUDA input, the
    plain version on the CPU). ``dt`` is the estimator step, a float.
    """
    geom = model.leg_geometry
    if estimate:
        out = observe_ekf.observe_ekf(
            state.estimator_x, state.estimator_P, sensors.quat_wxyz,
            sensors.imu_acc, sensors.imu_ang_vel, sensors.joint_pos,
            sensors.joint_vel, sensors.foot_force, state.movement_mode,
            dt, geom.rho_opt, geom.rho_fix,
            contact_force_norm=contact_force_norm)
        return state._replace(
            root_rot_mat=out["rot"], root_euler=out["euler"],
            root_rot_mat_z=out["rot_z"],
            imu_acc=sensors.imu_acc, imu_ang_vel=sensors.imu_ang_vel,
            joint_pos=sensors.joint_pos, joint_vel=sensors.joint_vel,
            foot_force=sensors.foot_force,
            foot_pos_rel=out["foot_pos_rel"],
            foot_pos_abs=out["foot_pos_abs"],
            foot_vel_rel=out["foot_vel_rel"],
            j_foot=out["j_foot"], root_ang_vel=out["root_ang_vel"],
            estimator_x=out["x"], estimator_P=out["P"],
            estimated_contacts=out["est_contacts"] >= 0.5,
            root_pos=out["x"][:, 0:3], root_lin_vel=out["x"][:, 3:6])

    batch = sensors.joint_pos.shape[0]
    rot = rotations.quat_to_rot_mat(sensors.quat_wxyz)
    euler = rotations.quat_to_euler(sensors.quat_wxyz)
    q_legs = sensors.joint_pos.reshape(batch, 4, 3)
    foot_pos_rel = kinematics.fk(q_legs, geom.rho_opt, geom.rho_fix)
    j_foot = kinematics.jac(q_legs, geom.rho_opt, geom.rho_fix)
    foot_vel_rel = torch.einsum('blij,blj->bli', j_foot,
                                sensors.joint_vel.reshape(batch, 4, 3))
    return state._replace(
        root_rot_mat=rot, root_euler=euler,
        root_rot_mat_z=rotations.rot_z(euler[:, 2]),
        imu_acc=sensors.imu_acc, imu_ang_vel=sensors.imu_ang_vel,
        joint_pos=sensors.joint_pos, joint_vel=sensors.joint_vel,
        foot_force=sensors.foot_force, foot_pos_rel=foot_pos_rel,
        foot_pos_abs=foot_pos_rel @ rot.transpose(-1, -2),
        foot_vel_rel=foot_vel_rel, j_foot=j_foot,
        root_ang_vel=(rot @ sensors.imu_ang_vel[..., None])[..., 0])


def _transition_test(state, lazy, params):
    """Per-scenario cold-route test + warm-carry repair.

    Returns (warm_in, transition, window): the carried WarmState with flip
    repair (duals restarted, newly-infeasible swing primal entries zeroed),
    the (B,) cold-route flags (contact flip, young carry, gradient drift,
    pre-flip / early post-flip sub-windows) and the (B,) post-flip window
    flags.
    """
    warm_in = admm.WarmState(
        x=state.qp_warm_x, y=state.qp_warm_y,
        rho=torch.clamp(state.qp_warm_rho, WARM_RHO_MIN, WARM_RHO_MAX),
        minv=state.qp_warm_minv)
    amax = lambda a: torch.amax(torch.abs(a), dim=-1)
    den = torch.maximum(amax(lazy.gradient),
                        0.05 * torch.amax(srb.lazy_hessian_diag(lazy),
                                          dim=-1) * 180.0)
    grad_drift = amax(lazy.gradient - state.qp_warm_grad) / (den + 1e-9)
    contact_flip = torch.any(state.contacts != state.qp_warm_contacts,
                             dim=-1)
    transition = (contact_flip
                  | (state.mpc_init_counter < WARM_YOUNG_TICKS)
                  | (grad_drift > WARM_DRIFT_TOL)
                  | _post_flip(state, params, WARM_POSTFLIP_COLD_TICKS)
                  | _pre_flip(state, params))
    window = _post_flip(state, params)
    swing_u = (~state.contacts).repeat_interleave(3, dim=-1).to(
        warm_in.x.dtype)
    x_flip = warm_in.x * (1.0 - swing_u.repeat(1, P.PLAN_HORIZON))
    flip = contact_flip[:, None]
    warm_in = warm_in._replace(
        x=torch.where(flip, x_flip, warm_in.x),
        y=torch.where(flip, torch.zeros_like(warm_in.y), warm_in.y))
    return warm_in, transition, window


def _unhealthy(sol, lazy):
    """(B,) bool: the warm/window solve's own residuals are not
    trustworthy (relative thresholds, see the JAX package)."""
    z_scale = torch.clamp(torch.amax(torch.abs(sol.z), dim=-1), min=1.0)
    g_scale = torch.maximum(torch.amax(torch.abs(lazy.gradient), dim=-1),
                            torch.amax(srb.lazy_hessian_diag(lazy), dim=-1))
    return ((sol.primal_res > _WARM_HEALTH_PRIM_REL * z_scale)
            | (sol.dual_res > _WARM_HEALTH_DUAL_REL * g_scale))


def _grf_branches(settings, warm_settings, window_settings=None):
    """(cold_branch, warm_branch, window_branch): LazyCondensedQP x
    WarmState -> (x_sol, WarmState, bad), batched. Transition solves adapt
    rho only inside the warm-viable band; ``bad`` is the a-posteriori
    health flag (all False from the cold branch)."""
    if window_settings is None:
        window_settings = WINDOW_WARM_SETTINGS
    settings_t = settings._replace(
        rho_min=max(settings.rho_min, WARM_RHO_MIN),
        rho_max=min(settings.rho_max, WARM_RHO_MAX))

    def cold_branch(lz, warm):
        if not settings_t.polish and not settings_t.refine_f64:
            # segmented transition solve on the lazy factors (K1)
            sol, w = admm.solve_segmented_fused(lz, settings_t, P.MPC_MU,
                                                warm)
        else:
            # polish needs the materialized Hessian: the dense solve (K3)
            dense = srb.CondensedQP(hessian=srb.lazy_hessian(lz),
                                    gradient=lz.gradient, lb=lz.lb,
                                    ub=lz.ub)
            sol, w = admm.mpc_solve(dense, settings_t, warm_x=warm.x,
                                    warm_y=warm.y, warm_rho=warm.rho,
                                    return_warm=True)
        return sol.x, w, torch.zeros_like(sol.rho, dtype=torch.bool)

    def warm_branch(lz, warm):
        sol, w = admm.mpc_solve_warm_fused(lz, warm, warm_settings)
        return sol.x, w, _unhealthy(sol, lz)

    def window_branch(lz, warm):
        sol, w = admm.mpc_solve_warm_fused(lz, warm, window_settings)
        return sol.x, w, _unhealthy(sol, lz)

    return cold_branch, warm_branch, window_branch


def _take(tree, idx):
    return type(tree)(*[a[idx] for a in tree])


def _mpc_inputs(states, model, params, use_terrain_adapt,
                horizon=P.PLAN_HORIZON):
    """Terrain adaptation, then what every MPC condensation reads: the
    state x0, the reference over ``horizon`` steps, the desired world
    velocity and the feet the MPC holds over the horizon (stance feet where
    they are, swing feet at their planned footholds: solution-neutral, and
    it keeps the KKT nearly constant between transitions). Returns
    (states, x0, x_ref, vel_d_world, foot_pos_mpc)."""
    states = terrain.terrain_adaptation(states, use_terrain_adapt)
    x0 = srb.mpc_state(states.root_euler, states.root_pos,
                       states.root_ang_vel, states.root_lin_vel)
    vel_d_world = (states.root_rot_mat
                   @ states.root_lin_vel_d[..., None])[..., 0]
    x_ref = srb.reference_trajectory(
        states.root_pos, states.root_euler, states.root_pos_d,
        states.root_euler_d, states.root_ang_vel_d, vel_d_world,
        params.mpc_dt, horizon=horizon)
    foot_pos_mpc = torch.where(states.contacts[..., None],
                               states.foot_pos_abs,
                               states.foot_pos_target_abs)
    return states, x0, x_ref, vel_d_world, foot_pos_mpc


def _discrete(states, model, params, foot_pos_mpc):
    """(A_d, B_d) of the batch, linearized at the current euler, with B_d
    shared across the horizon (A1RobotControl.cpp:498-514)."""
    a_c = srb.calculate_A_c(states.root_euler)
    b_c = srb.calculate_B_c(model.mass, model.trunk_inertia,
                            states.root_rot_mat, foot_pos_mpc)
    return srb.discretize(a_c, b_c, params.mpc_dt)


def _condensed(states, model, params, use_terrain_adapt):
    """Terrain adaptation, then the lazy horizon-10 condensed QP of every
    scenario. Returns (states, lazy)."""
    states, x0, x_ref, _, foot_pos_mpc = _mpc_inputs(
        states, model, params, use_terrain_adapt)
    a_d, b_d = _discrete(states, model, params, foot_pos_mpc)
    return states, srb.condense_nilpotent_lazy(
        a_d, b_d, x0, x_ref, params.q_weights, params.r_weights,
        states.contacts)


def _receding(states, model, params, settings, use_terrain_adapt):
    """The receding-horizon variant (test/test_mpc.cpp:93-122; commented
    out in A1RobotControl.cpp:505-509): A_c linearized at the
    horizon-averaged euler, each step's B from feet displaced by
    -i v_d dt, condensed in closed form and solved cold every tick by the
    dense solver (K3, K6) warm-started with primal / dual only."""
    states, x0, x_ref, vel_d_world, foot_pos_mpc = _mpc_inputs(
        states, model, params, use_terrain_adapt)
    a_c = srb.calculate_A_c(srb.averaged_euler(
        states.root_euler, states.root_ang_vel_d, params.mpc_dt))
    a_d = torch.eye(srb.NX, dtype=a_c.dtype, device=a_c.device) \
        + a_c * params.mpc_dt
    b_d_list = srb.receding_b_d_list(model.mass, model.trunk_inertia,
                                     states.root_rot_mat, foot_pos_mpc,
                                     vel_d_world, params.mpc_dt)
    qp_dense = srb.condense_nilpotent(a_d, b_d_list, x0, x_ref,
                                      params.q_weights, params.r_weights,
                                      states.contacts)
    sol = admm.mpc_solve(qp_dense, settings, warm_x=states.qp_warm_x,
                         warm_y=states.qp_warm_y)
    warm_out = admm.WarmState(x=sol.x, y=sol.y, rho=states.qp_warm_rho,
                              minv=states.qp_warm_minv)
    return _finish_grf(states, sol.x, warm_out, states.qp_warm_grad)


def _scatter(full, idx, sub):
    """``full`` with rows ``idx`` replaced by ``sub`` (a new tensor)."""
    out = full.clone()
    out[idx] = sub
    return out


# the per-scenario MPC routes by code (:func:`grf_mpc_pre`'s ``route``)
ROUTES = ("warm", "window", "cold")


class GrfPre(NamedTuple):
    """What every route of :func:`compute_grf_mpc` reads (batched)."""
    states: types.CtrlState      # after terrain adaptation
    lazy: srb.LazyCondensedQP
    warm_in: admm.WarmState      # the carry after flip repair
    route: torch.Tensor          # (B,) int64 index into ROUTES


def grf_mpc_pre(states, model, params, use_terrain_adapt=True):
    """The part of :func:`compute_grf_mpc` before its routing: the lazy
    condensation, the transition test and each scenario's route code."""
    states, lazy = _condensed(states, model, params, use_terrain_adapt)
    warm_in, transition, window = _transition_test(states, lazy, params)
    route = torch.where(transition, 2, torch.where(window, 1, 0))
    return GrfPre(states, lazy, warm_in, route)


def grf_mpc_branches(settings, warm_settings, window_settings=None):
    """The solves of :func:`compute_grf_mpc`, {name: fn(GrfPre) -> (x_sol,
    WarmState, bad)}, each on the pre's whole batch: "warm", "window" and
    "cold" (:data:`ROUTES`) and "health", the cold re-solve of a
    health-rejected carry. With ``warm_settings`` None the only one is
    "plain": the cold ``settings`` solve from the carried primal / dual.
    ``bad`` is the warm and window solves' health flag (all False from
    the others)."""
    if warm_settings is None:
        def plain(pre):
            dense = srb.CondensedQP(hessian=srb.lazy_hessian(pre.lazy),
                                    gradient=pre.lazy.gradient,
                                    lb=pre.lazy.lb, ub=pre.lazy.ub)
            sol = admm.mpc_solve(dense, settings,
                                 warm_x=pre.states.qp_warm_x,
                                 warm_y=pre.states.qp_warm_y)
            warm_out = admm.WarmState(x=sol.x, y=sol.y,
                                      rho=pre.states.qp_warm_rho,
                                      minv=pre.states.qp_warm_minv)
            return sol.x, warm_out, torch.zeros_like(sol.rho,
                                                     dtype=torch.bool)
        return {"plain": plain}
    fns = dict(zip(("cold", "warm", "window"),
                   _grf_branches(settings, warm_settings, window_settings)))

    def health(lz, warm):
        # a health-rejected carry is garbage by construction: its cold
        # re-solve starts neutral
        return fns["cold"](lz, warm._replace(x=torch.zeros_like(warm.x),
                                             y=torch.zeros_like(warm.y)))

    fns["health"] = health
    return {name: (lambda pre, fn=fn: fn(pre.lazy, pre.warm_in))
            for name, fn in fns.items()}


def grf_mpc_finish(pre, x_sol, warm_out):
    """The tail of :func:`compute_grf_mpc` after a route's solve."""
    return _finish_grf(pre.states, x_sol, warm_out, pre.lazy.gradient)


def _sub_pre(pre, idx):
    """The scenarios ``idx`` of a GrfPre, for the routes' solves."""
    return pre._replace(lazy=_take(pre.lazy, idx),
                        warm_in=_take(pre.warm_in, idx))


def compute_grf_mpc(states, model, params, settings=admm.ADMMSettings(),
                    use_terrain_adapt=True, warm_settings=WARM_SETTINGS,
                    receding_horizon=False, warm_mode="auto",
                    window_settings=None, stats=None):
    """Horizon-10 condensed MPC solve with per-scenario routing (the JAX
    package's ``compute_grf_mpc``; A1RobotControl.cpp:446-561).

    The carried warm state takes the warm tick on the lazy factors; a
    contact flip, a young carry, a gradient jump or the pre-flip / early
    post-flip sub-windows take the cold ``settings`` solve (dense and
    polished when ``settings.polish``); the rest of the post-flip window
    takes the long warm segment. A warm or window result that fails the
    residual health gate is re-solved cold from a neutral start.

    The composition of :func:`grf_mpc_pre`, the solves of
    :func:`grf_mpc_branches` and :func:`grf_mpc_finish`, which a caller
    can capture one by one (``envs/rollout.py``, ``runtime/loop.py``).
    Each scenario of the batch takes exactly the route it would take
    alone: a route that not every scenario takes runs on the sub-batch
    that takes it (gathered, then scattered back). The route vector
    reaches the host in one device-to-host copy a tick, and the health
    flags in one more when a warm or window sub-batch ran.

    Args:
      warm_settings: settings of the warm tick, or None to solve cold every
        tick with ``settings`` (warm-started with primal / dual only).
      warm_mode: "auto" (the routing above), "warm" (always the warm tick:
        the caller owns the cadence) or "cold" (always the cold branch).
      receding_horizon: the averaged-euler, receding-foothold
        condensation variant instead, solved cold every tick with primal /
        dual warm starts (``warm_settings`` and ``warm_mode`` are ignored:
        per-step B breaks the factored form the warm tick needs).
      stats: optional dict; the scenarios of each route ("warm", "window",
        "cold", and "health" for the cold re-solves) are counted into it.
    """
    if receding_horizon:
        _count(stats, "cold", states.contacts.shape[0])
        return _receding(states, model, params, settings, use_terrain_adapt)
    names, _, recheck = grf_routing(warm_settings, warm_mode)
    pre = grf_mpc_pre(states, model, params, use_terrain_adapt)
    branches = grf_mpc_branches(settings, warm_settings, window_settings)
    batch = pre.route.shape[0]
    if len(names) == 1:                     # one route for all
        x_sol, warm_out, _ = branches[names[0]](pre)
        _count(stats, "cold" if names[0] == "plain" else names[0], batch)
        return grf_mpc_finish(pre, x_sol, warm_out)

    # device-to-host copy 1 of at most 2
    counts = torch.bincount(pre.route, minlength=3).tolist()
    x_sol = warm_out = bad = None
    for code, name in enumerate(ROUTES):
        if counts[code] == 0:
            continue
        _count(stats, name, counts[code])
        if counts[code] == batch:
            x_sol, warm_out, bad = branches[name](pre)
            break
        # the scenarios of this route first, in ascending order
        idx = torch.sort((pre.route != code).to(torch.int32),
                         stable=True)[1][:counts[code]]
        x_r, w_r, bad_r = branches[name](_sub_pre(pre, idx))
        if x_sol is None:
            x_sol = torch.empty_like(pre.lazy.gradient)
            warm_out = admm.WarmState(*[torch.empty_like(a)
                                        for a in pre.warm_in])
            bad = torch.zeros_like(pre.route, dtype=torch.bool)
        x_sol[idx] = x_r
        for full, sub in zip(warm_out, w_r):
            full[idx] = sub
        bad[idx] = bad_r

    checked = [recheck[name] for code, name in enumerate(ROUTES)
               if counts[code] and name in recheck]
    if checked:
        n_bad = int(bad.sum())              # device-to-host copy 2
        if n_bad == batch:
            _count(stats, checked[0], n_bad)
            x_sol, warm_out, _ = branches[checked[0]](pre)
        elif n_bad:
            _count(stats, checked[0], n_bad)
            idx = torch.sort((~bad).to(torch.int32), stable=True)[1][:n_bad]
            x_b, w_b, _ = branches[checked[0]](_sub_pre(pre, idx))
            x_sol = _scatter(x_sol, idx, x_b)
            warm_out = admm.WarmState(*[_scatter(a, idx, b)
                                        for a, b in zip(warm_out, w_b)])
    return grf_mpc_finish(pre, x_sol, warm_out)


def read_route(code):
    """The route of a batch-1 route code (the tick's host read)."""
    return ROUTES[int(code[0])]


def grf_routing(warm_settings, warm_mode="auto"):
    """How the per-scenario MPC solve routes, as the JAX package's
    ``control_step`` does: (the branches of :func:`grf_mpc_branches` a tick
    may take, the read that names a batch-1 route code's branch, the
    branches whose result takes the health read and the re-solve its flag
    calls for). In "auto" mode: "warm", "window" and "cold" by the route
    code, "warm" and "window" rechecked by "health"; a forced ``warm_mode``
    takes its branch, without ``warm_settings`` "plain", neither
    rechecked. :func:`compute_grf_mpc` routes by it at any batch,
    :func:`grf_parts` at batch 1 (:func:`routed_rule`)."""
    if warm_mode not in ("auto", "warm", "cold"):
        raise ValueError(f"unknown warm_mode {warm_mode!r}")
    if warm_settings is None or warm_mode != "auto":
        name = "plain" if warm_settings is None else warm_mode
        return (name,), (lambda code: name), {}
    return (ROUTES + ("health",), read_route,
            {"warm": "health", "window": "health"})


def routed_rule(read, recheck):
    """The host side of a batch-1 routed step (:func:`grf_routing`), a
    ``graphs.Stages`` rule over a part "pre" -> (mid, route code) and one
    part per branch -> (outputs..., flag): part "pre", one host read of
    its code that names the branch, the branch, and where ``recheck``
    names a further branch for it, the flag's host read and, when the flag
    is set, that branch. Returns (the routes run, "plain" counted as
    "cold"; the last branch's outputs without the flag)."""
    def rule(run):
        _, code = run("pre")
        keys = (read(code),)
        out = run(keys[0])
        again = recheck.get(keys[0])
        if again is not None and bool(out[-1].any()):  # the flag's host read
            keys, out = keys + (again,), run(again)
        return tuple("cold" if k == "plain" else k for k in keys), out[:-1]
    return rule


def grf_parts(solver_type=MPC, settings=admm.ADMMSettings(),
              use_terrain_adapt=True, warm_settings=WARM_SETTINGS,
              warm_mode="auto"):
    """One robot's GRF solve (:func:`compute_grf_mpc` at horizon 10, or
    :func:`compute_grf_qp`) as ``graphs.Stages`` over ``(states, model,
    params)``, for callers that nest it (``graphs.nest``): "pre" ->
    (GrfPre, route code), each branch -> (states, bad), routed by
    :func:`routed_rule`; the balance QP's one unrouted part -> (states,).
    Either composition returns (states,)."""
    if solver_type == QP:
        return graphs.Stages(
            {"qp": (lambda args, mids: (compute_grf_qp(*args, settings),),
                    ())}, lambda run: ((), run("qp")))
    if solver_type != MPC:
        raise ValueError(f"unknown solver_type {solver_type!r}")
    names, read, recheck = grf_routing(warm_settings, warm_mode)
    solves = grf_mpc_branches(settings, warm_settings)

    def pre(args, mids):
        p = grf_mpc_pre(*args, use_terrain_adapt)
        return p, p.route

    def branch(solve):
        def run(args, mids):
            (p, _), = mids
            x_sol, warm_out, bad = solve(p)
            return grf_mpc_finish(p, x_sol, warm_out), bad
        return run

    parts = {"pre": (pre, ())}
    parts.update({name: (branch(solves[name]), ("pre",)) for name in names})
    return graphs.Stages(parts, routed_rule(read, recheck))


def _planned(dt):
    """The tick's plan and swing stages, as ``graphs.nest``'s ``enter``
    over ``(states, model, params, ...)``."""
    def plan(args):
        states, model, params = args[:3]
        pin_f32_matmuls()
        states = gait.update_plan(states, params, model)
        return (swing.generate_swing_legs_ctrl(states, params, dt), model,
                params)
    return plan


def _torques(args, out):
    """The tick's torques on a GRF part's (states, ...), as
    ``graphs.nest``'s ``leave``: the parameters are the third argument."""
    return (torque.compute_joint_torques(out[0], args[2]), *out[1:])


def tick_parts(dt, solver_type=MPC, settings=admm.ADMMSettings(),
               use_terrain_adapt=True, warm_settings=WARM_SETTINGS,
               warm_mode="auto"):
    """:func:`control_step` (horizon 10) of one robot as ``graphs.Stages``
    over ``(states, model, params)``: plan -> swing -> :func:`grf_parts`
    -> torques; either composition returns (states,). ``dt`` is a
    float."""
    return graphs.nest(grf_parts(solver_type, settings, use_terrain_adapt,
                                 warm_settings, warm_mode),
                       _planned(dt), _torques)


def run_tick(step, args, stats=None):
    """One tick through ``step`` (a ``graphs.StagedStep``): counts the
    routes its rule took into ``stats`` (:func:`routed_rule`, one robot;
    :func:`batched_routing`, a batch) and returns its outputs."""
    routes, out = step(*args)
    for route in routes:
        _count(stats, route)
    return out


def compute_grf_mpc_stagewise(states, model, params,
                              settings=admm.ADMMSettings(),
                              use_terrain_adapt=True,
                              warm_settings=WARM_SETTINGS, horizon=40,
                              warm_mode="auto", stats=None):
    """Long-horizon MPC GRF solve by the stagewise O(H) Riccati-ADMM solver
    (``ops/stagewise.py``; the JAX package's
    ``compute_grf_mpc_stagewise``), each scenario routed on its own.

    Steady ticks run one short warm segment (``warm_settings``) from the
    carried primal / dual; a contact flip, a young carry, the post-flip
    window, the pre-flip window or a gradient drift against the
    ``den_sw`` floor route to a full cold solve (``settings``). The
    carry's flip repair restarts the duals and zeroes the newly swinging
    legs' forces, as the condensed path does. The cold and warm scenarios
    are gathered into sub-batches, solved and scattered back: the route
    vector reaches the host in one device-to-host copy a tick. The state
    must come from ``init_ctrl_state(horizon=H)``.

    Args:
      horizon: H > 0, independent of PLAN_HORIZON.
      warm_settings: the warm segment's settings.
      warm_mode: "auto", or "warm" / "cold" to take one route for all.
      stats: optional dict counting the scenarios of each route.
    """
    h = horizon
    states, x0, x_ref, _, foot_pos_mpc = _mpc_inputs(
        states, model, params, use_terrain_adapt, horizon=h)
    a_d, b_d = _discrete(states, model, params, foot_pos_mpc)
    batch = x0.shape[0]

    q_lin = stagewise.linear_term(a_d, b_d, x0, x_ref, params.q_weights,
                                  params.r_weights).reshape(batch, -1)
    # the condensed path's force-scale floor (the stagewise per-stage
    # Hessian block is 2 (R + B'QB))
    h_diag_sw = 2.0 * (params.r_weights + torch.sum(
        params.q_weights[:, None] * b_d ** 2, dim=-2))
    amax = lambda a: torch.amax(torch.abs(a), dim=-1)
    den_sw = torch.maximum(amax(q_lin),
                           0.05 * torch.amax(h_diag_sw, dim=-1) * 180.0)
    grad_drift = amax(q_lin - states.qp_warm_grad) / (den_sw + 1e-9)
    contact_flip = torch.any(states.contacts != states.qp_warm_contacts,
                             dim=-1)
    # the whole post-flip window and the pre-flip guard route cold: the
    # cold solve is the long-budget program here
    transition = (contact_flip
                  | (states.mpc_init_counter < WARM_YOUNG_TICKS)
                  | _post_flip(states, params) | _pre_flip(states, params)
                  | (grad_drift > WARM_DRIFT_TOL))

    swing_u = (~states.contacts).repeat_interleave(3, dim=-1).to(x0.dtype)
    u_carry = states.qp_warm_x.reshape(batch, h, P.NUM_DOF)
    y_carry = states.qp_warm_y.reshape(batch, h, P.MPC_CONSTRAINT_DIM)
    flip = contact_flip[:, None, None]
    warm_in = stagewise.StagewiseWarmState(
        u=torch.where(flip, u_carry * (1.0 - swing_u)[:, None], u_carry),
        y=torch.where(flip, torch.zeros_like(y_carry), y_carry),
        rho=torch.clamp(states.qp_warm_rho, WARM_RHO_MIN, WARM_RHO_MAX),
        q_lin=states.qp_warm_grad.reshape(batch, h, P.NUM_DOF))
    settings_t = settings._replace(
        rho_min=max(settings.rho_min, WARM_RHO_MIN),
        rho_max=min(settings.rho_max, WARM_RHO_MAX))
    problem = (a_d, b_d, x0, x_ref, states.contacts)

    def solve(route, sub, warm):
        """(u, y, rho) of the next carry; its u is the solution."""
        a, b, x, r, c = sub
        if route == "cold":
            _, w = stagewise.mpc_solve(a, b, x, r, params.q_weights,
                                       params.r_weights, c,
                                       settings=settings_t, return_warm=True)
        else:
            _, w = stagewise.mpc_solve_warm(a, b, x, r, params.q_weights,
                                            params.r_weights, c, warm,
                                            settings=warm_settings)
        return w.u, w.y, w.rho

    if warm_mode in ("warm", "cold"):
        _count(stats, warm_mode, batch)
        u, y, rho = solve(warm_mode, problem, warm_in)
    elif warm_mode != "auto":
        raise ValueError(f"unknown warm_mode {warm_mode!r}")
    else:
        n_cold = int(transition.sum())       # the tick's device-to-host copy
        if n_cold in (0, batch):
            route = "cold" if n_cold else "warm"
            _count(stats, route, batch)
            u, y, rho = solve(route, problem, warm_in)
        else:
            u = torch.empty_like(warm_in.u)
            y = torch.empty_like(warm_in.y)
            rho = torch.empty_like(warm_in.rho)
            # cold scenarios first, each route in ascending order
            order = torch.sort((~transition).to(torch.int32), stable=True)[1]
            for route, idx in (("cold", order[:n_cold]),
                               ("warm", order[n_cold:])):
                _count(stats, route, idx.shape[0])
                u[idx], y[idx], rho[idx] = solve(
                    route, [a[idx] for a in problem], _take(warm_in, idx))
    u = u.reshape(batch, -1)
    warm_flat = admm.WarmState(x=u, y=y.reshape(batch, -1), rho=rho,
                               minv=states.qp_warm_minv)
    return _finish_grf(states, u, warm_flat, q_lin)


def compute_grf_qp(states, model, params, settings=admm.ADMMSettings()):
    """Single-step balance QP per scenario (A1RobotControl.cpp:377-444),
    solved cold by the dense ADMM (K3 at n = 12)."""
    acc = qp.desired_root_acc(states, params, model.mass)
    bqp = qp.build_balance_qp(acc, states.root_rot_mat_z,
                              states.foot_pos_abs, states.contacts)
    grf_world, _ = qp.solve_balance_qp(bqp, settings)
    grf_body = grf_world @ states.root_rot_mat
    bad = torch.isnan(torch.linalg.norm(grf_body, dim=-1, keepdim=True))
    return states._replace(foot_forces_grf=torch.where(
        bad, states.foot_forces_grf, grf_body))


def _count(stats, route, n=1):
    if stats is not None:
        stats[route] = stats.get(route, 0) + n


class BatchedPre(NamedTuple):
    """What the routes of :func:`compute_grf_mpc_batched` read."""
    states: types.CtrlState      # after terrain adaptation
    lazy: srb.LazyCondensedQP
    warm_in: admm.WarmState      # the carry after flip repair
    transition: torch.Tensor     # (B,) bool: the a-priori cold flags


class BatchedBase(NamedTuple):
    """The base program's result, which the routes after it read."""
    x_sol: torch.Tensor
    warm_out: admm.WarmState
    bad: torch.Tensor            # (B,) bool: the health gate's rejects
    flags: torch.Tensor          # (B,) bool: transition | bad


def grf_batched_parts(settings=admm.ADMMSettings(), use_terrain_adapt=True,
                      warm_settings=WARM_SETTINGS, robust=False,
                      compact_k=128, window_settings=None):
    """:func:`compute_grf_mpc_batched` as ``graphs.Stages`` over
    ``(states, model, params)``, routed by :func:`batched_routing`. Each
    part is fixed-shape: the whole batch, or the ``compact_k`` sub-batch
    gathered on the device.

    - "pre": the lazy condensation and the transition test -> (BatchedPre,
      the (2,) counts (transitions, window flags): the first host read);
    - "warm", "window": a base program on the whole batch -> (BatchedBase,
      the flag count: the second host read);
    - "cold": the whole batch cold a priori (no base program), and after
      each base "<base>.none" (its result), "<base>.compact" (the flagged
      scenarios re-solved cold on the gathered sub-batch, scattered over
      it; not with ``compact_k`` 0) and "<base>.cold" (the whole batch
      cold, the rejected carries neutralized): each -> (the states after
      the GRF solve,).

    With ``robust`` the step is one part, "robust", whose rule names
    that route."""
    cold_branch, warm_branch, window_branch = _grf_branches(
        settings, warm_settings, window_settings)

    def tested(args):
        states, model, params = args[:3]
        states, lazy = _condensed(states, model, params, use_terrain_adapt)
        warm_in, transition, window = _transition_test(states, lazy, params)
        return BatchedPre(states, lazy, warm_in, transition), window

    def pre(args, mids):
        p, window = tested(args)
        return p, torch.stack([p.transition.sum(), window.sum()])

    def finish(p, x_sol, warm_out):
        return (_finish_grf(p.states, x_sol, warm_out, p.lazy.gradient),)

    if robust:
        # uniform robust warm program: the scaled-schedule refinement
        # rebuilds basin-rejected carries per scenario, no cold branch
        robust_settings = warm_settings._replace(
            schulz_l0_refine=(warm_settings.schulz_l0_refine
                              if warm_settings.schulz_l0_refine > 0
                              else 1e-4))
        _, robust_branch, _ = _grf_branches(settings, robust_settings,
                                            window_settings)

        def solve(args, mids):
            p, _ = tested(args)
            x_sol, warm_out, _ = robust_branch(p.lazy, p.warm_in)
            return finish(p, x_sol, warm_out)
        return graphs.Stages({"robust": (solve, ())},
                             lambda run: (("robust",), run("robust")))

    def base(branch):
        def run(args, mids):
            (p, _), = mids
            x_sol, warm_out, bad = branch(p.lazy, p.warm_in)
            flags = p.transition | bad
            return BatchedBase(x_sol, warm_out, bad, flags), flags.sum()
        return run

    def neutralize(p, bad):
        # a health-rejected carry is garbage by construction: its cold
        # re-solve starts from zero primal/dual
        warm = p.warm_in
        z = (bad & ~p.transition)[:, None].to(warm.x.dtype)
        return warm._replace(x=warm.x * (1.0 - z), y=warm.y * (1.0 - z))

    def cold_prior(args, mids):
        (p, _), = mids
        x_sol, warm_out, _ = cold_branch(p.lazy, p.warm_in)
        return finish(p, x_sol, warm_out)

    def none(args, mids):
        (p, _), (b, _) = mids
        return finish(p, b.x_sol, b.warm_out)

    def cold_after(args, mids):
        (p, _), (b, _) = mids
        x_sol, warm_out, _ = cold_branch(p.lazy, neutralize(p, b.bad))
        return finish(p, x_sol, warm_out)

    def compact(args, mids):
        # gather the flagged scenarios into a static-k cold sub-batch and
        # scatter its results over the base ones; a stable descending sort
        # of the 0/1 flags lists flagged indices first, ascending, like
        # jax.lax.top_k; `valid` masks the fill
        (p, _), (b, _) = mids
        k = min(compact_k, p.transition.shape[0])
        warm_fixed = neutralize(p, b.bad)
        idx = torch.sort(b.flags.to(torch.int32), descending=True,
                         stable=True)[1][:k]
        x_c, w_c, _ = cold_branch(_take(p.lazy, idx), _take(warm_fixed, idx))
        valid = b.flags[idx]

        def merge(full, sub):
            v = valid.reshape((k,) + (1,) * (sub.dim() - 1))
            out = full.clone()
            out[idx] = torch.where(v, sub, full[idx])
            return out

        return finish(p, merge(b.x_sol, x_c), admm.WarmState(
            *[merge(a, c) for a, c in zip(b.warm_out, w_c)]))

    parts = {"pre": (pre, ()), "warm": (base(warm_branch), ("pre",)),
             "window": (base(window_branch), ("pre",)),
             "cold": (cold_prior, ("pre",))}
    ends = {"none": none, "cold": cold_after}
    if compact_k > 0:
        ends["compact"] = compact
    for name in ("warm", "window"):
        for end, fn in ends.items():
            parts[f"{name}.{end}"] = (fn, ("pre", name))
    return graphs.Stages(parts, batched_routing(compact_k))


def batched_routing(compact_k):
    """The routing rule of :func:`compute_grf_mpc_batched` over the parts of
    :func:`grf_batched_parts`, which its plain composition and the
    captured batched tick both follow: a rule ``rule(run)`` -> (the
    tick's route, its outputs).

    - no flags: the warm (or, in a post-flip window, the long-window) base
      program, plus the a-posteriori residual health gate;
    - 1..k flags (transitions and health rejects), k ``compact_k``
      clamped to the batch: the base program for all, then the flagged
      scenarios solved cold on the gathered k sub-batch;
    - more flags: the whole batch solved cold (skipping the base program
      when the a-priori transition count alone overflows).

    The rule names one route, ("warm",), ("window",), ("compact",) or
    ("cold",), and reads the device twice at most."""
    def rule(run):
        p, counts = run("pre")
        # device-to-host sync 1 of at most 2 per tick
        n_trans, n_window = counts.tolist()
        k = min(compact_k, p.transition.shape[0])
        if n_trans > k:
            # a-priori overflow (synchronized flips, mode switches) skips
            # the base program entirely
            return ("cold",), run("cold")
        # the post-flip window promotion is batch-level: the window flag
        # comes from gait counters that advance identically across a batch
        base = "window" if n_window > 0 else "warm"
        _, n_flag = run(base)
        n_flag = int(n_flag)                # device-to-host sync 2
        if n_flag > k:
            return ("cold",), run(f"{base}.cold")
        if n_flag > 0:
            return ("compact",), run(f"{base}.compact")
        return (base,), run(f"{base}.none")
    return rule


def compute_grf_mpc_batched(states, model, params,
                            settings=admm.ADMMSettings(),
                            use_terrain_adapt=True,
                            warm_settings=WARM_SETTINGS,
                            robust=False, compact_k=128,
                            window_settings=None, stats=None):
    """Batched MPC GRF solve with batch-level transition routing and
    per-scenario cold-solve compaction (the JAX package's
    ``compute_grf_mpc_batched``): the plain composition of
    :func:`grf_batched_parts`, routed by :func:`batched_routing`.

    The routing decisions are host branches: the tick reads
    (sum(transition), sum(window)) in one device-to-host copy before the
    base program and the flag count in one more after it.

    Args:
      states: batched CtrlState; model, params: shared.
      compact_k: size of the gathered cold sub-batch (clamped to the
        batch); 0 routes every mixed tick whole-batch cold.
      robust: the uniform robust warm program instead: the scaled-schedule
        refinement rebuilds basin-rejected carries per scenario, no cold
        branch.
      stats: optional dict; the route taken ("warm", "window", "compact",
        "cold" or "robust") is counted into it.

    Returns:
      the updated batched CtrlState.
    """
    (route,), (states,) = graphs.compose_stages(
        grf_batched_parts(settings, use_terrain_adapt, warm_settings,
                          robust, compact_k, window_settings),
        states, model, params)
    _count(stats, route)
    return states


def tick_batched_parts(dt, settings=admm.ADMMSettings(),
                       use_terrain_adapt=True, warm_settings=WARM_SETTINGS,
                       robust=False, compact_k=128):
    """:func:`control_step_batched` as ``graphs.Stages`` over ``(states,
    model, params)``: plan -> swing -> :func:`grf_batched_parts` ->
    torques. ``dt`` is a float."""
    return graphs.nest(grf_batched_parts(settings, use_terrain_adapt,
                                         warm_settings, robust, compact_k),
                       _planned(dt), _torques)


def _finish_grf(state, grf_x, warm_out, grad_carry):
    """Shared GRF-solve tail: frame rotation, NaN guard, warm-carry commit."""
    batch = grf_x.shape[0]
    grf_world = grf_x[:, :12].reshape(batch, 4, 3)
    grf_body = grf_world @ state.root_rot_mat       # R^T f per leg
    # NaN guard per leg (A1RobotControl.cpp:558-561)
    bad = torch.isnan(torch.linalg.norm(grf_body, dim=-1, keepdim=True))
    any_bad = bad.any(dim=1)[:, 0]
    grf_body = torch.where(bad, state.foot_forces_grf, grf_body)

    def keep_old(new, old):
        return torch.where(any_bad.reshape((batch,) + (1,) * (new.dim() - 1)),
                           old, new)

    return state._replace(
        foot_forces_grf=grf_body,
        qp_warm_x=keep_old(warm_out.x, state.qp_warm_x),
        qp_warm_y=keep_old(warm_out.y, state.qp_warm_y),
        qp_warm_rho=keep_old(warm_out.rho, state.qp_warm_rho),
        qp_warm_minv=keep_old(warm_out.minv, state.qp_warm_minv),
        # on a bad solve the old carry (and its contact pattern) stays
        qp_warm_contacts=keep_old(state.contacts, state.qp_warm_contacts),
        qp_warm_grad=keep_old(grad_carry, state.qp_warm_grad))


def control_step_batched(states, model, params, dt,
                         settings=admm.ADMMSettings(),
                         use_terrain_adapt=True,
                         warm_settings=WARM_SETTINGS, robust=False,
                         compact_k=128, stats=None):
    """One controller tick for a batch: plan -> swing -> routed MPC GRF
    solve (:func:`compute_grf_mpc_batched`) -> torques, the plain
    composition of :func:`tick_batched_parts`; the route taken is counted
    into ``stats``.

    Pins true-float32 matmuls first (see ``utils/device.py``). ``settings``
    are the cold transition-solve settings: polished ones take the dense
    solve (K3), the others the segmented lazy solve (K1).
    """
    (route,), (states,) = graphs.compose_stages(
        tick_batched_parts(float(dt), settings, use_terrain_adapt,
                           warm_settings, robust, compact_k),
        states, model, params)
    _count(stats, route)
    return states


def control_step(states, model, params, dt, solver_type=MPC,
                 settings=admm.ADMMSettings(), use_terrain_adapt=True,
                 warm_settings=WARM_SETTINGS, receding_horizon=False,
                 warm_mode="auto", horizon=None, stats=None):
    """One full controller tick per scenario: plan -> swing -> GRF solve
    (MPC with per-scenario routing, :func:`compute_grf_mpc`, or the
    balance QP, :func:`compute_grf_qp`) -> torques. Each scenario of the
    batch computes what the JAX package's ``control_step`` computes for
    it alone. A ``horizon`` other than PLAN_HORIZON routes the MPC solve
    to the stagewise solver (:func:`compute_grf_mpc_stagewise`; the state
    must come from ``init_ctrl_state(horizon=...)``)."""
    pin_f32_matmuls()
    states = gait.update_plan(states, params, model)
    states = swing.generate_swing_legs_ctrl(states, params, dt)
    if solver_type == MPC and horizon not in (None, P.PLAN_HORIZON):
        states = compute_grf_mpc_stagewise(
            states, model, params, settings, use_terrain_adapt,
            warm_settings, horizon, warm_mode, stats=stats)
    elif solver_type == MPC:
        states = compute_grf_mpc(states, model, params, settings,
                                 use_terrain_adapt, warm_settings,
                                 receding_horizon, warm_mode, stats=stats)
    elif solver_type == QP:
        states = compute_grf_qp(states, model, params, settings)
    else:
        raise ValueError(f"unknown solver_type {solver_type!r}")
    return torque.compute_joint_torques(states, params)
