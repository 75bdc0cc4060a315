"""The plain reference's side of ``correct``: one control tick, or one
sweep batch, worked out again in float64 from what the run handed the
program, and the gaps between the program's outputs and it.

Everything here runs the frozen plain copy (``reference/go1``), never the
program. A closed-loop tick is followed one step from the program's own
state (its carry before the tick): a float64 rollout of its own would
leave the float32 one within a few hundred ticks, as any two closed loops
do. The reference re-derives every stage of that tick from the carry: the
sensors, the observe + EKF estimate, the plan, the condensed QP, the
routing, the solve, the torques and the plant step.

Routing. A tick's route hangs on thresholds (the gradient drift of the
transition test, the warm solve's residual health gate). Where the
reference's own reading of such a number lies within its margin of the
threshold (``DRIFT_MARGIN``, ``HEALTH_MARGIN``), either side is a sound
route, and the reference works out both.
A scenario's gaps are those of the nearest sound candidate (by its GRF
gap); a candidate that no sound route reaches is never compared.
"""

import contextlib
from typing import NamedTuple

import torch

from reference.go1.config import presets
from reference.go1.ctrl import controller, gait, swing, torque
from reference.go1.envs import rollout, srb_sim
from reference.go1.models import types
from reference.go1.ops import admm
from reference.go1.parallel import sweep

# a threshold reading within this share of its threshold routes either
# way. The drift reads the estimate and the carried gradient, within ~1e-6
# of float64 in float32; the health residual is what 20 iterations leave,
# a difference of near numbers: float32 moved its ratio to the threshold
# by up to 1.8% on the CPU and by 8% on the card (a robot read 0.924 in
# float64, flagged by the program)
DRIFT_MARGIN = 0.05
HEALTH_MARGIN = 0.25
GRAVITY = 9.8


class Gaps(NamedTuple):
    """Per-scenario gaps of one tick, each (B,) float64."""
    est: torch.Tensor     # EKF state (m, m/s, rad): max |program - ref|
    grf: torch.Tensor     # foot forces: max |program - ref| / (m g)
    tau: torch.Tensor     # joint torques: max |program - ref| / (m g 0.1 m)
    plant: torch.Tensor   # next body velocities: max |diff| / (g dt)


def model_params(preset, device):
    """The configuration's robot model and controller parameters: the
    preset's numbers as the configuration states them (float32), held in
    float64."""
    model, params, static = presets.load_preset(preset, torch.float32,
                                                device=device)
    return (_cast(model, torch.float64), _cast(params, torch.float64),
            static)


def _cast(tree, dtype, device=None):
    """``tree`` (nested NamedTuples of tensors) on ``device`` (None: where
    it is) with its floating leaves in ``dtype``."""
    if isinstance(tree, torch.Tensor):
        tree = tree if device is None else tree.to(device)
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        return type(tree)(*[_cast(v, dtype, device) for v in tree])
    return tree


def carry_of(carry, dtype, device):
    """The program's carry as the copy's RolloutCarry (the same fields in
    the same order), floating leaves in ``dtype`` on ``device``."""
    return rollout.RolloutCarry(
        ctrl=types.CtrlState(*_cast(carry.ctrl, dtype, device)),
        sim=srb_sim.SimState(*_cast(carry.sim, dtype, device)),
        stance_forces_z=_cast(carry.stance_forces_z, dtype, device))


def _ratio_margin(value, threshold, margin):
    return torch.abs(value / threshold - 1.0) < margin


def _transition(s, lazy, params):
    """(warm_in, transition, window, transition_marginal): the transition
    test of the copy, and where its only continuous reading (the gradient
    drift) sits within MARGIN of its threshold."""
    warm_in, trans, window = controller._transition_test(s, lazy, params)
    amax = lambda a: torch.amax(torch.abs(a), dim=-1)
    den = torch.maximum(amax(lazy.gradient),
                        0.05 * torch.amax(
                            controller.srb.lazy_hessian_diag(lazy), dim=-1)
                        * 180.0)
    drift = amax(lazy.gradient - s.qp_warm_grad) / (den + 1e-9)
    discrete = (torch.any(s.contacts != s.qp_warm_contacts, dim=-1)
                | (s.mpc_init_counter < controller.WARM_YOUNG_TICKS)
                | controller._post_flip(s, params,
                                        controller.WARM_POSTFLIP_COLD_TICKS)
                | controller._pre_flip(s, params))
    marginal = ~discrete & _ratio_margin(drift, controller.WARM_DRIFT_TOL,
                                         DRIFT_MARGIN)
    return warm_in, trans, window, marginal


def _warm(lazy, warm_in, settings):
    """A warm or window solve: (x, WarmState, bad, bad_marginal)."""
    sol, w = admm.mpc_solve_warm_fused(lazy, warm_in, settings)
    z_scale = torch.clamp(torch.amax(torch.abs(sol.z), dim=-1), min=1.0)
    g_scale = torch.maximum(
        torch.amax(torch.abs(lazy.gradient), dim=-1),
        torch.amax(controller.srb.lazy_hessian_diag(lazy), dim=-1))
    ratio = torch.maximum(
        sol.primal_res / (controller._WARM_HEALTH_PRIM_REL * z_scale),
        sol.dual_res / (controller._WARM_HEALTH_DUAL_REL * g_scale))
    return sol.x, w, ratio > 1.0, _ratio_margin(ratio, 1.0, HEALTH_MARGIN)


def _outcome(carry, s, lazy, x, w, model, params, dt, ground):
    """The rest of the tick after a route's solve: the GRF tail, the
    torques and the plant step. Returns (ctrl, next sim)."""
    st = controller._finish_grf(s, x, w, lazy.gradient)
    st = torque.compute_joint_torques(st, params)
    nxt, _ = rollout._plant(carry, st, model, dt, ground)
    return st, nxt.sim


def _sensed(carry, model, params, dt, estimate):
    ctrl = rollout._sense(carry, model, dt, estimate)
    s = gait.update_plan(ctrl, params, model)
    return ctrl, swing.generate_swing_legs_ctrl(s, params, dt)


class Candidates(NamedTuple):
    """A tick's sound outcomes: the estimate, then per candidate route the
    controller state and the next plant state, and (B, n) which scenario
    may take which."""
    est_x: torch.Tensor
    outcomes: list
    allowed: torch.Tensor


def mpc_tick_batched(carry, model, params, dt, settings, warm_settings,
                     compact_k, use_terrain_adapt, ground=None):
    """``controller.control_step_batched``'s tick after ``rollout._sense``
    (the fleet's routing over the whole batch), with every sound route."""
    ctrl, s = _sensed(carry, model, params, dt, True)
    s, lazy = controller._condensed(s, model, params, use_terrain_adapt)
    warm_in, trans, window, m_t = _transition(s, lazy, params)
    cold, _, _ = controller._grf_branches(settings, warm_settings)
    base_settings = (controller.WINDOW_WARM_SETTINGS if bool(window.any())
                     else warm_settings)
    x_b, w_b, bad, m_b = _warm(lazy, warm_in, base_settings)
    zero = warm_in._replace(x=torch.zeros_like(warm_in.x),
                            y=torch.zeros_like(warm_in.y))
    x_c, w_c, _ = cold(lazy, warm_in)
    x_z, w_z, _ = cold(lazy, zero)
    outs = [_outcome(carry, s, lazy, x, w, model, params, dt, ground)
            for x, w in ((x_b, w_b), (x_c, w_c), (x_z, w_z))]

    k = min(compact_k, trans.shape[0])
    t_yes, t_no = trans | m_t, ~trans | m_t
    b_yes, b_no = bad | m_b, ~bad | m_b
    n_trans_lo, n_trans_hi = int((trans & ~m_t).sum()), int(t_yes.sum())
    flag_yes = t_yes | b_yes
    flag_no = t_no & b_no
    n_flag_lo = int(((trans & ~m_t) | (bad & ~m_b)).sum())
    n_flag_hi = int(flag_yes.sum())
    # the cold re-solve zeroes a carry the health gate rejected (and no
    # transition flagged); the others keep theirs
    zeroed_yes, zeroed_no = b_yes & t_no, b_no | t_yes
    allow_base = torch.zeros_like(trans)
    allow_cold = torch.zeros_like(trans)
    allow_zero = torch.zeros_like(trans)
    if n_trans_hi > k:                       # a-priori whole-batch cold
        allow_cold |= True
    if n_trans_lo <= k:                      # the base program runs
        if n_flag_hi > k:                    # ... then whole-batch cold
            allow_cold |= zeroed_no
            allow_zero |= zeroed_yes
        if n_flag_lo <= k:                   # ... and compacts its flags
            allow_base |= flag_no
            allow_cold |= flag_yes & zeroed_no
            allow_zero |= flag_yes & zeroed_yes
    return Candidates(ctrl.estimator_x, outs,
                      torch.stack([allow_base, allow_cold, allow_zero], -1))


def mpc_tick_one(carry, model, params, dt, settings, warm_settings,
                 use_terrain_adapt, ground=None):
    """``controller.control_step``'s per-scenario MPC tick after
    ``rollout._sense`` (one robot's routing: warm, window, cold, and the
    health re-solve), with every sound route."""
    ctrl, s = _sensed(carry, model, params, dt, True)
    s, lazy = controller._condensed(s, model, params, use_terrain_adapt)
    warm_in, trans, window, m_t = _transition(s, lazy, params)
    cold, _, _ = controller._grf_branches(settings, warm_settings)
    x_w, w_w, bad_w, m_w = _warm(lazy, warm_in, warm_settings)
    x_n, w_n, bad_n, m_n = _warm(lazy, warm_in,
                                 controller.WINDOW_WARM_SETTINGS)
    zero = warm_in._replace(x=torch.zeros_like(warm_in.x),
                            y=torch.zeros_like(warm_in.y))
    x_c, w_c, _ = cold(lazy, warm_in)
    x_z, w_z, _ = cold(lazy, zero)
    outs = [_outcome(carry, s, lazy, x, w, model, params, dt, ground)
            for x, w in ((x_w, w_w), (x_n, w_n), (x_c, w_c), (x_z, w_z))]
    t_yes, t_no = trans | m_t, ~trans | m_t
    bad = torch.where(window, bad_n, bad_w)
    m_b = torch.where(window, m_n, m_w)
    b_yes, b_no = bad | m_b, ~bad | m_b
    allowed = torch.stack([t_no & ~window & b_no, t_no & window & b_no,
                           t_yes, t_no & b_yes], -1)
    return Candidates(ctrl.estimator_x, outs, allowed)


@contextlib.contextmanager
def tf32():
    """The control's precision: float32 products on the tensor cores in
    TF32, the step below the float32 (TF32 off) the configurations state."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def control_tick_batched(carry, preset, dt, settings, warm_settings,
                         compact_k, device):
    """The control of the fleet's tick: the copy's ``rollout_batched``
    tick in float32 with TF32 products, from the program's input carry.
    Returns the copy's next carry."""
    model, params, static = presets.load_preset(preset, torch.float32,
                                                device=device)
    with tf32():
        nxt, _ = rollout.rollout_batched(
            carry_of(carry, torch.float32, device), model, params, 1, dt,
            settings=settings, use_terrain_adapt=static.use_terrain_adapt,
            warm_settings=warm_settings, compact_k=compact_k)
    return nxt


def control_tick_one(carry, preset, dt, path, settings, device):
    """The control of the one-robot tick: the copy's per-scenario
    ``control_step`` in float32 with TF32 products, from the program's
    input carries (commands applied). Returns the copy's next carry."""
    model, params, static = presets.load_preset(preset, torch.float32,
                                                device=device)
    warm = (admm.ADMMSettings(**path["warm"]) if path.get("warm")
            else controller.WARM_SETTINGS)
    with tf32():
        nxt, _ = rollout._run(
            carry_of(carry, torch.float32, device), model, params, 1, dt,
            None, bool(path["estimate"]), None,
            lambda ctrl: controller.control_step(
                ctrl, model, params, float(dt), settings=settings,
                use_terrain_adapt=static.use_terrain_adapt,
                warm_settings=warm, warm_mode=path.get("warm_mode", "auto")))
    return nxt


def _amax_rows(a):
    return torch.amax(torch.abs(a).flatten(1), dim=1)


def tick_gaps(cands, prog_ctrl, prog_sim, mass, dt):
    """Per-scenario Gaps of the program's tick outputs (its controller
    state and next plant state, float64 on the reference's device) against
    the nearest sound candidate. Returns (Gaps, (B,) index of the
    candidate)."""
    weight = mass * GRAVITY
    est = _amax_rows(prog_ctrl.estimator_x - cands.est_x)
    per = []
    for st, sim in cands.outcomes:
        grf = _amax_rows(prog_ctrl.foot_forces_grf - st.foot_forces_grf) \
            / weight
        tau = _amax_rows(prog_ctrl.joint_torques - st.joint_torques) \
            / (0.1 * weight)
        plant = torch.maximum(
            _amax_rows(prog_sim.root_lin_vel - sim.root_lin_vel),
            _amax_rows(prog_sim.root_ang_vel - sim.root_ang_vel)) \
            / (GRAVITY * dt)
        per.append(torch.stack([grf, tau, plant], -1))
    per = torch.stack(per, 1)                          # (B, n, 3)
    inf = torch.tensor(float("inf"), dtype=per.dtype, device=per.device)
    # NaN reads as the largest gap
    per = torch.where(torch.isnan(per), inf, per)
    key = torch.where(cands.allowed, per[..., 0], inf)
    pick = torch.argmin(key, dim=1)
    chosen = per[torch.arange(per.shape[0]), pick]
    none = ~cands.allowed.any(1)
    chosen = torch.where(none[:, None], inf, chosen)
    est = torch.where(torch.isnan(est), inf, est)
    return Gaps(est=est, grf=chosen[:, 0], tau=chosen[:, 1],
                plant=chosen[:, 2]), pick


def sweep_solve(scn, mpc_dt, settings):
    """The sweep's solve of a batch of scenarios in the copy (``main.py
    sweep``'s program: condense, then the dense polished solve): the whole
    horizon's forces (B, 120) and (B,) which solves failed, flagged by
    the solver's residual sentinel (1e6) or not finite."""
    sol = sweep._solve_one(scn, mpc_dt, settings)
    return sol.x, (sol.primal_res >= 1e6) | ~torch.isfinite(sol.x).all(-1)


def scenarios_of(scn, dtype, device):
    """The copy's MpcScenario from the program's (same fields)."""
    return sweep.MpcScenario(*_cast(scn, dtype, device))


def sweep_gaps(prog_x, ref_x, scn):
    """Per-scenario gaps of a sweep solve: the first-step forces, max |diff|
    / (m g), and the whole horizon's, max |diff| / (m g)."""
    weight = scn.mass * GRAVITY
    first = _amax_rows(prog_x[:, :12] - ref_x[:, :12]) / weight
    whole = _amax_rows(prog_x - ref_x) / weight
    nan = lambda a: torch.where(torch.isnan(a), torch.full_like(a, float(
        "inf")), a)
    return nan(first), nan(whole)
