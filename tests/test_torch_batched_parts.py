"""PyTorch port, the batched tick in parts: ``controller.grf_batched_parts``
under ``controller.batched_routing``, nested into
``rollout.tick_batched_parts``, which ``rollout_batched`` captures on
the card.

On each kind of tick (unmixed, a mixed tick under ``compact_k``, an
a-priori overflow, a post-base overflow, a window tick) the parts, and
the eager tick that ``rollout_batched`` runs off the card, follow
the routing as it was written inline before the split (kept here as
``_batched_reference``), bit for bit in float64: the same parts run in
the same order, the same route is counted, and the GRF solve, the whole
tick's carry and its record come out equal. ``test_torch_controller.py``
holds each route against the JAX package.
"""

import pytest
import torch

from go1_qp_mpc_controller_torch.ctrl import controller as t_ctrl
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.utils import graphs

F64 = torch.float64
DT = 0.002
BATCH, K = 5, 2                 # a batch of compact_k + 3
COLD = t_admm.ADMMSettings(seg_iters=30, segments=2, first_seg_iters=20,
                           polish=False, schulz_l0=1e-6,
                           schulz_l0_first=1e-3, schulz_l0_refine=1e-4,
                           schulz_hi_tail=1)


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batched_reference(states, model, params, settings, compact_k):
    """``compute_grf_mpc_batched`` as it was before the split into parts,
    its routing inline: (states, the keys of the parts it stands for)."""
    states, lazy = t_ctrl._condensed(states, model, params, True)
    warm_in, transition, window = t_ctrl._transition_test(states, lazy,
                                                          params)
    cold_branch, warm_branch, window_branch = t_ctrl._grf_branches(
        settings, t_ctrl.WARM_SETTINGS)
    k = min(compact_k, transition.shape[0])

    def neutralize(warm, bad):
        z = (bad & ~transition)[:, None].to(warm.x.dtype)
        return warm._replace(x=warm.x * (1.0 - z), y=warm.y * (1.0 - z))

    def finish(x_sol, warm_out):
        return t_ctrl._finish_grf(states, x_sol, warm_out, lazy.gradient)

    n_trans, n_window = torch.stack([transition.sum(),
                                     window.sum()]).tolist()
    if n_trans > k:
        x_sol, warm_out, _ = cold_branch(lazy, warm_in)
        return finish(x_sol, warm_out), ["pre", "cold"]
    name = "window" if n_window > 0 else "warm"
    base = window_branch if n_window > 0 else warm_branch
    x_sol, warm_out, bad = base(lazy, warm_in)
    flags = transition | bad
    n_flag = int(flags.sum())
    if n_flag > k:
        x_sol, warm_out, _ = cold_branch(lazy, neutralize(warm_in, bad))
        return finish(x_sol, warm_out), ["pre", name, f"{name}.cold"]
    if n_flag == 0:
        return finish(x_sol, warm_out), ["pre", name, f"{name}.none"]
    warm_fixed = neutralize(warm_in, bad)
    idx = torch.sort(flags.to(torch.int32), descending=True,
                     stable=True)[1][:k]
    x_c, w_c, _ = cold_branch(t_ctrl._take(lazy, idx),
                              t_ctrl._take(warm_fixed, idx))
    valid = flags[idx]

    def merge(full, sub):
        v = valid.reshape((k,) + (1,) * (sub.dim() - 1))
        out = full.clone()
        out[idx] = torch.where(v, sub, full[idx])
        return out

    x_sol = merge(x_sol, x_c)
    warm_out = t_admm.WarmState(*[merge(a, b)
                                  for a, b in zip(warm_out, w_c)])
    return finish(x_sol, warm_out), ["pre", name, f"{name}.compact"]


def _planned(carry, model, params):
    """The tick up to the GRF solve, written out: sensors, plan, swing."""
    states = t_rollout._sense(carry, model, DT, True)
    t_ctrl.pin_f32_matmuls()
    states = t_ctrl.gait.update_plan(states, params, model)
    return t_ctrl.swing.generate_swing_legs_ctrl(states, params, DT)


def _bits(got, want):
    g, w = graphs.flatten(got)[0], graphs.flatten(want)[0]
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert torch.equal(a, b), i


@pytest.fixture(scope="module")
def trot_carries(one_thread):
    """A float64 trot of BATCH robots from a perturbed start: the carries
    before its first steady warm tick after the young ticks and before its
    first post-flip window tick."""
    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    c = t_rollout.init_carry(model, params, BATCH, dtype=F64, device="cpu")
    dz = 0.005 * torch.randn((BATCH, 1), dtype=F64,
                             generator=torch.Generator().manual_seed(0))
    c = c._replace(
        sim=c.sim._replace(root_pos=c.sim.root_pos
                           + torch.nn.functional.pad(dz, (2, 0))),
        ctrl=c.ctrl._replace(
            movement_mode=torch.ones_like(c.ctrl.movement_mode),
            root_lin_vel_d=torch.tensor([[0.25, 0.0, 0.0]],
                                        dtype=F64).expand(BATCH, 3).clone()))
    kept = {}
    for _ in range(80):
        stats = {}
        nxt, _ = t_rollout.rollout_batched(c, model, params, 1, DT,
                                           settings=COLD, compact_k=K,
                                           stats=stats)
        (route,) = stats
        if route in ("warm", "window") and route not in kept:
            kept[route] = c
        if len(kept) == 2:
            break
        c = nxt
    assert set(kept) == {"warm", "window"}, kept
    return model, params, kept


def _edit(carry, case):
    """The case's tick from a steady warm carry: carried contact patterns
    flipped (transitions) or carried inverses negated (health rejects)."""
    ctrl = carry.ctrl
    if case == "compact":               # one transition
        qc = ctrl.qp_warm_contacts.clone()
        qc[1] = ~qc[1]
        ctrl = ctrl._replace(qp_warm_contacts=qc)
    elif case == "prior_overflow":      # K + 1 transitions
        qc = ctrl.qp_warm_contacts.clone()
        qc[:K + 1] = ~qc[:K + 1]
        ctrl = ctrl._replace(qp_warm_contacts=qc)
    elif case == "post_base_overflow":  # K + 1 health rejects
        minv = ctrl.qp_warm_minv.clone()
        minv[1:K + 2] = -minv[1:K + 2]
        ctrl = ctrl._replace(qp_warm_minv=minv)
    return carry._replace(ctrl=ctrl)


@pytest.mark.parametrize("case, route, keys", [
    ("unmixed", "warm", ["pre", "warm", "warm.none"]),
    ("compact", "compact", ["pre", "warm", "warm.compact"]),
    ("prior_overflow", "cold", ["pre", "cold"]),
    ("post_base_overflow", "cold", ["pre", "warm", "warm.cold"]),
    ("window", "window", ["pre", "window", "window.none"])])
def test_batched_parts_follow_the_eager_routing_bits(trot_carries, case,
                                                     route, keys):
    """The GRF solve's parts run the parts and count the route that the
    inline routing stands for, and give its bits; so do
    ``compute_grf_mpc_batched``, and the whole tick in parts
    (``rollout.tick_batched_parts``, which the card captures) and eager
    (``rollout_batched`` on the CPU) against the tick written out around
    the inline routing."""
    model, params, kept = trot_carries
    carry = _edit(kept["window" if case == "window" else "warm"], case)
    states = _planned(carry, model, params)
    ref, ref_keys = _batched_reference(states, model, params, COLD, K)
    assert ref_keys == keys

    grf = t_ctrl.grf_batched_parts(COLD, compact_k=K)
    ran, outs = [], {}

    def run(key):
        ran.append(key)
        fn, reads = grf.parts[key]
        outs[key] = fn((states, model, params),
                       tuple(outs[r] for r in reads))
        return outs[key]

    split_routes, (split,) = grf.rule(run)
    assert (split_routes, ran) == ((route,), keys)
    _bits(split, ref)
    stats = {}
    _bits(t_ctrl.compute_grf_mpc_batched(states, model, params, COLD,
                                         compact_k=K, stats=stats), ref)
    assert stats == {route: 1}

    want, want_rec = t_rollout._plant(
        carry, t_ctrl.torque.compute_joint_torques(ref, params), model, DT,
        None)
    tick_routes, (got, got_rec) = graphs.compose_stages(
        t_rollout.tick_batched_parts(DT, COLD, compact_k=K), carry, model,
        params)
    assert tick_routes == (route,)
    _bits(got, want)
    _bits(got_rec, want_rec)
    stats = {}
    got, got_rec = t_rollout.rollout_batched(
        carry, model, params, 1, DT, settings=COLD, compact_k=K, stats=stats)
    assert stats == {route: 1}
    _bits(got, want)
    _bits(got_rec, type(want_rec)(*[leaf[None] for leaf in want_rec]))
