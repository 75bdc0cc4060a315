"""Scenario sweeps: batches of randomized condensed-MPC solves, on one
card or over a (data, mpc) device mesh.

Port of the JAX package's ``parallel/sweep.py`` (its configs[2] batch of
4096 scenarios and configs[4] sweep of 100k+ in chunks). On one card the
whole batch is one program; over a mesh (``parallel/mesh.py``) each rank
solves its block of the data axis, along the ``mpc`` axis the
Hessian / gradient contraction over the horizon-state rows is split and
combined with an ``all_reduce`` (the intra-solve block reduction), and
the summary statistics reduce over ``data``.

Two solve routes at mpc = 1, chosen by the settings as the JAX
``_solve_one`` does: one segment without polish or float64 refinement
takes the fused cold solve on the lazy factors (``admm.mpc_solve_cold``:
kernels K1 and K6); any other settings the dense solve
(``admm.mpc_solve``: K3 and K6), which an mpc axis > 1 always takes.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from go1_qp_mpc_controller_torch.config import params as CP
from go1_qp_mpc_controller_torch.models import srb
from go1_qp_mpc_controller_torch.ops import admm
from go1_qp_mpc_controller_torch.parallel import mesh as mesh_lib
from go1_qp_mpc_controller_torch.parallel.mesh import DATA_AXIS, MPC_AXIS
from go1_qp_mpc_controller_torch.utils.device import (pin_f32_matmuls,
                                                      resolve_device)


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


def take(scn, rows):
    """The scenarios ``rows`` (an index or slice) of ``scn``."""
    return type(scn)(*[a[rows] for a in scn])


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
    """Condense and solve the batch (the JAX ``_solve_one`` on one device):
    the fused cold program (K1, K6) for one segment without polish or
    float64 refinement, else the dense solve (K3, K6), which honours
    them. Returns the ADMMSolution."""
    a_d, b_d = discretize(scn, mpc_dt)
    if (settings.segments == 1 and not settings.polish
            and not settings.refine_f64):
        lazy = srb.condense_nilpotent_lazy(a_d, b_d, scn.x0, scn.x_ref,
                                           scn.q_weights, scn.r_weights,
                                           scn.contacts)
        sol, _ = admm.mpc_solve_cold(lazy, settings, mu=scn.mu,
                                     contacts=scn.contacts,
                                     foot_pos=scn.foot_pos)
        return sol
    qp = srb.condense_nilpotent_const(a_d, b_d, scn.x0, scn.x_ref,
                                      scn.q_weights, scn.r_weights,
                                      scn.contacts)
    return admm.mpc_solve(qp, settings, mu=scn.mu)


def _condense_mpc_partial(a_d, b_d_list, scn, k, n):
    """Member ``k`` of ``n``'s part of the condensation with the (130,)
    state-row contraction split over the mpc axis: its slice of horizon
    steps' rows of B_qp, built from block(i, j) = A^(i-j) B_j (1/n of the
    block assembly and of the contraction), and its partial B'QB and
    B'Q(A x0 - xref) (the JAX ``_condense_mpc_sharded`` before its psum).

    Args:
      a_d: (B, 13, 13); b_d_list: (B, H, 13, 12) per-step B; scn: the
        MpcScenario batch; k, n: the member index and count (n divides H).

    Returns:
      (hessian part (B, 120, 120), gradient part (B, 120)).
    """
    h, nx, nu = CP.PLAN_HORIZON, CP.MPC_STATE_DIM, CP.NUM_DOF
    if h % n:
        raise ValueError(f"the horizon {h} does not split over mpc={n}")
    batch, s = a_d.shape[0], h // n
    a_pows = [torch.eye(nx, dtype=a_d.dtype, device=a_d.device).expand(
        batch, nx, nx)]
    for _ in range(h):
        a_pows.append(a_pows[-1] @ a_d)
    a_pows = torch.stack(a_pows, 1)                     # (B, H+1): A^p
    start = k * s
    i_loc = torch.arange(start, start + s, device=a_d.device)
    d = i_loc[:, None] - torch.arange(h, device=a_d.device)[None, :]
    valid = (d >= 0).to(a_d.dtype)                      # (s, H)
    ap = a_pows[:, d.clamp(0, h - 1)]                   # (B, s, H, nx, nx)
    blocks = (torch.einsum('bsjxy,bjyu->bsjxu', ap, b_d_list)
              * valid[:, :, None, None])
    b_flat = blocks.transpose(2, 3).reshape(batch, s * nx, h * nu)
    qw_rows = torch.tile(2.0 * scn.q_weights, (1, s))  # (B, s nx)
    bq = b_flat * qw_rows[..., None]
    hess_part = b_flat.transpose(1, 2) @ bq
    resid = ((a_pows[:, i_loc + 1] @ scn.x0[:, None, :, None])[..., 0]
             - scn.x_ref[:, start:start + s]).reshape(batch, s * nx, 1)
    return hess_part, (bq.transpose(1, 2) @ resid)[..., 0]


def _mpc_qp(hess_qq, gradient, scn):
    """The CondensedQP from the summed contraction B'QB: adds the 2R
    diagonal and the friction-pyramid bounds."""
    hessian = hess_qq + torch.diag_embed(
        torch.tile(2.0 * scn.r_weights, (1, CP.PLAN_HORIZON)))
    lb, ub = srb._pyramid_bounds(scn.contacts, CP.MPC_FZ_MIN, CP.MPC_FZ_MAX,
                                 hess_qq.dtype)
    return srb.CondensedQP(hessian=hessian, gradient=gradient, lb=lb, ub=ub)


def _condense_mpc_sharded(a_d, b_d_list, scn, mesh):
    """The condensation split over the mesh's mpc axis: this rank's
    :func:`_condense_mpc_partial`, summed over the axis by one
    ``all_reduce`` each for the Hessian and the gradient."""
    hess, grad = _condense_mpc_partial(a_d, b_d_list, scn,
                                       mesh.index(MPC_AXIS),
                                       mesh.shape[MPC_AXIS])
    group = mesh.group(MPC_AXIS)
    dist.all_reduce(hess, group=group)
    dist.all_reduce(grad, group=group)
    return _mpc_qp(hess, grad, scn)


def _solve_mesh_block(scn, mpc_dt, settings, mesh):
    """Solve this rank's data block: both one-card routes at mpc = 1, the
    dense solve on the mpc-sharded condensation above it."""
    if mesh.shape[MPC_AXIS] == 1:
        return _solve_one(scn, mpc_dt, settings)
    a_d, b_d = discretize(scn, mpc_dt)
    b_d_list = b_d[:, None].expand(-1, CP.PLAN_HORIZON, -1, -1)
    qp = _condense_mpc_sharded(a_d, b_d_list, scn, mesh)
    return admm.mpc_solve(qp, settings, mu=scn.mu)


def make_sweep_fn(device, mpc_dt, settings=admm.ADMMSettings()):
    """The sweep program: a function MpcScenario (a batch on the device)
    -> SweepResult, whose ``stats`` hold ``num_solves`` (a float) and the
    batch's ``max_primal_res`` and ``max_dual_res`` (0-dim tensors:
    reading them waits for the card).

    ``device`` is a device (None: the CUDA card), or a
    :class:`parallel.mesh.Mesh`: then every rank passes the whole batch,
    which must divide the data axis; each solves its block and returns the
    whole batch's results (gathered over ``data``), with ``num_solves``
    summed and the residual maxima taken over ``data`` (one
    ``all_reduce``).
    """
    if isinstance(device, mesh_lib.Mesh):
        return _make_mesh_sweep_fn(device, mpc_dt, settings)
    device = resolve_device(device)

    def fn(scn):
        if scn.x0.device != device:
            raise ValueError(f"the scenarios live on {scn.x0.device}, the "
                             f"sweep runs on {device}")
        pin_f32_matmuls()
        sol = _solve_one(scn, mpc_dt, settings)
        return _result(sol.x, sol.primal_res, sol.dual_res,
                       float(scn.x0.shape[0]), sol.primal_res.max(),
                       sol.dual_res.max())

    return fn


def _result(x, primal_res, dual_res, num_solves, max_primal, max_dual):
    return SweepResult(
        grf=x[:, :12].reshape(-1, 4, 3), forces_all=x,
        primal_res=primal_res, dual_res=dual_res,
        stats={"num_solves": num_solves, "max_primal_res": max_primal,
               "max_dual_res": max_dual})


def _make_mesh_sweep_fn(mesh, mpc_dt, settings):
    """:func:`make_sweep_fn` over a mesh (the JAX ``make_sweep_fn``)."""
    def fn(scn):
        if scn.x0.device != mesh.device:
            raise ValueError(f"the scenarios live on {scn.x0.device}, this "
                             f"rank runs on {mesh.device}")
        pin_f32_matmuls()
        local = mesh_lib.scenario_sharding(mesh, scn)
        sol = _solve_mesh_block(local, mpc_dt, settings, mesh)
        # the residual maxima in one all_reduce; the sum of the solves over
        # the data axis is its size times the (equal) local batch, known
        # without a collective or a wait for the card
        worst = torch.stack([sol.primal_res.max(), sol.dual_res.max()])
        dist.all_reduce(worst, op=dist.ReduceOp.MAX,
                        group=mesh.group(DATA_AXIS))
        num = float(local.x0.shape[0] * mesh.shape[DATA_AXIS])
        return _result(*mesh_lib.replicated(
            mesh, (sol.x, sol.primal_res, sol.dual_res)), num, *worst)

    return fn


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


def run_chunked(fn, scenarios, chunk_size):
    """Run a sweep function over a large scenario set in chunks of
    ``chunk_size`` (configs[4]-scale sweeps on one card: the per-chunk QPs
    are ~60 KB a scenario).

    Args:
      fn: the sweep function (:func:`make_sweep_fn`).
      scenarios: MpcScenario with (N, ...) leaves, N % chunk_size == 0.

    Returns:
      SweepResult with (N, ...) leaves; stats aggregated over the chunks
      as floats (one wait for the card, at the end).
    """
    n = scenarios.x0.shape[0]
    if n % chunk_size:
        raise ValueError(f"{n} scenarios do not split into chunks of "
                         f"{chunk_size}")
    outs = [fn(take(scenarios, slice(i, i + chunk_size)))
            for i in range(0, n, chunk_size)]
    cat = lambda name: torch.cat([getattr(o, name) for o in outs])
    worst = lambda key: float(torch.stack([o.stats[key] for o in outs]).max())
    return SweepResult(
        grf=cat("grf"), forces_all=cat("forces_all"),
        primal_res=cat("primal_res"), dual_res=cat("dual_res"),
        stats={"num_solves": sum(o.stats["num_solves"] for o in outs),
               "max_primal_res": worst("max_primal_res"),
               "max_dual_res": worst("max_dual_res")})
