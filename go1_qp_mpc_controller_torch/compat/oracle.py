"""Float64 NumPy oracle: reference-semantics condensation + exact QP solve.

The reference anchors numerics on OSQP solving the condensed MPC QP
(src/a1_cpp/src/test/test_mpc.cpp:125-159). OSQP cannot be installed in this
environment, so parity is established against this oracle instead: an
independent float64 NumPy implementation of the same condensation
(ConvexMpc.cpp:110-245) plus an ADMM solver with OSQP's exact iteration
(scaled splitting, over-relaxation, equality-rho boost) run to tight
residuals and finished with an active-set polish step (OSQP's "polish")
solving the reduced KKT system to machine precision. A KKT-residual check
certifies optimality, so the oracle solution equals what a converged OSQP
run returns for the same QP up to solver tolerance.

Pure NumPy: the port's own copy of the JAX package's
``compat/oracle.py``, so that the port depends on nothing of that
package. It is the trusted side of every parity test.
"""

from dataclasses import dataclass

import numpy as np

H = 10
NX = 13
NU = 12
NC = 20 * H
NV = 12 * H
MU = 0.3


# --------------------------- condensation ---------------------------------

def rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def skew(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def calculate_A_c(root_euler):
    a = np.zeros((NX, NX))
    a[0:3, 6:9] = rot_z(root_euler[2]).T
    a[3:6, 9:12] = np.eye(3)
    a[11, 12] = 1.0
    return a


def calculate_B_c(mass, trunk_inertia, root_rot_mat, foot_pos_legs):
    """foot_pos_legs: (4, 3) leg-major."""
    i_world = root_rot_mat @ trunk_inertia @ root_rot_mat.T
    i_world_inv = np.linalg.inv(i_world)
    b = np.zeros((NX, NU))
    for i in range(4):
        b[6:9, 3 * i:3 * i + 3] = i_world_inv @ skew(foot_pos_legs[i])
        b[9:12, 3 * i:3 * i + 3] = np.eye(3) / mass
    return b


def discretize(a_c, b_c, dt):
    return np.eye(NX) + a_c * dt, b_c * dt


def constraint_matrix(mu=MU):
    c = np.zeros((NC, NV))
    for k in range(4 * H):
        r0, c0 = 5 * k, 3 * k
        c[r0, c0] = 1.0
        c[r0, c0 + 2] = mu
        c[r0 + 1, c0] = 1.0
        c[r0 + 1, c0 + 2] = -mu
        c[r0 + 2, c0 + 1] = 1.0
        c[r0 + 2, c0 + 2] = mu
        c[r0 + 3, c0 + 1] = 1.0
        c[r0 + 3, c0 + 2] = -mu
        c[r0 + 4, c0 + 2] = 1.0
    return c


@dataclass
class OracleQP:
    hessian: np.ndarray
    gradient: np.ndarray
    C: np.ndarray
    lb: np.ndarray
    ub: np.ndarray


def condense(a_d, b_d_list, x0, x_ref_flat, q_weights, r_weights, contacts,
             fz_min=0.0, fz_max=180.0):
    """ConvexMpc::calculate_qp_mats (ConvexMpc.cpp:158-245) in NumPy."""
    a_qp = np.zeros((H * NX, NX))
    b_qp = np.zeros((H * NX, H * NU))
    for i in range(H):
        if i == 0:
            a_qp[0:NX, :] = a_d
        else:
            a_qp[NX * i:NX * (i + 1), :] = (
                a_qp[NX * (i - 1):NX * i, :] @ a_d)
        for j in range(i + 1):
            if i == j:
                blk = b_d_list[j]
            else:
                blk = a_qp[NX * (i - j - 1):NX * (i - j), :] @ b_d_list[j]
            b_qp[NX * i:NX * (i + 1), NU * j:NU * (j + 1)] = blk
    qw = np.tile(2.0 * q_weights, H)
    rw = np.tile(2.0 * r_weights, H)
    hessian = b_qp.T @ (qw[:, None] * b_qp) + np.diag(rw)
    resid = a_qp @ x0 - x_ref_flat
    gradient = b_qp.T @ (qw * resid)
    inf = np.inf
    lb1 = np.concatenate(
        [[0.0, -inf, 0.0, -inf, fz_min * c] for c in contacts])
    ub1 = np.concatenate(
        [[inf, 0.0, inf, 0.0, fz_max * c] for c in contacts])
    return OracleQP(hessian=hessian, gradient=gradient, C=constraint_matrix(),
                    lb=np.tile(lb1, H), ub=np.tile(ub1, H))


# --------------------------- exact QP solver ------------------------------

def solve_qp(qp, max_iter=20000, rho=0.1, sigma=1e-6, alpha=1.6,
             eps=1e-10, polish=True):
    """OSQP-iteration ADMM (cost scaling + adaptive rho) to tight tolerance,
    plus active-set polish.

    Returns (x, y, info) with info containing residuals; raises if the KKT
    conditions are not met to 1e-8 — the oracle must be trustworthy.
    """
    p_u, q_u, c = qp.hessian, qp.gradient, qp.C
    lb, ub = qp.lb, qp.ub
    n, m = p_u.shape[0], c.shape[0]
    cost = 1.0 / max(np.abs(p_u).max(), 1e-12)   # cost scaling, |P| -> 1
    p, q = cost * p_u, cost * q_u
    eq = np.isclose(lb, ub)

    x = np.zeros(n)
    z = np.zeros(m)
    y = np.zeros(m)
    it = 0
    while it < max_iter:
        rho_vec = np.where(eq, rho * 1e3, rho)
        kkt = p + sigma * np.eye(n) + c.T @ (rho_vec[:, None] * c)
        kkt_cho = np.linalg.cholesky(kkt)
        for _ in range(50):
            rhs = sigma * x - q + c.T @ (rho_vec * z - y)
            w = np.linalg.solve(kkt_cho, rhs)
            x_t = np.linalg.solve(kkt_cho.T, w)
            z_t = c @ x_t
            x_new = alpha * x_t + (1 - alpha) * x
            z_mid = alpha * z_t + (1 - alpha) * z
            z_new = np.clip(z_mid + y / rho_vec, lb, ub)
            y = y + rho_vec * (z_mid - z_new)
            x, z = x_new, z_new
            it += 1
        cx = c @ x
        prim = np.max(np.abs(cx - z))
        dual = np.max(np.abs(p @ x + q + c.T @ y))
        if prim < eps and dual < eps * cost:
            break
        # adaptive rho on relative residuals
        prim_rel = prim / max(np.abs(cx).max(), np.abs(z).max(), 1e-15)
        dual_rel = dual / max(np.abs(p @ x).max(), np.abs(q).max(),
                              np.abs(c.T @ y).max(), 1e-15)
        rho = float(np.clip(rho * np.sqrt(prim_rel / max(dual_rel, 1e-15)),
                            1e-6, 1e6))
    y = y / cost
    p, q = p_u, q_u

    if polish:
        xp, yp = _polish(p, q, c, lb, ub, z, y)
        if xp is not None:
            x, y = xp, yp
            z = np.clip(c @ x, lb, ub)

    prim = np.max(np.abs(c @ x - z))
    dual = np.max(np.abs(p @ x + q + c.T @ y))
    comp = _complementarity(c @ x, y, lb, ub)
    info = {"primal_res": prim, "dual_res": dual, "comp": comp}
    if prim > 1e-8 or dual > 1e-8:
        raise RuntimeError(f"oracle QP failed to converge: {info}")
    return x, y, info


def _polish(p, q, c, lb, ub, z, y, tol=1e-7):
    """OSQP-style polish: solve the KKT system on the detected active set."""
    low = (np.abs(z - lb) < tol) & (y < tol) & np.isfinite(lb)
    upp = (np.abs(z - ub) < tol) & (y > -tol) & np.isfinite(ub)
    act = low | upp
    bvals = np.where(low & ~upp, lb, ub)
    a_act = c[act]
    n = p.shape[0]
    k = a_act.shape[0]
    kkt = np.zeros((n + k, n + k))
    kkt[:n, :n] = p
    kkt[:n, n:] = a_act.T
    kkt[n:, :n] = a_act
    rhs = np.concatenate([-q, bvals[act]])
    try:
        sol, *_ = np.linalg.lstsq(kkt, rhs, rcond=None)
    except np.linalg.LinAlgError:
        return None, None
    x = sol[:n]
    nu = sol[n:]
    y_new = np.zeros_like(y)
    y_new[act] = nu
    # verify feasibility + sign conditions; otherwise reject polish
    cx = c @ x
    if np.any(cx < lb - 1e-7) or np.any(cx > ub + 1e-7):
        return None, None
    if np.max(np.abs(p @ x + q + c.T @ y_new)) > 1e-7:
        return None, None
    return x, y_new


def _complementarity(cx, y, lb, ub):
    gap_l = np.where(y < 0, np.abs(cx - lb), 0.0)
    gap_u = np.where(y > 0, np.abs(cx - ub), 0.0)
    gap = np.where(np.isfinite(gap_l), gap_l, 0) + np.where(
        np.isfinite(gap_u), gap_u, 0)
    return np.max(np.abs(y) * gap)


def averaged_euler(root_euler, root_ang_vel_d, dt):
    """Horizon-mean euler linearization point (test/test_mpc.cpp:93-101)."""
    return (2.0 * np.asarray(root_euler)
            + np.asarray(root_ang_vel_d) * dt * H) / (H + 1.0)


def receding_b_d_list(mass, trunk_inertia, root_rot_mat, foot_pos, vel_d,
                      dt):
    """Per-step B_d with receding foot positions, as the reference loop
    writes it (test/test_mpc.cpp:105-122): B_c is computed from the current
    positions, THEN the positions recede by v_d * dt — so step i uses
    foot_pos - i * v_d * dt."""
    b_d_list = []
    fp = np.asarray(foot_pos, np.float64).copy()
    for _ in range(H):
        b_c = calculate_B_c(mass, trunk_inertia, root_rot_mat, fp)
        b_d_list.append(b_c * dt)
        fp = fp - np.asarray(vel_d)[None, :] * dt
    return np.stack(b_d_list)


# --------------------------- fixture --------------------------------------

def test_mpc_fixture():
    """The test_mpc.cpp scenario (test/test_mpc.cpp:14-126) as plain data.

    Diagonal-stance Go1 at z=0.15 with the averaged-euler A_c and receding
    foot positions. Returns a dict of float64 arrays.
    """
    mass = 15.0
    inertia = np.diag([0.0158533, 0.0377999, 0.0456542])
    root_euler = np.zeros(3)
    rot = np.eye(3)
    root_pos = np.array([0.0, 0.0, 0.15])
    foot_pos = np.array([[0.17, 0.15, -0.35],
                         [0.17, -0.15, -0.35],
                         [-0.17, 0.15, -0.35],
                         [-0.17, -0.15, -0.35]])
    contacts = np.array([1.0, 0.0, 1.0, 0.0])
    dt = 0.0025
    q_weights = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 50.0,
                          0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    r_weights = np.full(12, 1e-6)
    x0 = np.concatenate([root_euler, root_pos, np.zeros(3), np.zeros(3),
                         [-9.8]])
    # zero desired velocity -> reference trajectory holds position
    # (test_mpc.cpp:75-91; note its z-row uses the y desired velocity, which
    # is 0 here, so the quirk is value-neutral).
    x_ref = np.tile(
        np.concatenate([np.zeros(2), [0.0], root_pos, np.zeros(6), [-9.8]]),
        H)
    a_c = calculate_A_c(root_euler)  # avg euler == euler here (zero rates)
    b_d_list = []
    fp = foot_pos.copy()
    for _ in range(H):
        b_c = calculate_B_c(mass, inertia, rot, fp)
        _, b_d = discretize(a_c, b_c, dt)
        b_d_list.append(b_d)
    a_d, _ = discretize(a_c, np.zeros((NX, NU)), dt)
    return {
        "mass": mass, "inertia": inertia, "root_euler": root_euler,
        "rot": rot, "root_pos": root_pos, "foot_pos": foot_pos,
        "contacts": contacts, "dt": dt, "q_weights": q_weights,
        "r_weights": r_weights, "x0": x0, "x_ref": x_ref,
        "a_d": a_d, "b_d_list": np.stack(b_d_list),
    }


def solve_test_mpc_fixture():
    """Condense + exactly solve the fixture; returns (grf (4,3), x, qp)."""
    f = test_mpc_fixture()
    qp = condense(f["a_d"], f["b_d_list"], f["x0"], f["x_ref"],
                  f["q_weights"], f["r_weights"], f["contacts"])
    x, y, info = solve_qp(qp)
    grf = x[:12].reshape(4, 3)
    return grf, x, qp, info
