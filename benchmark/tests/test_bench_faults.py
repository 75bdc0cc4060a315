"""``correct`` comes out false when the timed path is broken underneath:
the run is driven on the CPU (the look for a card skipped) with one fault
planted in the program, for each fault the cell can have. The cells run on
one card, so none has an exchange between cards to leave out."""

import json

import pytest
import torch

from conftest import make_tiny_root, run_cell


def _unchanged_plant(monkeypatch):
    """A step that returns its state unchanged: the plant step."""
    from go1_qp_mpc_controller_torch.envs import srb_sim
    real = srb_sim.step

    def step(sim, *a, **k):
        _, forces = real(sim, *a, **k)
        return sim, forces
    monkeypatch.setattr(srb_sim, "step", step)


def _altered_torque(monkeypatch):
    """An answer altered where it is produced: one robot's torques."""
    from go1_qp_mpc_controller_torch.ctrl import torque
    real = torque.compute_joint_torques

    def fn(state, params):
        out = real(state, params)
        tau = out.joint_torques.clone()
        tau[0, 2] += 0.5
        return out._replace(joint_torques=tau)
    monkeypatch.setattr(torque, "compute_joint_torques", fn)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: the GRF
    solve's tail, which every route's part ends in (the card's captured
    parts and the CPU's plain composition alike), keeps the first half's
    forces and gives the second half their mean."""
    from go1_qp_mpc_controller_torch.ctrl import controller
    real = controller._finish_grf

    def fn(state, *a, **k):
        out = real(state, *a, **k)
        f = out.foot_forces_grf.clone()
        half = f.shape[0] // 2
        f[half:] = f[:half].mean(0)
        return out._replace(foot_forces_grf=f)
    monkeypatch.setattr(controller, "_finish_grf", fn)


def _altered_solve(monkeypatch):
    """An answer altered where it is produced: the solve's first-step
    normal force on the first leg, 2% of the weight higher in every
    scenario."""
    from go1_qp_mpc_controller_torch.parallel import sweep
    real = sweep._solve_one

    def fn(scn, mpc_dt, settings):
        sol = real(scn, mpc_dt, settings)
        x = sol.x.clone()
        x[:, 2] += 0.02 * 9.8 * scn.mass
        return sol._replace(x=x)
    monkeypatch.setattr(sweep, "_solve_one", fn)


def _one_scenario_altered(monkeypatch):
    """An answer altered where it is produced, in one scenario only and
    unflagged: its first-step normal force on the first leg, one weight
    higher."""
    from go1_qp_mpc_controller_torch.parallel import sweep
    real = sweep._solve_one

    def fn(scn, mpc_dt, settings):
        sol = real(scn, mpc_dt, settings)
        x = sol.x.clone()
        x[0, 2] += 9.8 * scn.mass[0]
        return sol._replace(x=x)
    monkeypatch.setattr(sweep, "_solve_one", fn)


def _window_route_altered(monkeypatch):
    """An answer altered where one route produces it: the window route's
    solve, its first-step normal force on the first leg 5 N higher; the
    warm, cold and health routes are left sound."""
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.ops import admm
    real = admm.mpc_solve_warm_fused

    def fn(lazy, warm, settings, *a, **k):
        sol, w = real(lazy, warm, settings, *a, **k)
        if settings == controller.WINDOW_WARM_SETTINGS:
            x = sol.x.clone()
            x[:, 2] += 5.0
            sol = sol._replace(x=x)
        return sol, w
    monkeypatch.setattr(admm, "mpc_solve_warm_fused", fn)


def _half_sweep(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from go1_qp_mpc_controller_torch.parallel import sweep
    real = sweep._solve_one

    def fn(scn, mpc_dt, settings):
        half = scn.x0.shape[0] // 2
        sol = real(sweep.take(scn, slice(0, half)), mpc_dt, settings)
        x = torch.cat([sol.x, sol.x.mean(0).expand_as(sol.x)])
        return sol._replace(x=x, primal_res=torch.cat([sol.primal_res] * 2),
                            dual_res=torch.cat([sol.dual_res] * 2))
    monkeypatch.setattr(sweep, "_solve_one", fn)


CASES = [
    ("tiny-mpc-fleet-trot-4096", _unchanged_plant),
    ("tiny-mpc-fleet-trot-4096", _altered_torque),
    ("tiny-mpc-fleet-trot-4096", _half_batch),
    ("tiny-mpc-one-robot-joystick", _unchanged_plant),
    ("tiny-mpc-one-robot-joystick", _altered_torque),
    ("tiny-mpc-sweep-4096", _altered_solve),
    ("tiny-mpc-sweep-4096", _half_sweep),
    ("tiny-mpc-sweep-4096", _one_scenario_altered),
]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in CASES])
def test_a_broken_timed_path_is_not_correct(tiny_root, run_module, capsys,
                                            monkeypatch, workload, fault):
    fault(monkeypatch)
    # a window long enough to reach the trot, where the robots differ
    rc, res, err = run_cell(run_module, tiny_root, workload, capsys,
                            seconds=3.0)
    assert rc == 0, err
    assert res["correct"] is False, res["compared"]


def test_a_wrong_route_fails_its_own_number(tmp_path, capsys, monkeypatch):
    """One route's solves altered, the others sound: the route's own
    per-route number comes out over its limit."""
    import harness
    root = make_tiny_root(tmp_path)
    # as many kept ticks a route as the per-route numbers' least count,
    # and a window long enough for the tiny episode's window route
    path = root / "benchmark" / "traffic" / "tiny-joystick.json"
    mix = json.loads(path.read_text())
    mix["check_ticks_per_route"] = 6
    path.write_text(json.dumps(mix))
    run_module = harness.load_module(root / "benchmark" / "run.py",
                                     "bench_run_routes")
    _window_route_altered(monkeypatch)
    rc, res, err = run_cell(run_module, root, "tiny-mpc-one-robot-joystick",
                            capsys, seconds=8.0)
    assert rc == 0, err
    assert res["correct"] is False, res["compared"]
    over = {c["name"] for c in res["compared"] if c["value"] > c["limit"]}
    assert "grf_gap_median.window" in over, res["compared"]
    assert "grf_gap_median.cold" not in over, res["compared"]
