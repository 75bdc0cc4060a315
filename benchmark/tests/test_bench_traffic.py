"""Each traffic generator is deterministic per seed and gives its mix's
parameters."""

import json

import pytest
import torch


def _mix(root, name):
    return json.loads((root / "benchmark" / "traffic" / f"{name}.json")
                      .read_text())


def test_joystick_schedule_is_seeded_and_in_range(tiny_root):
    from entries import one_robot
    mix = _mix(tiny_root, "joystick")
    a = one_robot.schedule(mix, 2 ** 40 + 7, 3)
    assert a == one_robot.schedule(mix, 2 ** 40 + 7, 3)
    assert len(a) == mix["episode_ticks"]
    assert a[:mix["stand_ticks"]] == [(0, 0.0)] * mix["stand_ticks"]
    # the segments: runs of one command after the stand
    runs, i = [], mix["stand_ticks"]
    while i < len(a):
        j = i
        while j < len(a) and a[j] == a[i]:
            j += 1
        runs.append((a[i], j - i))
        i = j
    assert sorted(n for _, n in runs) == sorted(mix["segments"])
    assert [n for (mode, _), n in runs if mode == 0] == [mix["stand_segment"]]
    trots = sorted(vx for (mode, vx), _ in runs if mode == 1)
    lo, hi = mix["vx"]
    k = len(trots)
    assert trots == pytest.approx([lo + (hi - lo) * (i + 0.5) / k
                                   for i in range(k)])


def test_joystick_seeds_change_the_order_not_the_work(tiny_root):
    from entries import one_robot
    mix = _mix(tiny_root, "joystick")
    orders = {tuple(one_robot.schedule(mix, seed, 0)) for seed in range(12)}
    assert len(orders) > 1
    for plan in orders:
        assert sum(mode for mode, _ in plan) == sum(
            n for n in mix["segments"] if n != mix["stand_segment"])
        assert sorted(set(plan)) == sorted(set(one_robot.schedule(mix, 0, 0)))


def _fleet(root, seed):
    import harness
    from entries import fleet
    bench = harness.bench_file(root)
    config = json.loads((root / "benchmark" / "configs"
                         / "go1-gazebo-mpc.json").read_text())
    mix = _mix(root, "tiny-fleet-trot")
    del bench
    return fleet.Cell(config, mix, seed, torch.device("cpu")), mix


def test_fleet_starts_are_seeded_and_in_range(tiny_root):
    cell, mix = _fleet(tiny_root, 2 ** 33 + 1)
    a, b = cell.fresh(4), cell.fresh(4)
    c = _fleet(tiny_root, 2 ** 33 + 2)[0].fresh(4)
    assert torch.equal(a.sim.root_pos, b.sim.root_pos)
    assert torch.equal(a.ctrl.root_lin_vel_d, b.ctrl.root_lin_vel_d)
    assert not torch.equal(a.sim.root_pos, c.sim.root_pos)
    vx = a.ctrl.root_lin_vel_d[:, 0]
    assert bool(((vx >= mix["vx"][0]) & (vx <= mix["vx"][1])).all())
    assert bool((a.ctrl.root_lin_vel_d[:, 1:] == 0).all())
    assert bool((a.ctrl.movement_mode == 1).all())
    assert a.sim.root_pos.shape == (mix["batch"], 3)
    # the gaits start in phase, with init_ctrl_state's offsets
    assert bool((a.ctrl.gait_counter == torch.tensor(
        [0.0, 120.0, 120.0, 0.0])).all())


@pytest.mark.parametrize("seed", [5, 2 ** 35 + 11])
def test_sweep_pool_is_seeded(tiny_root, seed):
    from reference.go1.parallel import sweep
    a = sweep.random_scenarios(seed * 64, 16, torch.float32, "cpu")
    b = sweep.random_scenarios(seed * 64, 16, torch.float32, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    mass = a.mass
    assert bool(((mass >= 10.0) & (mass <= 18.0)).all())
    assert bool((a.contacts.sum(-1) >= 2).all())
