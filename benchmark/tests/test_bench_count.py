"""``attempted`` and ``failed`` cover a fixed set of whole episodes (the
fleet, one robot) or whole passes (the sweep) of the seed, whatever the
window's length: the window's part, then an untimed finish that adds
nothing to the window's own numbers. Driven on the CPU at tiny sizes with
short episodes."""

import pytest

import harness
from conftest import make_tiny_root, run_cell

# short episodes, so that a window of a few seconds passes the set
SIZES = {"fleet": dict(episode_ticks=6, fail_episodes=2),
         "one_robot": dict(episode_ticks=24, stand_ticks=4, fail_episodes=2),
         "sweep": dict(fail_passes=3)}
FLEET = "tiny-mpc-fleet-trot-4096"
ROBOT = "tiny-mpc-one-robot-joystick"
SWEEP = "tiny-mpc-sweep-4096"
SEED = 2 ** 33 + 17


@pytest.fixture(scope="module")
def count_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("count"), SIZES)


@pytest.fixture(scope="module")
def count_run(count_root):
    return harness.load_module(count_root / "benchmark" / "run.py",
                               "bench_run_count")


def _mix(root, workload):
    return harness.load_cell(root, root / "benchmark", workload)[3]


def _entry(workload):
    return "fleet" if workload == FLEET else "one_robot"


def _run(count_run, count_root, workload, capsys, seconds):
    rc, res, err = run_cell(count_run, count_root, workload, capsys,
                            seed=SEED, seconds=seconds)
    assert rc == 0, err
    return res


@pytest.mark.parametrize("workload", [FLEET, ROBOT, SWEEP])
def test_the_same_seed_counts_the_same_at_any_length(count_root, count_run,
                                                     capsys, workload):
    short = _run(count_run, count_root, workload, capsys, 0.05)
    long = _run(count_run, count_root, workload, capsys, 4.0)
    assert (short["attempted"], short["failed"]) == (long["attempted"],
                                                     long["failed"])
    rec = short["record"]
    mix = _mix(count_root, workload)
    if workload == SWEEP:
        per_pass = mix["batch"] * mix["pool"]
        assert short["attempted"] == per_pass * mix["fail_passes"]
        # the short window ended inside the set: the finish made it whole
        assert rec["calls"] + rec["finish_calls"] == (mix["pool"]
                                                      * mix["fail_passes"])
        assert len(rec["failed_by_pass"]) == mix["fail_passes"]
        assert long["record"]["calls"] > rec["calls"]
        return
    batch = mix.get("batch", 1)
    per = short["attempted"] // (batch * mix["fail_episodes"])
    assert short["attempted"] == batch * per * mix["fail_episodes"]
    assert rec["ticks"] + rec["finish_ticks"] == per * mix["fail_episodes"]
    # the routes and the ticks are the window's alone
    assert sum(rec["routes"].values()) == rec["ticks"]
    assert short["failed"] == sum(
        rec["failed_by_episode"][:mix["fail_episodes"]])
    assert long["record"]["ticks"] > rec["ticks"]


def _fall_in(monkeypatch, workload, episode):
    """Robot 0 starts 0.7 m higher in ``episode``: it falls through the
    top of the health band for longer than the episode lasts."""
    import importlib
    entry = importlib.import_module("entries." + _entry(workload))
    real = entry.Cell.fresh

    def fresh(self, e):
        carry = real(self, e)
        if e != episode:
            return carry
        pos = carry.sim.root_pos.clone()
        pos[0, 2] += 0.7
        return carry._replace(sim=carry.sim._replace(root_pos=pos))
    monkeypatch.setattr(entry.Cell, "fresh", fresh)


@pytest.mark.parametrize("workload", [FLEET, ROBOT])
def test_a_fall_inside_the_set_is_counted(count_root, count_run, capsys,
                                          monkeypatch, workload):
    base = _run(count_run, count_root, workload, capsys, 0.05)
    _fall_in(monkeypatch, workload, 1)
    res = _run(count_run, count_root, workload, capsys, 0.05)
    per = res["record"]["ticks"] + res["record"]["finish_ticks"]
    per //= SIZES[_entry(workload)]["fail_episodes"]
    assert res["record"]["failed_by_episode"][1] >= per
    assert res["failed"] >= base["failed"] + per
    assert res["attempted"] == base["attempted"]


@pytest.mark.parametrize("workload", [FLEET, ROBOT])
def test_a_fall_past_the_set_is_seen_not_counted(count_root, count_run,
                                                 capsys, monkeypatch,
                                                 workload):
    base = _run(count_run, count_root, workload, capsys, 0.05)
    past = SIZES[_entry(workload)]["fail_episodes"]
    _fall_in(monkeypatch, workload, past)
    res = _run(count_run, count_root, workload, capsys, 6.0)
    rec = res["record"]
    # the window reached the episode past the set
    assert rec["episodes"] > past and rec["finish_ticks"] == 0
    assert rec["failed_by_episode"][past] > 0
    assert len(rec["failed_by_episode"]) == rec["episodes"]
    assert (res["attempted"], res["failed"]) == (base["attempted"],
                                                 base["failed"])
