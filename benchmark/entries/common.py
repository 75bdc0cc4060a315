"""What the entries share: the configuration's model, seeded device
generators, the health band, the device tally of failures, the untimed
finish of the counted episodes, the reservoir of ticks kept for the
reference, and the verdict from the gaps."""

import math
import time

import numpy as np
import torch

# the health band of the port's walking tests
HEIGHT = (0.25, 0.35)
TILT = 0.25


def now():
    return time.perf_counter()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generator(device, seed, stream):
    """A torch.Generator on ``device`` for draw stream ``stream`` of
    ``seed`` (any whole number; the pair is hashed into 64 bits)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + (int(stream) + 2)
             * 0xBF58476D1CE4E5B9) % (1 << 64)
    return torch.Generator(device=device).manual_seed(mixed)


def rng(seed, stream):
    """A numpy Generator for host draws of ``seed``'s stream ``stream``."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream) + 2])


def unhealthy(sim, rec):
    """(B,) bool: a robot's tick left the health band or its outputs are
    not finite (``rec``: the tick's RolloutTrace, T = 1)."""
    z = rec.root_pos[0, :, 2]
    finite = (torch.isfinite(rec.joint_torques[0]).all(-1)
              & torch.isfinite(rec.foot_forces_grf[0]).flatten(1).all(-1))
    upright = sim.root_rot[:, 2, 2] > math.cos(TILT)
    return ~(finite & (z >= HEIGHT[0]) & (z <= HEIGHT[1]) & upright)


class Tally:
    """Failed operations counted on the device, one count for each episode
    or pass: adding reads nothing back to the host, :meth:`counts` does."""

    def __init__(self, device):
        self.device = device
        self.by = []

    def add(self, index, n):
        while len(self.by) <= index:
            self.by.append(torch.zeros((), dtype=torch.int64,
                                       device=self.device))
        self.by[index] += n

    def counts(self):
        """[int] the failures of each episode or pass touched, in order."""
        return [int(v) for v in torch.stack(self.by).cpu()] if self.by \
            else []


class Reservoir:
    """Up to ``k`` items of each key, a uniform sample (drawn from the
    seed) of all the items offered under it."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = rng(seed, 1)
        self.kept = {}
        self.seen = {}

    def offer(self, key, item):
        n = self.seen.get(key, 0) + 1
        self.seen[key] = n
        kept = self.kept.setdefault(key, [])
        if len(kept) < self.k:
            kept.append(item)
        else:
            j = int(self.rng.integers(n))
            if j < self.k:
                kept[j] = item

    def items(self):
        """[(key, item)] of every item kept."""
        return [(key, item) for key, kept in self.kept.items()
                for item in kept]


class ClosedLoop:
    """A cell that runs the controller in closed loop on the plant: the
    configuration's preset, loaded as the program loads it. An entry gives
    ``fresh(episode)`` (the seeded start), ``advance(carry, episode, k)``
    (tick ``k`` of ``episode``, its failures added to ``tally``) and a
    window that leaves ``tally`` and ``at`` (carry, episode, ticks run in
    it) for :meth:`finish`."""

    def __init__(self, config, mix, seed, device):
        from go1_qp_mpc_controller_torch.config import presets
        self.config, self.mix, self.seed, self.device = (config, mix, seed,
                                                         device)
        self.model, self.params, self.static = presets.load_preset(
            config["preset"], torch.float32, device=device)
        self.dt = float(mix["dt"])
        self.episode_ticks = int(mix["episode_ticks"])
        self.fail_episodes = int(mix["fail_episodes"])
        self.finish_ticks = self.finish_s = None

    def begin(self, episode):
        """The carry that starts ``episode``."""
        return self.fresh(episode)

    def finish(self):
        """Untimed, once the window has closed and the peak is read: the
        rest of the seed's first ``fail_episodes`` episodes, from where the
        window stopped, each tick through :meth:`advance` (the window's own
        tick and health test). So ``failed`` covers the same whole episodes
        at any speed; nothing here adds to the window's times, routes,
        counters or kept ticks."""
        carry, episode, k = self.at
        t0, ticks = now(), 0
        while episode < self.fail_episodes:
            if k == self.episode_ticks:
                episode, k = episode + 1, 0
                if episode < self.fail_episodes:
                    carry = self.begin(episode)
                continue
            carry = self.advance(carry, episode, k)
            k += 1
            ticks += 1
        sync(self.device)
        self.at = None
        self.finish_ticks, self.finish_s = ticks, now() - t0
        self.failed = sum(self.tally.counts()[:self.fail_episodes])

    def finished(self):
        """The record's count of failures: each episode's, every episode
        the run touched (those past ``fail_episodes`` are not in
        ``failed``), and the untimed finish's ticks and seconds."""
        return {"failed_by_episode": self.tally.counts(),
                "finish_ticks": self.finish_ticks, "finish_s": self.finish_s}


STATS = {"max": lambda v: float(v.max()),
         "p99": lambda v: float(torch.quantile(v, 0.99)),
         "p90": lambda v: float(torch.quantile(v, 0.9)),
         "median": lambda v: float(v.median())}


def _pool(gaps):
    """{gap name: (N,) float64 on the CPU} of a list of ``check.Gaps`` (or
    of dicts of (N,) tensors)."""
    pooled = {}
    for g in gaps:
        items = g._asdict().items() if hasattr(g, "_asdict") else g.items()
        for name, v in items:
            pooled.setdefault(name, []).append(v.double().cpu().reshape(-1))
    return {k: torch.cat(v) for k, v in pooled.items()}


def _stat(v, stat):
    return STATS[stat](v) if v is not None and v.numel() else math.inf


def judge(gaps, limits, info, groups=None):
    """(compared, readings, correct) from a list of ``check.Gaps`` (or of
    dicts of (N,) tensors): every number the limits file names, beside its
    limit, and every reading. ``groups`` ({route: list of Gaps}) serves the
    numbers marked ``"per": "route"``, whose ``limit`` is {route: limit},
    ``"*"`` for a route not named: each route with at least ``min_n`` kept
    items is compared on its own, as ``<name>.<route>``."""
    pooled = _pool(gaps)
    readings = dict(info)
    for name, v in pooled.items():
        readings[f"{name}.n"] = int(v.numel())
        for stat in STATS:
            readings[f"{name}.{stat}"] = _stat(v, stat)
    by_route = {r: _pool(g) for r, g in (groups or {}).items()}
    for r, pool in by_route.items():
        for name, v in pool.items():
            for stat in STATS:
                readings[f"{name}.{stat}.{r}"] = _stat(v, stat)
    compared, correct = [], bool(pooled)
    for num in limits["numbers"]:
        if num.get("per") == "route":
            values = [(f"{num['name']}.{r}", _stat(pool.get(num["gap"]),
                                                   num["stat"]),
                       num["limit"].get(r, num["limit"]["*"]))
                      for r, pool in sorted(by_route.items())
                      if pool[num["gap"]].numel() >= int(num["min_n"])]
        else:
            values = [(num["name"], _stat(pooled.get(num["gap"]),
                                          num["stat"]), num["limit"])]
        for name, value, limit in values:
            ok = math.isfinite(value) and value <= limit
            correct = correct and ok
            compared.append({"name": name, "value": value, "limit": limit})
    return compared, readings, correct
