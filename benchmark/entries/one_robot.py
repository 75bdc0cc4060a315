"""One robot: ``envs/rollout.py::rollout`` at batch 1 (the captured
``tick_parts`` on the card), one tick a call, closed loop with one client:
each tick runs from the command given to its joint torques in host
memory, as a robot hands them to its motors, and the next starts then.

Traffic keys (``traffic/<mix>.json``): ``dt``, ``episode_ticks``,
``stand_ticks`` (each episode begins standing), ``segments`` (the
joystick's segment lengths, in an order drawn from the seed),
``stand_segment`` (the length of the one that stands; the others trot),
``vx`` ([lo, hi], the trots' forward speeds, stratified), ``height_sigma``, ``vel_sigma`` (the seeded start), ``warmup_ticks``
(set-up: one episode's schedule that far, which captures the graphs and
replays every route), ``check_ticks_per_route``, ``fail_episodes`` and
``trace_seconds``.

``attempted`` counts the ticks of the seed's first ``fail_episodes``
episodes, each whole (the window's, then, untimed, the rest of them); a
tick fails as a fleet's robot-tick does.
"""

import torch

from entries import common


def schedule(mix, seed, episode):
    """[(movement_mode, vx)] for each tick of ``episode``: the stand, then
    the mix's joystick segments in an order drawn from the seed. Every
    episode holds the same segments, so that a seed changes the order of
    the work and not its amount: the ``segments`` lengths are shuffled,
    the one of length ``stand_segment`` stands (movement mode 0) and the
    others trot at the ``vx`` range's stratified speeds (the midpoints of
    equal shares), shuffled too."""
    rng = common.rng(seed, 100 + episode)
    out = [(0, 0.0)] * int(mix["stand_ticks"])
    lengths = list(mix["segments"])
    trots = [n for n in lengths if n != mix["stand_segment"]]
    lo, hi = mix["vx"]
    speeds = [lo + (hi - lo) * (k + 0.5) / len(trots)
              for k in range(len(trots))]
    rng.shuffle(speeds)
    order = rng.permutation(len(lengths))
    for i in order:
        n = int(lengths[i])
        out += [(0, 0.0)] * n if n == mix["stand_segment"] else \
            [(1, float(speeds.pop()))] * n
    return out[:int(mix["episode_ticks"])]


def command(mode, vx):
    """``main.py rollout``'s command_fn for one tick."""
    def fn(_, ctrl):
        vel = torch.zeros_like(ctrl.root_lin_vel_d)
        vel[:, 0] = vx
        return ctrl._replace(
            movement_mode=torch.full_like(ctrl.movement_mode, mode),
            root_lin_vel_d=vel)
    return fn


def cat_trees(trees):
    """NamedTuples of batch-first tensors joined along the batch."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    return type(first)(*[cat_trees(list(leaves)) for leaves in zip(*trees)])


class Cell(common.ClosedLoop):

    def __init__(self, config, mix, seed, device):
        super().__init__(config, mix, seed, device)
        from go1_qp_mpc_controller_torch.ctrl import controller
        from go1_qp_mpc_controller_torch.envs import rollout
        from go1_qp_mpc_controller_torch.ops import admm
        from go1_qp_mpc_controller_torch.utils import graphs
        self.rollout, self.graphs = rollout, graphs
        path = config["paths"]["one_robot"]
        if path["solver"] != "mpc":
            raise ValueError("the one-robot entry runs the MPC solve")
        self.path = path
        self.kw = dict(
            solver_type=controller.MPC,
            settings=admm.ADMMSettings(**path["cold"]),
            warm_settings=(admm.ADMMSettings(**path["warm"])
                           if path.get("warm") else None),
            warm_mode=path.get("warm_mode", "auto"),
            estimate=bool(path["estimate"]),
            use_terrain_adapt=self.static.use_terrain_adapt)
        # every episode holds the same segments, so the same ticks
        self.episode_ticks = len(schedule(mix, seed, 0))

    def fresh(self, episode):
        """A seeded standing start on the device."""
        mix = self.mix
        gen = common.generator(self.device, self.seed, episode)
        f32 = torch.float32
        carry = self.rollout.init_carry(self.model, self.params, 1,
                                        dtype=f32, device=self.device)
        dz = mix["height_sigma"] * torch.randn(
            (1,), generator=gen, device=self.device, dtype=f32)
        dv = mix["vel_sigma"] * torch.randn(
            (1, 3), generator=gen, device=self.device, dtype=f32)
        return carry._replace(sim=carry.sim._replace(
            root_pos=carry.sim.root_pos + torch.nn.functional.pad(
                dz[:, None], (2, 0)),
            root_lin_vel=carry.sim.root_lin_vel + dv))

    def tick(self, carry, cmd, stats):
        carry, rec = self.rollout.rollout(
            carry, self.model, self.params, 1, self.dt,
            command_fn=command(*cmd), stats=stats, **self.kw)
        return carry, rec, rec.joint_torques[0, 0].cpu()

    def setup(self):
        carry = self.fresh(-1)
        plan = schedule(self.mix, self.seed, -1)
        n = int(self.mix["warmup_ticks"])
        # one standing stretch then a trot: every route's graph replays
        plan = plan[:min(n // 2, len(plan))] + [(1, 0.25)] * (n - n // 2)
        for cmd in plan:
            carry, _, _ = self.tick(carry, cmd, {})
        common.sync(self.device)

    def begin(self, episode):
        self.plan = schedule(self.mix, self.seed, episode)
        return self.fresh(episode)

    def advance(self, carry, episode, k):
        carry, rec, _ = self.tick(carry, self.plan[k], {})
        self.tally.add(episode, common.unhealthy(carry.sim, rec).sum())
        return carry

    def window(self, seconds, tracer):
        episode, k = 0, 0
        carry = self.begin(episode)
        self.tally = common.Tally(self.device)
        keep = common.Reservoir(int(self.mix["check_ticks_per_route"]),
                                self.seed)
        walls, stats, routes = [], {}, {}
        replays0 = self.graphs.replays
        common.sync(self.device)
        tracer.start()
        t_start = self.started = common.now()
        while True:
            before = dict(stats)
            c0 = carry
            cmd = self.plan[k]
            t0 = common.now()
            carry, rec, tau = self.tick(c0, cmd, stats)
            walls.append(common.now() - t0)
            keys = tuple(sorted(r for r in stats
                                if stats[r] != before.get(r, 0)))
            route = "+".join(keys)
            routes[route] = routes.get(route, 0) + 1
            self.tally.add(episode, common.unhealthy(carry.sim, rec).sum())
            keep.offer(route, (c0, cmd, carry))
            tracer.step()
            k += 1
            if common.now() - t_start >= seconds:
                break
            if k == self.episode_ticks:
                episode, k = episode + 1, 0
                carry = self.begin(episode)
        common.sync(self.device)
        self.elapsed = common.now() - t_start
        tracer.stop()
        self.walls, self.routes, self.kept = walls, routes, keep
        self.replays = self.graphs.replays - replays0
        self.episodes = episode + 1
        self.at = (carry, episode, k)
        ms = [w * 1e3 for w in walls]
        from harness import quantile
        return {"tick_p50_ms": quantile(ms, 0.5),
                "tick_p99_ms": quantile(ms, 0.99)}

    def attempted(self):
        return self.episode_ticks * self.fail_episodes

    def record(self):
        return dict(self.finished(), ticks=len(self.walls),
                    routes=dict(self.routes), replays=self.replays,
                    episodes=self.episodes)

    def check(self, limits, control=False):
        """The reference's verdict on the kept ticks. With ``control`` the
        outputs judged are the reference's own, computed in float32 with
        TF32 products, in the program's place."""
        from reference import check
        from reference.go1.ctrl import controller as rcontroller
        from reference.go1.ops import admm as radmm
        dev = self.device
        items = self.kept.items()
        rm, rp, static = check.model_params(self.config["preset"], dev)
        # the tick's input: the carry with the traffic's command applied,
        # as rollout's command_fn applies it
        c0 = cat_trees([c._replace(ctrl=command(*cmd)(0, c.ctrl))
                        for _, (c, cmd, _) in items])
        c1 = cat_trees([c for _, (_, _, c) in items])
        settings = radmm.ADMMSettings(**self.path["cold"])
        if control:
            c1 = check.control_tick_one(
                c0, self.config["preset"], self.dt, self.path, settings, dev)
        c1 = check.carry_of(c1, torch.float64, dev)
        c0 = check.carry_of(c0, torch.float64, dev)
        warm = (radmm.ADMMSettings(**self.path["warm"])
                if self.path.get("warm") else rcontroller.WARM_SETTINGS)
        cands = check.mpc_tick_one(c0, rm, rp, self.dt, settings, warm,
                                   static.use_terrain_adapt)
        gaps, _ = check.tick_gaps(cands, c1.ctrl, c1.sim, rm.mass, self.dt)
        routes, groups = {}, {}
        for i, (route, _) in enumerate(items):
            routes[route] = routes.get(route, 0) + 1
            groups.setdefault(route, []).append(i)
        groups = {r: [check.Gaps(*[v[idx] for v in gaps])]
                  for r, idx in groups.items()}
        return common.judge([gaps], limits, {"checked_ticks": routes},
                            groups)
