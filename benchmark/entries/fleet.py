"""The fleet: ``envs/rollout.py::rollout_batched`` over one batch of robots,
closed loop, one tick a call, in episodes that restart the whole fleet
from fresh seeded starts.

Traffic keys (``traffic/<mix>.json``): ``batch``, ``dt``, ``episode_ticks``,
``height_sigma``, ``vel_sigma``, ``vx`` ([lo, hi], uniform per robot and
episode), ``warmup_ticks`` (set-up: a fresh start run that far, then one
tick with a few carried contact patterns flipped so that the compacted
cold route is built too), ``check_ticks_per_route`` (the ticks of each
route kept for the reference), ``fail_episodes`` (the episodes that
``attempted`` and ``failed`` cover) and ``trace_seconds``.

``attempted`` counts the robot-ticks of the seed's first ``fail_episodes``
episodes, each whole: the window's, then, untimed, the rest of them
(:meth:`common.ClosedLoop.finish`). A robot-tick fails when its torques or
forces are not finite, or when its robot has left the health band of the
port's walking tests (height in [0.25, 0.35] m, tilt under 0.25 rad).
"""

import torch

from entries import common


class Cell(common.ClosedLoop):

    def __init__(self, config, mix, seed, device):
        super().__init__(config, mix, seed, device)
        from go1_qp_mpc_controller_torch.envs import rollout
        from go1_qp_mpc_controller_torch.ops import admm
        from go1_qp_mpc_controller_torch.utils import graphs
        self.rollout, self.graphs = rollout, graphs
        path = config["paths"]["fleet"]
        self.path = path
        self.settings = admm.ADMMSettings(**path["cold"])
        self.warm_settings = admm.ADMMSettings(**path["warm"])
        self.batch = int(mix["batch"])
        self.routes = {}

    def fresh(self, episode):
        """The fleet's start for ``episode``: a perturbed standing start and
        a trot command per robot, drawn on the device from the seed."""
        mix, batch = self.mix, self.batch
        gen = common.generator(self.device, self.seed, episode)
        f32 = torch.float32
        carry = self.rollout.init_carry(self.model, self.params, batch,
                                        dtype=f32, device=self.device)
        dz = mix["height_sigma"] * torch.randn(
            (batch,), generator=gen, device=self.device, dtype=f32)
        dv = mix["vel_sigma"] * torch.randn(
            (batch, 3), generator=gen, device=self.device, dtype=f32)
        lo, hi = mix["vx"]
        vx = lo + (hi - lo) * torch.rand((batch,), generator=gen,
                                         device=self.device, dtype=f32)
        sim = carry.sim._replace(
            root_pos=carry.sim.root_pos + torch.nn.functional.pad(
                dz[:, None], (2, 0)),
            root_lin_vel=carry.sim.root_lin_vel + dv)
        vel = torch.nn.functional.pad(vx[:, None], (0, 2))
        ctrl = carry.ctrl._replace(
            movement_mode=torch.ones_like(carry.ctrl.movement_mode),
            root_lin_vel_d=vel)
        return carry._replace(sim=sim, ctrl=ctrl)

    def tick(self, carry, stats=None):
        return self.rollout.rollout_batched(
            carry, self.model, self.params, 1, self.dt,
            settings=self.settings,
            use_terrain_adapt=self.static.use_terrain_adapt,
            warm_settings=self.warm_settings,
            compact_k=int(self.path["compact_k"]), stats=stats)

    def setup(self):
        carry = self.fresh(-1)
        for _ in range(int(self.mix["warmup_ticks"])):
            carry, _ = self.tick(carry)
        # the compacted cold route: flip the carried contact pattern of a
        # few robots, as a lone early touchdown would
        flip = torch.arange(0, self.batch, max(1, self.batch // 5),
                            device=self.device)[:5]
        qc = carry.ctrl.qp_warm_contacts.clone()
        qc[flip] = ~qc[flip]
        carry = carry._replace(ctrl=carry.ctrl._replace(qp_warm_contacts=qc))
        self.tick(carry)
        common.sync(self.device)

    def advance(self, carry, episode, k):
        carry, rec = self.tick(carry)
        self.tally.add(episode, common.unhealthy(carry.sim, rec).sum())
        return carry

    def window(self, seconds, tracer):
        episode = 0
        carry = self.begin(episode)
        self.tally = common.Tally(self.device)
        keep = common.Reservoir(int(self.mix["check_ticks_per_route"]),
                                self.seed)
        ticks = in_episode = 0
        replays0 = self.graphs.replays
        common.sync(self.device)
        tracer.start()
        t0 = self.started = common.now()
        while True:
            stats = {}
            c0 = carry
            carry, rec = self.tick(c0, stats)
            (route,) = stats
            self.routes[route] = self.routes.get(route, 0) + 1
            self.tally.add(episode, common.unhealthy(carry.sim, rec).sum())
            keep.offer(route, (c0, carry))
            ticks += 1
            in_episode += 1
            tracer.step()
            if common.now() - t0 >= seconds:
                break
            if in_episode == self.episode_ticks:
                episode += 1
                in_episode = 0
                carry = self.begin(episode)
        common.sync(self.device)
        elapsed = common.now() - t0
        tracer.stop()
        self.replays = self.graphs.replays - replays0
        self.kept = keep
        self.ticks, self.elapsed, self.episodes = ticks, elapsed, episode + 1
        self.at = (carry, episode, in_episode)
        return {"fleet_ticks_per_s": self.batch * ticks / elapsed}

    def attempted(self):
        return self.batch * self.episode_ticks * self.fail_episodes

    def record(self):
        return dict(self.finished(), ticks=self.ticks,
                    routes=dict(self.routes), replays=self.replays,
                    episodes=self.episodes)

    def check(self, limits, control=False):
        """The reference's verdict on the kept ticks. With ``control`` the
        outputs judged are the reference's own, computed in float32 with
        TF32 products, in the program's place."""
        from reference import check
        dev = self.device
        rm, rp, static = check.model_params(self.config["preset"], dev)
        from reference.go1.ops import admm as radmm
        settings = radmm.ADMMSettings(**self.path["cold"])
        warm = radmm.ADMMSettings(**self.path["warm"])
        gaps, routes = [], {}
        for route, (c0, c1) in self.kept.items():
            cands = check.mpc_tick_batched(
                check.carry_of(c0, torch.float64, dev), rm, rp, self.dt,
                settings, warm, int(self.path["compact_k"]),
                static.use_terrain_adapt)
            if control:
                c1 = check.control_tick_batched(
                    c0, self.config["preset"], self.dt, settings, warm,
                    int(self.path["compact_k"]), dev)
            prog = check.carry_of(c1, torch.float64, dev)
            g, _ = check.tick_gaps(cands, prog.ctrl, prog.sim, rm.mass,
                                   self.dt)
            gaps.append(g)
            routes[route] = routes.get(route, 0) + 1
        return common.judge(gaps, limits, {"checked_ticks": routes})

