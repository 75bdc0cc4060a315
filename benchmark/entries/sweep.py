"""The scenario sweep: ``parallel/sweep.py::make_sweep_fn`` (``main.py
sweep``'s program) called back to back over a pool of scenario batches.

Traffic keys (``traffic/<mix>.json``): ``batch``, ``pool`` (batches made
in set-up from the seed by the benchmark's frozen copy of
``random_scenarios``, cycled through), ``warmup_calls``,
``check_calls`` (the calls kept for the reference), ``fail_passes`` and
``trace_seconds``.

``attempted`` counts the solves of the first ``fail_passes`` passes
through the pool, each whole: the window's calls, then, untimed, the calls
left of them. A solve fails when the solver flags it (its residuals
reported as 1e6, its forces latched to zeros) or its forces are not
finite. A failed solve is counted in ``failed`` and left out of the
reference's comparison, which judges every other solve of the kept
calls.
"""

import torch

from entries import common


def flags(out):
    """(B,) bool: the solves that failed, flagged by the solver (residuals
    of 1e6) or with forces that are not finite."""
    return (out.primal_res >= 1e6) | ~torch.isfinite(out.forces_all).all(-1)


class Cell:

    def __init__(self, config, mix, seed, device):
        from go1_qp_mpc_controller_torch.config import presets
        from go1_qp_mpc_controller_torch.ops import admm
        from go1_qp_mpc_controller_torch.parallel import sweep
        self.config, self.mix, self.seed, self.device = (config, mix, seed,
                                                         device)
        _, params, _ = presets.load_preset(config["preset"], torch.float32,
                                           device=device)
        self.mpc_dt = float(params.mpc_dt)
        self.path = config["paths"]["sweep"]
        self.program = sweep
        self.fn = sweep.make_sweep_fn(device, self.mpc_dt,
                                      admm.ADMMSettings(**self.path["cold"]))
        self.batch = int(mix["batch"])
        self.fail_passes = int(mix["fail_passes"])
        self.finish_calls = self.finish_s = None

    def setup(self):
        from reference.go1.parallel import sweep as rsweep
        # the inputs: the frozen copy's draws, handed to the program as its
        # own MpcScenario
        self.pool = [self.program.MpcScenario(*rsweep.random_scenarios(
            int(self.seed) * 64 + i, self.batch, torch.float32,
            self.device)) for i in range(int(self.mix["pool"]))]
        for i in range(int(self.mix["warmup_calls"])):
            self.fn(self.pool[i % len(self.pool)])
        common.sync(self.device)

    def advance(self, calls):
        """Call ``calls``: the pool's batch ``calls % pool``, its flagged
        solves tallied under its pass. Returns (batch index, output,
        flags)."""
        i = calls % len(self.pool)
        out = self.fn(self.pool[i])
        flagged = flags(out)
        self.tally.add(calls // len(self.pool), flagged.sum())
        return i, out, flagged

    def window(self, seconds, tracer):
        keep = common.Reservoir(int(self.mix["check_calls"]), self.seed)
        self.tally = common.Tally(self.device)
        calls = 0
        common.sync(self.device)
        tracer.start()
        t0 = self.started = common.now()
        while True:
            i, out, flagged = self.advance(calls)
            keep.offer("call", (i, out.forces_all, flagged))
            calls += 1
            tracer.step()
            if common.now() - t0 >= seconds:
                break
        common.sync(self.device)
        self.elapsed = common.now() - t0
        tracer.stop()
        self.calls, self.kept = calls, keep
        return {"solves_per_s": self.batch * calls / self.elapsed}

    def finish(self):
        """Untimed, once the window has closed and the peak is read: the
        calls left of the first ``fail_passes`` passes, through the
        window's own call, so that ``failed`` covers the same solves at any
        speed; nothing here adds to the window's time or kept calls."""
        t0 = common.now()
        total = self.fail_passes * len(self.pool)
        for calls in range(self.calls, total):
            self.advance(calls)
        common.sync(self.device)
        self.finish_calls = max(0, total - self.calls)
        self.finish_s = common.now() - t0
        self.failed = sum(self.tally.counts()[:self.fail_passes])

    def attempted(self):
        return self.batch * len(self.pool) * self.fail_passes

    def record(self):
        return {"calls": self.calls, "batch": self.batch,
                "failed_by_pass": self.tally.counts(),
                "finish_calls": self.finish_calls,
                "finish_s": self.finish_s,
                "settings": dict(self.path["cold"])}

    def check(self, limits, control=False):
        """The reference's verdict on the kept calls. With ``control`` the
        outputs judged are the reference's own, computed in float32 with
        TF32 products, in the program's place."""
        from reference import check
        from reference.go1.ops import admm as radmm
        settings = radmm.ADMMSettings(**self.path["cold"])
        gaps, left_out = [], 0
        for _, (i, forces, flagged) in self.kept.items():
            scn = check.scenarios_of(self.pool[i], torch.float64,
                                     self.device)
            ref_x, _ = check.sweep_solve(scn, self.mpc_dt, settings)
            if control:
                with check.tf32():
                    forces, flagged = check.sweep_solve(
                        check.scenarios_of(self.pool[i], torch.float32,
                                           self.device),
                        self.mpc_dt, settings)
            first, whole = check.sweep_gaps(forces.double(), ref_x, scn)
            keep = ~flagged.to(first.device)
            left_out += int((~keep).sum())
            gaps.append({"grf": first[keep], "horizon": whole[keep]})
        return common.judge(gaps, limits,
                            {"checked_calls": len(gaps),
                             "flagged_left_out": left_out})
