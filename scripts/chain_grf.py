#!/usr/bin/env python3
"""The dense chain's warm-vs-tight GRF error of several checkouts against
one fixed reference, over several seeds.

For each seed and each ``--root`` (a checkout, e.g. one unpacked from
``git archive``), a process of its own runs that checkout's dense chain on
the card: ``chip_smoke.dense_chain_phase``'s chain (a fresh cold solve,
then ``CHAIN_TICKS`` warm ticks of ``mpc_solve_warm_batch`` at batch 4096,
bench.py:470-504's settings and drift) on that checkout's
``chip_smoke.random_scenarios`` of the seed (the same draws in every
checkout: a dict before the port had ``parallel/sweep.py``, an
``MpcScenario`` since), keeping the last tick's first-step GRFs of the first
``TIGHT_SCENARIOS`` scenarios. This checkout then holds every root's GRFs
against the same reference, ``chip_smoke.tight_reference`` (the tight
polished solve in float64 on the CPU, which no kernel's rounding moves),
and, for scale, the same chain run on the CPU by the kernels' plain
versions, in float32 and in float64, on those scenarios. Prints p50 / p90
(N) per seed and root, then over all seeds' scenarios.

    python3 scripts/chain_grf.py --root build/parent --root . \\
        [--seeds 3,4,5,6,7]

Seed 3 is ``chip_smoke.py``'s own dense-chain seed.
"""

import argparse
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def field(scn, name):
    """A field of a scenario batch, a dict or an ``MpcScenario``."""
    return scn[name] if isinstance(scn, dict) else getattr(scn, name)


def chain(admm, admm_iterations, condense, scn, ticks):
    """The last tick's solution of the dense warm chain on ``scn`` (its
    device and dtype): ``admm.mpc_solve_cold`` on the lazy QPs, then
    ``ticks`` warm ticks, the start state drifting as in bench.py:503-504
    (accumulated in float32, as the card's chain does, then cast)."""
    import torch
    settings_cold = admm.ADMMSettings(seg_iters=40, segments=1, polish=False,
                                      schulz_l0=1e-6, schulz_hi_tail=1,
                                      schulz_impl="pallas")
    settings_warm = admm.ADMMSettings(seg_iters=15, segments=1, polish=False,
                                      schulz_refine=1, schulz_impl="pallas")
    x0, mu = field(scn, "x0"), field(scn, "mu")
    dtype = x0.dtype
    _, warm = admm.mpc_solve_cold(condense(scn, x0, dense=False),
                                  settings_cold, mu=mu,
                                  contacts=field(scn, "contacts"),
                                  foot_pos=field(scn, "foot_pos"))
    x0 = x0.float()
    drift = torch.zeros_like(x0)
    drift[:, 9] = 0.001
    drift[:, 3] = 0.0005
    for _ in range(ticks):
        x0 = x0 + drift
        qps = condense(scn, x0.to(dtype), dense=True)
        sol, warm = admm_iterations.mpc_solve_warm_batch(qps, warm, mu,
                                                         settings_warm)
    return sol, x0


def card_run(root, seeds, path):
    """In this process: ``root``'s chain on the card for each seed; saves
    {seed: (TIGHT_SCENARIOS, 12) float64 GRFs on the CPU} to ``path``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from go1_qp_mpc_controller_torch.ops import _build, admm, admm_iterations
    from go1_qp_mpc_controller_torch.utils.device import pin_f32_matmuls

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    pin_f32_matmuls()
    _build.build_all()
    device = torch.device("cuda")
    grfs = {}
    for seed in seeds:
        scn = cs.random_scenarios(cs.BATCH, seed, device)
        admm_iterations.reset_launches()
        sol, _ = chain(admm, admm_iterations, cs.condense, scn,
                       cs.CHAIN_TICKS)
        assert admm_iterations.launches == cs.CHAIN_TICKS + 1, \
            "the chain did not run on K6"
        grfs[seed] = sol.x[:cs.TIGHT_SCENARIOS, :12].double().cpu()
    torch.save(grfs, path)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", required=True,
                        help="a checkout whose chain runs on the card "
                             "(repeat for each)")
    parser.add_argument("--seeds", default="3,4,5,6,7")
    parser.add_argument("--save", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.save:
        card_run(args.root[0], seeds, args.save)
        return

    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from go1_qp_mpc_controller_torch.ops import admm, admm_iterations
    from go1_qp_mpc_controller_torch.parallel import sweep

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the chains run on a GPU")
    print(f"card {cs.card_line()}", flush=True)
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(args.root):
            path = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--root", root, "--seeds", args.seeds,
                            "--save", path], check=True)
            got[root] = torch.load(path)

    cpu = torch.device("cpu")
    n = cs.TIGHT_SCENARIOS
    errs = {}

    def report(seed, name, x, tight):
        err = (x[:, :12].cpu().double() - tight).abs().amax(-1)
        errs.setdefault(name, []).append(err)
        print(f"seed {seed} [{name}] p50 {float(err.median()):.4f} N, p90 "
              f"{float(torch.quantile(err, 0.9)):.4f} N", flush=True)

    for seed in seeds:
        scn = sweep.take(cs.random_scenarios(cs.BATCH, seed, cpu),
                         slice(0, n))
        plain = {}
        for dtype in (torch.float32, torch.float64):
            scn_d = cs.on_cpu(scn, dtype)
            plain[dtype], x0 = chain(admm, admm_iterations, cs.condense,
                                     scn_d, cs.CHAIN_TICKS)
        tight = cs.tight_reference(scn, x0, n)
        for root in args.root:
            report(seed, root, got[root][seed], tight)
        for dtype, sol in plain.items():
            report(seed, f"plain {str(dtype)[6:]}, CPU", sol.x, tight)
    for name, parts in errs.items():
        err = torch.cat(parts)
        print(f"all seeds, {err.numel()} scenarios [{name}] p50 "
              f"{float(err.median()):.4f} N, p90 "
              f"{float(torch.quantile(err, 0.9)):.4f} N", flush=True)


if __name__ == "__main__":
    main()
