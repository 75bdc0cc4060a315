"""Process entry point: preset-driven controller runs of the PyTorch port.

Port of the JAX package's ``main.py`` (the reference's
Main{Gazebo,Hardware,Isaac}.cpp executables and roslaunch preset
selection, launch/a1_ctrl.launch:1-8):

  python -m go1_qp_mpc_controller_torch.main --preset gazebo_mpc rollout
  python -m go1_qp_mpc_controller_torch.main --preset gazebo_mpc sweep
  python -m go1_qp_mpc_controller_torch.main --preset gazebo_mpc loop \
      --duration 5 --time-scale 0.1 --estimate-in-feed

Modes:
  rollout - closed-loop trot of one robot on the SRB simulator (the Gazebo
            stand-in), printing tracking statistics; ``--horizon H`` other
            than 10 solves the GRFs with the stagewise long-horizon solver.
  sweep   - a batch of randomized MPC scenarios solved over a (data, mpc)
            mesh of cards; ``torchrun --nproc_per_node=N -m
            go1_qp_mpc_controller_torch.main sweep --mpc-parallel k``
            across N cards, one process alone on one card.
  loop    - the real-time host loop against the C++ bridge, fed by the
            simulated 1 kHz sensor feed (or an external feed with
            --no-feeder).
  rl      - the RL stack's closed loop (the reference's go1_rl_ctrl_cpp
            MainGazebo process): servo stand, an A-button press to the
            walk policy, position commands to the PD plant.
  rl-loop - the RL host loop over the bridge (estimator + policy at the
            action cadence) against the simulated sensor feed.

  python -m go1_qp_mpc_controller_torch.main rl --steps 800
  python -m go1_qp_mpc_controller_torch.main rl-loop --duration 5

All run on the CUDA card unless ``--device cpu`` is given (a CPU sweep
under ``torchrun`` joins over gloo).
"""

import argparse
import json


def cmd_rollout(args, model, params, static, device):
    import numpy as np
    import torch

    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.envs import rollout
    from go1_qp_mpc_controller_torch.ops import admm

    f32 = torch.float32
    # the stagewise path sizes the warm carry for its horizon
    carry = rollout.init_carry(model, params, 1, height=args.height,
                               dtype=f32, device=device,
                               horizon=args.horizon)

    def command(i, ctrl):
        walk = i >= 100
        vel = torch.zeros_like(ctrl.root_lin_vel_d)
        if walk:
            vel[:, 0], vel[:, 1] = args.vx, args.vy
        return ctrl._replace(
            movement_mode=torch.full_like(ctrl.movement_mode, int(walk)),
            root_lin_vel_d=vel)

    solver = controller.MPC if static.solver == "mpc" else controller.QP
    if args.horizon is not None:
        settings = admm.ADMMSettings(seg_iters=60, segments=3, polish=False)
        warm_settings = admm.ADMMSettings(seg_iters=25, segments=1,
                                          polish=False)
    else:
        settings = admm.ADMMSettings(seg_iters=25, segments=3)
        warm_settings = controller.WARM_SETTINGS
    _, trace = rollout.rollout(
        carry, model, params, args.steps, args.dt, solver_type=solver,
        settings=settings, warm_settings=warm_settings, command_fn=command,
        estimate=not args.no_ekf,
        use_terrain_adapt=static.use_terrain_adapt, horizon=args.horizon)
    # the one robot's trace, (T, ...) leaves as the JAX package's
    trace = type(trace)(*[v[:, 0] for v in trace])
    if args.trace or args.plot:
        from go1_qp_mpc_controller_torch.utils import viz
        title = f"{args.preset} rollout (vx={args.vx}, {args.steps} steps)"
        if args.trace:
            viz.save_trace(args.trace, trace, args.dt)
        if args.plot:
            viz.plot_rollout(viz.load_trace(args.trace) if args.trace
                             else viz.trace_dict(trace, args.dt),
                             args.plot, title=title)
    pos = trace.root_pos.cpu().numpy()
    vel_tr = trace.root_lin_vel.cpu().numpy()
    euler = trace.root_euler.cpu().numpy()
    # the ranges skip the 100 standing ticks; a run as short as the stand
    # reads all of its ticks
    settle = 100 if args.steps > 100 else 0
    print(json.dumps({
        "final_pos": pos[-1].round(4).tolist(),
        "mean_vx": round(float(vel_tr[args.steps // 3:, 0].mean()), 4),
        "height_range": [round(float(pos[settle:, 2].min()), 4),
                         round(float(pos[settle:, 2].max()), 4)],
        "max_tilt_rad": round(float(np.abs(euler[settle:, :2]).max()), 4),
    }))


def cmd_sweep(args, model, params, static, device):
    """Randomized scenarios solved over the (data, mpc) mesh of the
    process group (``main`` joined it): one process is a world of one on
    this card; ``torchrun --nproc_per_node=N`` runs N ranks, a card each.
    Rank 0 prints."""
    import torch
    import torch.distributed as dist

    from go1_qp_mpc_controller_torch.ops import admm
    from go1_qp_mpc_controller_torch.parallel import mesh as mesh_lib
    from go1_qp_mpc_controller_torch.parallel import sweep

    try:
        mesh = mesh_lib.make_mesh(args.mpc_parallel)
        fn = sweep.make_sweep_fn(mesh, float(params.mpc_dt),
                                 admm.ADMMSettings(seg_iters=25, segments=3))
        out = fn(sweep.random_scenarios(args.seed, args.batch,
                                        torch.float32, device))
        if dist.get_rank() == 0:
            print(json.dumps({
                "num_solves": out.stats["num_solves"],
                "max_primal_res": float(out.stats["max_primal_res"]),
                "max_dual_res": float(out.stats["max_dual_res"]),
                "mesh": mesh.shape,
            }))
    finally:
        dist.destroy_process_group()


def joy_demo_source(duration, dt):
    """The scripted operator session of ``--joy-demo``: stand, then walk
    forward at 0.3 of the stick (A + stick) from a quarter of the run, A
    again to stand at half, LB to exit at three quarters; event ticks are
    fast-loop ticks (GazeboA1ROS.cpp:117-188)."""
    import numpy as np

    from go1_qp_mpc_controller_torch.runtime import joystick

    def axes(velx=0.0, a=False, lb=False):
        ax = np.zeros(8, np.float32)
        ax[4] = velx
        bt = np.zeros(5, np.int32)
        bt[0], bt[4] = int(a), int(lb)
        return ax, bt

    t2 = int(duration / dt)
    return joystick.ScriptedJoySource([
        (t2 // 4,) + axes(velx=0.3, a=True),
        (t2 // 2,) + axes(a=True),
        (3 * t2 // 4,) + axes(lb=True),
    ])


def cmd_loop(args, model, params, static, device):
    import torch

    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.runtime import feeder as feeder_lib
    from go1_qp_mpc_controller_torch.runtime import loop as loop_lib

    ctrl = types.init_ctrl_state(model, 1, torch.float32, device)
    source = (joy_demo_source(args.duration, args.dt) if args.joy_demo
              else None)
    cl = loop_lib.ControlLoop(model, params, static, ctrl,
                              main_period_s=args.dt,
                              grf_period_s=args.grf_dt or args.dt,
                              power_level=static.power_level,
                              time_scale=args.time_scale,
                              command_source=source,
                              estimate_in_feed=args.estimate_in_feed,
                              sensor_period_s=args.feed_dt)
    feeder = None
    try:
        if not args.no_feeder:
            # simulated 1 kHz sensor feed (the HardwareA1ROS receive
            # thread's role); the controller starts synced to the plant
            feeder = feeder_lib.SimFeeder(cl.bridge, model, params,
                                          height=args.height,
                                          period_s=args.feed_dt,
                                          time_scale=args.time_scale,
                                          device=device)
            cl.state = feeder.initial_ctrl_state()
            cl.warmup(dual=not args.single)
            feeder.start(duration_s=args.duration + 5.0)
        run = cl.run if args.single else cl.run_dual
        n = run(duration_s=args.duration)
        out = {"ticks": n,
               "grf_ticks": cl.grf_ticks,
               "time_scale": args.time_scale,
               "cycle_ms": cl.metrics.summary("cycle_ms"),
               "grf_ms": cl.metrics.summary("grf_ms")}
        if cl.est_thread is not None:
            out["est_frames"] = cl.est_thread.frames
            out["est_frame_ms"] = cl.metrics.summary("est_frame_ms")
        if feeder is not None:
            feeder.stop()
            if feeder.error is not None:
                raise RuntimeError("the sensor feed failed") \
                    from feeder.error
            out["feeder_ticks"] = feeder.ticks
            # plant CoM: ~[0, 0, height] when the loops keep up; lower
            # --time-scale when the GRF solve outlasts the cadence
            out["plant_root_pos"] = [round(float(v), 4)
                                     for v in feeder.sim_root_pos]
            _, cmd = cl.bridge.read_command()
            out["max_abs_tau"] = round(float(abs(cmd["tau"]).max()), 3)
        print(json.dumps(out))
    finally:
        if feeder is not None:
            feeder.stop()
        cl.close()


def _actor(args, seed, device):
    """The TorchScript actor of ``--weights``, else random weights drawn
    from a ``torch.Generator`` seeded with ``seed``."""
    import torch

    from go1_qp_mpc_controller_torch.models import policy as policy_lib

    if args.weights:
        return policy_lib.load_torchscript_actor(args.weights, device=device)
    # no weights ship with the reference either (resource/*.pt are
    # binary artifacts); random weights still exercise the full loop
    return policy_lib.init_mlp(torch.Generator().manual_seed(seed),
                               device=device)


def cmd_rl(args, model, params, static, device):
    """Closed-loop RL rollout on the PD joint plant (the reference's
    go1_rl_ctrl_cpp MainGazebo process, policy -> position commands)."""
    import numpy as np
    import torch

    from go1_qp_mpc_controller_torch.envs import rollout

    actor = _actor(args, args.seed, device)
    carry = rollout.init_rl_carry(model, 1, height=args.height,
                                  dtype=torch.float32, device=device)
    switch_at = args.switch_step
    walk_cmd = [args.vx, args.vy, 0.0]
    _, trace = rollout.rl_rollout(
        carry, model, actor, args.steps, args.dt,
        command_fn=lambda i: walk_cmd if i >= switch_at else [0.0] * 3,
        toggle_fn=lambda i: i == switch_at)
    obs = trace.obs[:, 0].cpu().numpy()
    q = trace.target_q[:, 0].cpu().numpy()
    print(json.dumps({
        "steps": args.steps,
        "finite": bool(np.isfinite(obs).all() and np.isfinite(q).all()),
        "obs_max_abs": round(float(np.abs(obs).max()), 3),
        "target_q_range": [round(float(q.min()), 3),
                           round(float(q.max()), 3)],
        "mode_tail": int(trace.movement_mode[-1, 0]),
        "final_root_pos": [round(float(v), 4)
                           for v in trace.root_pos[-1, 0].cpu().numpy()],
    }))


def cmd_rl_loop(args, model, params, static, device):
    """RL host loop over the RT bridge against the sim feeder: the
    hardware-mirror RL process (Go1RLHardwareController + estimation
    thread + servo stand)."""
    from go1_qp_mpc_controller_torch.config import presets
    from go1_qp_mpc_controller_torch.runtime import feeder as feeder_lib
    from go1_qp_mpc_controller_torch.runtime import rl_loop as rl_loop_lib

    rl_cfg = presets.load_rl_preset(args.rl_preset)
    loop = rl_loop_lib.RLControlLoop(
        model, _actor(args, 0, device), action_period_s=rl_cfg.action_period,
        power_level=rl_cfg.power_level, hardware=not rl_cfg.use_sim_time,
        contact_force_norm=rl_cfg.contact_force_norm,
        time_scale=args.time_scale, servo_only=args.servo_only)
    feeder = None
    try:
        loop.warmup()
        feeder = feeder_lib.SimFeeder(loop.bridge, model, params,
                                      height=args.height,
                                      period_s=rl_cfg.deploy_period,
                                      time_scale=args.time_scale,
                                      device=device)
        feeder.start(duration_s=args.duration + 5.0)
        n = loop.run(duration_s=args.duration)
        feeder.stop()
        if feeder.error is not None:
            raise RuntimeError("the sensor feed failed") from feeder.error
        _, cmd = loop.bridge.read_command()
        print(json.dumps({
            "ticks": n,
            "feeder_ticks": feeder.ticks,
            "mode": int(loop.rl_state.movement_mode[0]),
            "root_pos": [round(float(v), 4)
                         for v in feeder.sim_root_pos],
            "kp_head": [round(float(v), 1) for v in cmd["kp"][:3]],
        }))
    finally:
        if feeder is not None:
            feeder.stop()
        loop.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="gazebo_mpc")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    sub = parser.add_subparsers(dest="mode", required=True)

    p = sub.add_parser("rollout")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--dt", type=float, default=0.002)
    p.add_argument("--vx", type=float, default=0.3)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--height", type=float, default=0.3)
    p.add_argument("--no-ekf", action="store_true")
    p.add_argument("--horizon", type=int, default=None,
                   help="MPC horizon; values != 10 route the GRF solve "
                        "to the stagewise O(H) solver")
    p.add_argument("--trace", default=None, metavar="OUT.npz",
                   help="save the rollout trace (utils/viz.py)")
    p.add_argument("--plot", default=None, metavar="OUT.png",
                   help="render the gait-health figure (needs matplotlib)")
    p.set_defaults(fn=cmd_rollout)

    p = sub.add_parser("sweep")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mpc-parallel", type=int, default=1,
                   help="size of the mesh's mpc axis (must divide the "
                        "number of ranks)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("loop")
    p.add_argument("--dt", type=float, default=0.002)
    p.add_argument("--grf-dt", type=float, default=None,
                   help="GRF solver cadence (default: --dt)")
    p.add_argument("--feed-dt", type=float, default=0.001,
                   help="sim sensor-feed cadence (reference: 1 ms)")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--height", type=float, default=0.3)
    p.add_argument("--time-scale", type=float, default=0.25,
                   help="real-time factor (Gazebo RTF analog): wall "
                        "periods = sim periods / time_scale; lower it "
                        "when the GRF solve outlasts the cadence")
    p.add_argument("--joy-demo", action="store_true",
                   help="drive a scripted joystick session (stand -> "
                        "walk -> stand -> LB exit) through the loop")
    p.add_argument("--estimate-in-feed", action="store_true",
                   help="run the EKF in a dedicated thread at the "
                        "sensor cadence (HardwareA1ROS receive-thread "
                        "estimation) instead of inside the fast step")
    p.add_argument("--no-feeder", action="store_true",
                   help="run against an externally fed bridge")
    p.add_argument("--single", action="store_true",
                   help="fused single-cadence loop")
    p.set_defaults(fn=cmd_loop)

    p = sub.add_parser("rl-loop")
    p.add_argument("--rl-preset", default="rl_gazebo",
                   help="rl_gazebo | rl_hardware (RL-stack config)")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--height", type=float, default=0.3)
    p.add_argument("--time-scale", type=float, default=0.25)
    p.add_argument("--servo-only", action="store_true",
                   help="standalone servo stand process "
                        "(servo_stand_policy parity)")
    p.add_argument("--weights", default=None,
                   help="TorchScript actor .pt (random weights from a "
                        "torch.Generator seeded with 0 if unset)")
    p.set_defaults(fn=cmd_rl_loop)

    p = sub.add_parser("rl")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--dt", type=float, default=0.004)
    p.add_argument("--vx", type=float, default=0.3)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--height", type=float, default=0.3)
    p.add_argument("--switch-step", type=int, default=400,
                   help="A-button press: servo-stand -> walk policy")
    p.add_argument("--weights", default=None,
                   help="TorchScript actor .pt (random weights if unset)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random actor's torch.Generator; its "
                        "draws differ from the JAX package's jax.random "
                        "draws for the same seed")
    p.set_defaults(fn=cmd_rl)

    args = parser.parse_args(argv)

    import torch

    from go1_qp_mpc_controller_torch.config import presets
    from go1_qp_mpc_controller_torch.utils.device import resolve_device
    if args.fn is cmd_sweep:
        # a rank joins the group, and takes its card, before anything
        # touches a card
        from go1_qp_mpc_controller_torch.parallel import mesh as mesh_lib
        device = mesh_lib.init_distributed(args.device)
    else:
        device = resolve_device(args.device)
    model, params, static = presets.load_preset(args.preset, torch.float32,
                                                device=device)
    args.fn(args, model, params, static, device)


if __name__ == "__main__":
    main()
