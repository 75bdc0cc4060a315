"""Rollout visualization: the RViz-marker / PlotJuggler stand-in.

Port of the JAX package's ``utils/viz.py``; the npz holds the same keys
(the fields of ``envs.rollout.RolloutTrace`` of one robot, (T, ...)
each, plus ``dt``), with tensors moved to numpy. matplotlib is imported
by :func:`plot_rollout` alone, so ``--trace`` works without it.

The reference publishes per-foot start/end/path markers into RViz
(A1RobotControl.cpp:65-146) and ships PlotJuggler signal layouts
(go1_rl_ctrl_cpp/config/xml/) so a human can SEE a run. This module
renders the same gait-health picture from a saved RolloutTrace
(``main.py rollout --trace out.npz [--plot out.png]``):

- CoM path (top-down) with the estimator's track overlaid,
- body height + terrain-pitch timelines,
- world-frame foot swing trajectories (x-z side view),
- per-leg vertical GRF timelines with contact-phase shading.

One command produces a figure a human can eyeball for gait health:

  python -m go1_qp_mpc_controller_torch.utils.viz out.npz out.png

Colors follow a fixed colorblind-validated categorical order per leg
(never cycled), one axis per panel, recessive grids.
"""

import sys

import numpy as np

# Fixed categorical order (validated palette; legs always map to the
# same hue: FL blue, FR orange, RL aqua, RR yellow).
LEG_COLORS = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100")
LEG_NAMES = ("FL", "FR", "RL", "RR")
INK = "#3d3d3a"
MUTED = "#73726c"


def trace_dict(trace, dt):
    """A RolloutTrace (or any NamedTuple of tensors or arrays, on any
    device) as the dict :func:`load_trace` returns: numpy leaves plus
    ``dt``."""
    out = {k: v.detach().cpu().numpy() if hasattr(v, "detach")
           else np.asarray(v) for k, v in trace._asdict().items()}
    out["dt"] = np.asarray(float(dt))
    return out


def save_trace(path, trace, dt):
    """Save a RolloutTrace (or any NamedTuple of tensors or arrays) plus
    dt to npz."""
    np.savez_compressed(path, **trace_dict(trace, dt))


def load_trace(path):
    """npz -> dict of numpy arrays (incl. 'dt' scalar)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _style(ax, title, xlabel, ylabel):
    ax.set_title(title, fontsize=10, color=INK, loc="left")
    ax.set_xlabel(xlabel, fontsize=8, color=MUTED)
    ax.set_ylabel(ylabel, fontsize=8, color=MUTED)
    ax.grid(True, linewidth=0.4, alpha=0.35)
    ax.tick_params(labelsize=7, colors=MUTED)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(MUTED)


def plot_rollout(trace, out_path, title=None):
    """Render the gait-health figure from a trace dict (see load_trace).

    Args:
      trace: dict with root_pos (T,3), est_root_pos, foot_pos_abs
        (T,4,3), foot_forces_grf (T,4,3), contacts (T,4), terrain_pitch
        (T,), dt ().
      out_path: output image path (png/svg by extension).
    """
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plot_rollout needs matplotlib, which is not "
                          "installed; --trace writes the npz without it") \
            from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    root = np.asarray(trace["root_pos"], float)         # (T, 3)
    est = np.asarray(trace.get("est_root_pos", root), float)
    feet_rel = np.asarray(trace["foot_pos_abs"], float)  # (T, 4, 3)
    feet_w = root[:, None, :] + feet_rel                 # world frame
    grf = np.asarray(trace["foot_forces_grf"], float)
    contacts = np.asarray(trace["contacts"], bool)
    pitch = np.asarray(trace.get("terrain_pitch",
                                 np.zeros(len(root))), float)
    dt = float(np.asarray(trace.get("dt", 0.002)))
    t = np.arange(len(root)) * dt

    fig = plt.figure(figsize=(11, 8.6), dpi=130)
    fig.patch.set_facecolor("white")
    gs = fig.add_gridspec(3, 2, height_ratios=(1.0, 1.0, 0.45))
    axes = [[fig.add_subplot(gs[0, 0]), fig.add_subplot(gs[0, 1])],
            [fig.add_subplot(gs[1, 0]), fig.add_subplot(gs[1, 1])]]
    ax_pitch = fig.add_subplot(gs[2, :])
    if title:
        fig.suptitle(title, fontsize=11, color=INK)

    # --- CoM path, top-down (plant truth + estimator track) ----------
    ax = axes[0][0]
    ax.plot(root[:, 0], root[:, 1], color=INK, linewidth=1.6,
            label="CoM (plant)")
    ax.plot(est[:, 0], est[:, 1], color=MUTED, linewidth=1.0,
            linestyle="--", label="CoM (estimator)")
    ax.plot(root[0, 0], root[0, 1], "o", color=INK, markersize=5)
    for leg in range(4):
        stance = contacts[:, leg]
        ax.scatter(feet_w[stance, leg, 0], feet_w[stance, leg, 1],
                   s=1.5, color=LEG_COLORS[leg], alpha=0.25)
    _style(ax, "CoM path (top-down; dots = stance feet)", "x [m]",
           "y [m]")
    ax.axis("equal")
    ax.legend(fontsize=7, frameon=False, loc="best")

    # --- body height (one axis; pitch gets its own panel below) ------
    ax = axes[0][1]
    ax.plot(t, root[:, 2], color=INK, linewidth=1.4, label="height")
    ax.plot(t, est[:, 2], color=MUTED, linewidth=0.9, linestyle="--",
            label="height (est)")
    _style(ax, "body height", "t [s]", "z [m]")
    ax.legend(fontsize=7, frameon=False, loc="lower right")

    # --- foot swing trajectories, x-z side view (RViz paths) ---------
    ax = axes[1][0]
    for leg in range(4):
        ax.plot(feet_w[:, leg, 0], feet_w[:, leg, 2],
                color=LEG_COLORS[leg], linewidth=1.0,
                label=LEG_NAMES[leg])
        # swing apexes: mark lift-off -> touch-down extremes
    ax.plot(root[:, 0], root[:, 2], color=INK, linewidth=0.8,
            linestyle=":", label="CoM")
    _style(ax, "foot paths, side view (world frame)", "x [m]", "z [m]")
    ax.legend(fontsize=7, frameon=False, ncol=5, loc="upper left")

    # --- per-leg vertical GRF with contact shading -------------------
    ax = axes[1][1]
    for leg in range(4):
        ax.plot(t, grf[:, leg, 2], color=LEG_COLORS[leg], linewidth=0.9,
                label=LEG_NAMES[leg])
    # shade FL stance phases to show the gait rhythm without repainting
    on = np.flatnonzero(np.diff(contacts[:, 0].astype(int)) == 1) + 1
    off = np.flatnonzero(np.diff(contacts[:, 0].astype(int)) == -1) + 1
    if contacts[0, 0]:
        on = np.r_[0, on]
    for a, b in zip(on, list(off) + [len(t) - 1]):
        if b > a:
            ax.axvspan(t[a], t[min(b, len(t) - 1)], color=LEG_COLORS[0],
                       alpha=0.06, linewidth=0)
    _style(ax, "vertical GRF per leg (shading = FL stance)", "t [s]",
           "fz [N]")
    ax.legend(fontsize=7, frameon=False, ncol=4, loc="upper right")

    # --- terrain pitch (own panel, own unit) -------------------------
    ax_pitch.plot(t, np.degrees(pitch), color=INK, linewidth=1.0)
    _style(ax_pitch, "estimated terrain pitch", "t [s]", "pitch [deg]")

    fig.tight_layout(rect=(0, 0, 1, 0.97 if title else 1.0))
    fig.savefig(out_path, facecolor="white")
    plt.close(fig)
    return out_path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("usage: python -m go1_qp_mpc_controller_torch.utils.viz "
              "trace.npz [out.png]")
        return 2
    npz = argv[0]
    out = argv[1] if len(argv) > 1 else npz.rsplit(".", 1)[0] + ".png"
    plot_rollout(load_trace(npz), out, title=npz)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
