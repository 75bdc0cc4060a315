"""The reference is a frozen copy of the port's plain path: it imports
nothing of the program, and at a tiny size on the CPU it computes what the
port's plain path computes."""

import ast
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in (
                    "go1_qp_mpc_controller_torch", "go1_qp_mpc_controller_tpu",
                    "jax", "jaxlib", "flax"), (path, name)


def test_reference_tick_agrees_with_the_port_on_the_cpu(tiny_root):
    from go1_qp_mpc_controller_torch.config import presets
    from go1_qp_mpc_controller_torch.envs import rollout
    from go1_qp_mpc_controller_torch.ops import admm
    from reference import check
    from reference.go1.envs import rollout as rrollout
    from reference.go1.ops import admm as radmm

    f32 = torch.float32
    model, params, static = presets.load_preset("gazebo_mpc", f32,
                                                device="cpu")
    carry = rollout.init_carry(model, params, 4, dtype=f32, device="cpu")
    ctrl = carry.ctrl._replace(
        movement_mode=torch.ones_like(carry.ctrl.movement_mode),
        root_lin_vel_d=torch.tensor([[0.2, 0.0, 0.0]]).expand(4, 3).clone())
    carry = carry._replace(ctrl=ctrl)
    cold = dict(seg_iters=30, segments=2, polish=False)
    carry, _ = rollout.rollout_batched(carry, model, params, 45, 0.002,
                                       settings=admm.ADMMSettings(**cold))
    prog, _ = rollout.rollout_batched(carry, model, params, 1, 0.002,
                                      settings=admm.ADMMSettings(**cold))
    rm, rp, _ = presets_f32 = check.presets.load_preset("gazebo_mpc", f32,
                                                        device="cpu")
    del presets_f32
    ref, _ = rrollout.rollout_batched(check.carry_of(carry, f32, "cpu"), rm,
                                      rp, 1, 0.002,
                                      settings=radmm.ADMMSettings(**cold))
    for a, b in zip(prog.ctrl, ref.ctrl):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for a, b in zip(prog.sim, ref.sim):
        assert torch.equal(a, b)
