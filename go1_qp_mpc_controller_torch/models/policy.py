"""RL policy network: the MLP actor.

Port of the JAX package's ``models/policy.py`` (the reference's
libtorch/TorchScript inference path,
src/go1_rl_ctrl_cpp/src/torch_eigen/TorchEigen.cpp:4-32). The actor is
the rsl_rl architecture of the reference's debug harness
(src/pytorch_debug/rl_policy_module.py:17-29): obs 48 -> [512, 256, 128]
-> 12 with ELU activations, one ``nn.Linear`` a layer. It batches over
its leading axes. The JAX package computes it as a plain ``x @ w + b``
outside any Pallas kernel, so it has no kernel here either: it runs as
PyTorch's products, in true float32 under
``utils/device.py::pin_f32_matmuls``.
"""

import torch
from torch import nn

from go1_qp_mpc_controller_torch.utils.device import resolve_device

ACTOR_HIDDEN_DIMS = (512, 256, 128)
OBS_DIM = 48
ACTION_DIM = 12


class ActorMLP(nn.Module):
    """ELU hidden layers and a linear output over ``dims`` = (obs,
    *hidden, action)."""

    def __init__(self, dims=(OBS_DIM,) + ACTOR_HIDDEN_DIMS + (ACTION_DIM,),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], dtype=dtype, device=device)
            for i in range(len(dims) - 1))

    def forward(self, obs):
        """(..., obs_dim) -> (..., action_dim) unclipped actions."""
        x = obs
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = nn.functional.elu(x)
        return x


def init_mlp(generator, obs_dim=OBS_DIM, hidden=ACTOR_HIDDEN_DIMS,
             action_dim=ACTION_DIM, dtype=torch.float32, device=None):
    """An actor with the JAX package's init: each weight a standard normal
    draw times sqrt(2 / fan_in), zero biases (rsl_rl's scaled-normal
    default). The draws come from ``generator`` (a CPU
    ``torch.Generator``) and differ from ``jax.random``'s for the same
    seed. ``device=None`` places the actor on the CUDA card."""
    device = resolve_device(device)
    dims = (obs_dim,) + tuple(hidden) + (action_dim,)
    actor = ActorMLP(dims, dtype, device)
    with torch.no_grad():
        for i, layer in enumerate(actor.layers):
            w = torch.randn((dims[i + 1], dims[i]), generator=generator,
                            dtype=torch.float64)
            layer.weight.copy_(w * (2.0 / dims[i]) ** 0.5)
            layer.bias.zero_()
    return actor.requires_grad_(False)


def mlp_apply(actor, obs):
    """Actor forward pass: (..., obs_dim) -> (..., action_dim)."""
    return actor(obs)


def load_torchscript_actor(path, dtype=torch.float32, device=None):
    """An :class:`ActorMLP` from a TorchScript actor .pt (the reference's
    resource files, Go1RLController.cpp:66-76).

    Walks the scripted module's parameters in order and pairs them as
    (weight, bias) per Linear layer; ``nn.Linear`` keeps torch's (out, in)
    layout, so nothing is transposed.
    """
    device = resolve_device(device)
    module = torch.jit.load(path, map_location="cpu")
    module.eval()
    ws, bs = [], []
    for p in module.parameters():
        if p.ndim == 2:
            ws.append(p.detach())
        elif p.ndim == 1:
            bs.append(p.detach())
    if len(ws) != len(bs):
        raise ValueError(
            f"unpaired weights/biases in {path}: {len(ws)} vs {len(bs)}")
    dims = tuple(w.shape[1] for w in ws) + (ws[-1].shape[0],)
    actor = ActorMLP(dims, dtype, device)
    with torch.no_grad():
        for layer, w, b in zip(actor.layers, ws, bs):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    return actor.requires_grad_(False)
