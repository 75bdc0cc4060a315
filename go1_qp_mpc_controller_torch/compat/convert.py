"""State carry between NumPy data and the port's containers.

``from_numpy`` builds one of the port's ``NamedTuple`` containers (nested
ones included, e.g. the ``MovingWindowState`` filters inside a
``CtrlState``) from a mapping or NamedTuple of arrays — for instance the
JAX package's state after ``jax.tree.map(np.asarray, x)``, which keeps
the same field names: a ``CtrlState``, or the solver's ``CondensedQP``,
``WarmState`` and ``BalanceQP`` (batched: a leading batch axis on every
leaf). ``to_numpy`` goes the other way, to nested dicts of
arrays, so that another implementation can compute on the same state.
``actor_from_numpy`` carries the JAX package's actor weights
(``models/policy.MLPParams``) across into an ``ActorMLP``.
"""

import numpy as np
import torch


def _is_container(cls):
    return isinstance(cls, type) and hasattr(cls, "_fields")


def _as_mapping(data):
    return data._asdict() if hasattr(data, "_asdict") else data


def from_numpy(cls, data, device, dtype=torch.float32):
    """Build ``cls`` from a mapping (or NamedTuple) of arrays.

    Floating arrays become ``dtype``, booleans stay bool and integers
    become int32 (the JAX package's counter type).
    """
    data = _as_mapping(data)
    fields = {}
    for name in cls._fields:
        kind = cls.__annotations__.get(name)
        value = data[name]
        if _is_container(kind):
            fields[name] = from_numpy(kind, value, device, dtype)
            continue
        arr = np.asarray(value)
        if arr.dtype.kind == "f":
            t_dtype = dtype
        elif arr.dtype.kind == "b":
            t_dtype = torch.bool
        else:
            t_dtype = torch.int32
        fields[name] = torch.tensor(arr).to(device=device, dtype=t_dtype)
    return cls(**fields)


def to_numpy(obj):
    """Nested dicts of NumPy arrays from a port container (or tensor)."""
    if hasattr(obj, "_fields"):
        return {name: to_numpy(getattr(obj, name)) for name in obj._fields}
    return obj.detach().cpu().numpy()


def actor_from_numpy(params, device, dtype=torch.float32):
    """An ``models/policy.ActorMLP`` from the JAX package's ``MLPParams``
    as arrays (``weights``: (in, out) matrices, ``biases``: (out,)
    vectors), or a mapping with those two keys. ``nn.Linear`` stores
    (out, in), so each weight is transposed."""
    from go1_qp_mpc_controller_torch.models import policy

    params = _as_mapping(params)
    ws = [np.asarray(w) for w in params["weights"]]
    bs = [np.asarray(b) for b in params["biases"]]
    dims = tuple(w.shape[0] for w in ws) + (ws[-1].shape[1],)
    actor = policy.ActorMLP(dims, dtype, device)
    with torch.no_grad():
        for layer, w, b in zip(actor.layers, ws, bs):
            layer.weight.copy_(torch.tensor(w.T))
            layer.bias.copy_(torch.tensor(b))
    return actor.requires_grad_(False)
