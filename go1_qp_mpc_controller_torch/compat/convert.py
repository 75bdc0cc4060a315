"""State carry between NumPy data and the port's containers.

``from_numpy`` builds one of the port's ``NamedTuple`` containers (nested
ones included, e.g. the ``MovingWindowState`` filters inside a
``CtrlState``) from a mapping or NamedTuple of arrays — for instance the
JAX package's state after ``jax.tree.map(np.asarray, x)``, which keeps
the same field names: a ``CtrlState``, or the solver's ``CondensedQP``,
``WarmState`` and ``BalanceQP`` (batched: a leading batch axis on every
leaf). ``to_numpy`` goes the other way, to nested dicts of
arrays, so that another implementation can compute on the same state.
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
