"""Checkpoint/resume for long batched sweeps.

Port of the JAX package's ``utils/checkpoint.py``. The reference has no
checkpointing (SURVEY.md section 5: the only persisted artifacts are policy
weights and recorded signals); sweep state (scenario batches, partial
results, controller states) round-trips here through ``torch.save`` /
``torch.load(weights_only=True)`` in place of Orbax: one file a tree, its
tensors stored as ``leaf_<i>`` in flattening order.
"""

import os

import torch
from torch.utils import _pytree as pytree


def save_pytree(path, tree, force=True):
    """Save the tensors of ``tree`` (nested NamedTuples, lists, dicts) to
    the file ``path``; with ``force=False`` an existing file raises."""
    if not force and os.path.exists(path):
        raise FileExistsError(f"{path} exists (pass force=True)")
    leaves, _ = pytree.tree_flatten(tree)
    torch.save({f"leaf_{i}": leaf.detach().cpu()
                for i, leaf in enumerate(leaves)}, path)


def restore_pytree(path, like):
    """Restore into the structure of ``like``: the same tree, each tensor
    of the same shape and dtype, on the device of ``like``'s tensor."""
    leaves, spec = pytree.tree_flatten(like)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if len(saved) != len(leaves):
        raise ValueError(f"{path} holds {len(saved)} tensors, the tree "
                         f"{len(leaves)}")
    out = []
    for i, ref in enumerate(leaves):
        t = saved[f"leaf_{i}"]
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{path} leaf {i}: {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(ref.shape)} {ref.dtype}")
        out.append(t.to(ref.device))
    return pytree.tree_unflatten(out, spec)
