"""Fixed-shape steps replayed as CUDA graphs.

At batch 1 a runtime step is hundreds of tiny operations, each dispatched
from Python; the host loop's four threads share one GIL, so that dispatch,
not the card, sets their speed. ``CapturedStep`` records such a step once
and replays it with one call, the port's counterpart of the JAX loop's
jitted steps. Only steps that launch none of the counted kernels may be
captured (a replay would launch a kernel without its wrapper counting it):
the constructor raises if its warm-up or its capture moved a kernel
wrapper's launch counter.
"""

import torch
from torch.utils import _pytree as pytree


def launch_counts():
    """{kernel: launches} of every kernel wrapper."""
    from go1_qp_mpc_controller_torch.ops import _build
    return {name: module.launches
            for name, module in _build.wrappers().items()}


class CapturedStep:
    """``fn(*args)`` recorded as a CUDA graph and replayed on each call.

    ``args`` are (nested NamedTuples of) tensors of fixed shapes; Python
    numbers ``fn`` needs are closed over. Each call copies the arguments
    into the graph's input buffers (one ``_foreach_copy_``) and replays on
    the calling thread's current stream. The outputs are the graph's own
    buffers, overwritten by the next call: the caller copies what it keeps.
    Capture the step before other threads issue work on the card. On the
    CPU (no graphs) a call is ``fn(*args)``.
    """

    def __init__(self, fn, *example_args, warmup=2):
        self.fn = fn
        self.graph = None
        flat, self._spec = pytree.tree_flatten(example_args)
        device = flat[0].device
        if device.type != "cuda":
            return
        before = launch_counts()
        self._inputs = [t.clone() for t in flat]
        args = pytree.tree_unflatten(self._inputs, self._spec)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(warmup):         # lazy initializations first
                fn(*args)
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._outputs = fn(*args)
        moved = {k: n - before[k] for k, n in launch_counts().items()
                 if n != before[k]}
        if moved:
            raise RuntimeError(f"CapturedStep: the step launched counted "
                               f"kernels {moved}; a replay would launch "
                               f"them uncounted")

    def __call__(self, *args):
        if self.graph is None:
            return self.fn(*args)
        flat, spec = pytree.tree_flatten(args)
        if spec != self._spec:
            raise ValueError("CapturedStep: the arguments' structure differs "
                             "from the captured one")
        torch._foreach_copy_(self._inputs, flat)
        self.graph.replay()
        return self._outputs


def clone(tree):
    """A copy of every tensor of ``tree`` (nested NamedTuples)."""
    return pytree.tree_map(torch.clone, tree)
