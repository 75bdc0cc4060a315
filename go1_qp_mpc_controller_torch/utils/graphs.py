"""Fixed-shape steps replayed as CUDA graphs.

At batch 1 a controller step is hundreds of tiny operations, each
dispatched from Python; the host loop's four threads share one GIL, so
that dispatch, not the card, sets their speed. ``CapturedStep`` records
such a step once and replays it with one call, the port's counterpart of
the JAX package's jitted steps; ``RoutedStep`` is the counterpart of a
``lax.switch`` (and a ``lax.cond`` after it): a captured step that
computes a route code, one host read of it, and one captured step per
branch (:class:`StepParts` describes the parts, :func:`route` is the
routing rule that both the captured and the plain composition follow).

A step may launch the counted kernels (``ops/_build.KERNELS``). Capturing
launches nothing, so the capture's moves of the wrappers' ``launches`` and
``route_launches`` counters are taken back, and every replay adds them
again: the counters keep counting real launches. The eager warm-up runs
before a capture are real launches and stay counted; they are also
summed in :data:`warmup_launches`, and the replays' in
:data:`replayed_launches`, so that a caller can tell them apart.
"""

import gc
import threading
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

# launches made by the warm-up runs of every capture, and by the graph
# replays, since the last reset, as :func:`count_delta` gives them
# ({kernel: (n, {route: n})})
warmup_launches = {}
replayed_launches = {}
replays = 0                       # graph replays since the process began
_count_lock = threading.Lock()    # the host loop's threads replay steps
_modules = {}                     # counters(), once imported


def reset_records():
    """:data:`warmup_launches` and :data:`replayed_launches` to empty."""
    warmup_launches.clear()
    replayed_launches.clear()


def counters():
    """{kernel: its wrapper module}, each with a ``launches`` counter and,
    for some, ``route_launches`` ({route: launches})."""
    if not _modules:
        from go1_qp_mpc_controller_torch.ops import _build
        _modules.update(_build.wrappers())
    return _modules


def snapshot(modules):
    """{kernel: (launches, {route: launches})} of ``modules``."""
    return {name: (m.launches, dict(getattr(m, "route_launches", {})))
            for name, m in modules.items()}


def count_delta(before, after):
    """What moved between two :func:`snapshot`s: {kernel: (n, {route:
    n})}, only the kernels and routes that moved."""
    out = {}
    for name, (n, routes) in after.items():
        n0, routes0 = before[name]
        moved = {r: c - routes0.get(r, 0) for r, c in routes.items()
                 if c != routes0.get(r, 0)}
        if n != n0 or moved:
            out[name] = (n - n0, moved)
    return out


def add_counts(modules, delta, sign=1):
    """Add ``sign`` times ``delta`` (:func:`count_delta`) to the counters
    of ``modules``."""
    with _count_lock:
        _add(modules, delta, sign)


def _add(modules, delta, sign=1):
    for name, (n, routes) in delta.items():
        module = modules[name]
        module.launches += sign * n
        for r, c in routes.items():
            module.route_launches[r] += sign * c


def merge_counts(total, delta):
    """Add ``delta`` into the {kernel: (n, {route: n})} dict ``total``."""
    for name, (n, routes) in delta.items():
        n0, routes0 = total.get(name, (0, {}))
        merged = dict(routes0)
        for r, c in routes.items():
            merged[r] = merged.get(r, 0) + c
        total[name] = (n0 + n, merged)
    return total


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


def _flatten(tree, leaves, shape):
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
    elif isinstance(tree, (tuple, list)):
        shape.append((type(tree), len(tree)))
        for item in tree:
            _flatten(item, leaves, shape)
    else:
        raise TypeError(f"a {type(tree).__name__} in a tree of tensors")


def flatten(tree):
    """(the tensors of ``tree``, its structure): ``tree`` nests tuples,
    NamedTuples and lists of tensors; the structure lists each
    container's type and length in depth-first order, so two trees with
    equal structures differ only in their tensors. A few times quicker
    than ``torch.utils._pytree`` on a step's arguments."""
    leaves, shape = [], []
    _flatten(tree, leaves, shape)
    return leaves, tuple(shape)


def _rebuild(tree, items):
    """``tree`` with its tensors replaced, in order, from ``items``."""
    if isinstance(tree, torch.Tensor):
        return next(items)
    parts = [_rebuild(item, items) for item in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(
        parts)


class StepParts(NamedTuple):
    """A fixed-shape step in parts, the counterpart of a jitted
    ``lax.switch`` followed by a ``lax.cond``; :func:`make_step` captures
    them, :func:`compose` runs them plainly:

    - ``pre(*args)`` -> (mid, route code), or None when the step does not
      route (then ``branches`` holds its one part, ``fn(*args)``);
    - ``read(code)``: the host read that names the branch;
    - ``branches`` {key: fn(*args, mid) -> (outputs..., flag)};
    - ``recheck`` {key: key}: a branch whose flag (its last output) takes
      one more host read, and the branch that runs when it is set.
    """
    pre: object
    branches: dict
    read: object = None
    recheck: dict = {}


def route(read, recheck, run, code):
    """The host side of a routed step: ``run`` the branch ``read(code)``
    names; when ``recheck`` names a further branch for it and the branch's
    flag (its last output) is set, run that one too. Returns (the keys
    run, the last one's outputs)."""
    key = read(code)
    out = run(key)
    again = recheck.get(key)
    if again is None or not bool(out[-1].any()):    # the flag's host read
        return [key], out
    return [key, again], run(again)


def compose(parts, *args):
    """The plain composition of :class:`StepParts` on ``args``, what
    :func:`make_step` replays: (the keys run, the outputs)."""
    if parts.pre is None:
        (key, fn), = parts.branches.items()
        return [key], fn(*args)
    mid, code = parts.pre(*args)
    return route(parts.read, parts.recheck,
                 lambda key: parts.branches[key](*args, mid), code)


def make_step(parts, *example_args):
    """:class:`StepParts` captured on ``example_args``: a
    :class:`CapturedStep` of an unrouted step's one part, else a
    :class:`RoutedStep` (on the CPU, their plain composition)."""
    if parts.pre is None:
        (fn,) = parts.branches.values()
        return CapturedStep(fn, *example_args)
    return RoutedStep(parts, *example_args)


def _capture(body, device, shared, warmup=2):
    """``body()`` recorded as a CUDA graph after ``warmup`` eager runs (on a
    side stream; their launches stay counted and are summed in
    :data:`warmup_launches`). An output sharing memory with one of the
    ``shared`` storages is copied inside the graph. Returns (graph, its
    outputs, the launches each replay makes); a capture that fails
    raises."""
    modules = counters()

    def run():
        leaves, spec = pytree.tree_flatten(body())
        aliased = [i for i, t in enumerate(leaves)
                   if isinstance(t, torch.Tensor)
                   and t.untyped_storage().data_ptr() in shared]
        for i, copy in zip(aliased, clone([leaves[i] for i in aliased])):
            leaves[i] = copy
        return pytree.tree_unflatten(leaves, spec)

    before = snapshot(modules)
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(warmup):             # lazy initializations first
            run()
    current.wait_stream(side)
    warmed = snapshot(modules)
    with _count_lock:
        merge_counts(warmup_launches, count_delta(before, warmed))
    graph = torch.cuda.CUDAGraph()
    # cuBLAS keeps one workspace per (handle, stream) and would give every
    # graph captured on the shared capture stream the same one: graphs
    # replayed at once on the loops' streams then corrupt each other's.
    # Emptied before and after, the capture allocates its own in its
    # private pool
    torch.cuda.synchronize(device)
    torch._C._cuda_clearCublasWorkspaces()
    # no collection of garbage inside the capture (a CUDA object freed
    # there would end it), and only this thread's calls can end it (the
    # capture still comes before the loops' threads start)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = run()
    finally:
        if collecting:
            gc.enable()
    torch._C._cuda_clearCublasWorkspaces()
    launches = count_delta(warmed, snapshot(modules))
    add_counts(modules, launches, -1)       # the capture launched none
    return graph, outputs, launches


def _replay(graph, launches, warming=False):
    """Replay ``graph`` and add its ``launches`` to the wrappers' counters
    and to :data:`replayed_launches` (with ``warming``, to
    :data:`warmup_launches`)."""
    graph.replay()
    global replays
    with _count_lock:
        if launches:
            _add(counters(), launches)
            merge_counts(warmup_launches if warming else replayed_launches,
                         launches)
        if not warming:
            replays += 1


class CapturedStep:
    """``fn(*args)`` recorded as a CUDA graph and replayed on each call.

    ``args`` are (nested NamedTuples of) tensors of fixed shapes; Python
    numbers ``fn`` needs are closed over. Each call copies the arguments
    into the graph's input buffers (one ``_foreach_copy_``) and replays on
    the calling thread's current stream. The outputs are the graph's own
    buffers, overwritten by the next call: the caller copies what it keeps.
    An output that would share memory with an input buffer is copied
    inside the graph, so that the outputs can go back in as the next
    call's arguments. Each replay adds the step's kernel launches to the
    wrappers' counters.
    Capture the step before other threads issue work on the card; a
    capture that fails raises. On the CPU (no graphs) a call is
    ``fn(*args)``.
    """

    def __init__(self, fn, *example_args, warmup=2):
        self.fn = fn
        self.graph = None
        self.launches = {}
        flat, self._shape = flatten(example_args)
        device = flat[0].device
        if device.type != "cuda":
            return
        self._inputs = [t.clone() for t in flat]
        args = _rebuild(example_args, iter(self._inputs))
        self.graph, self._outputs, self.launches = _capture(
            lambda: fn(*args), device, _storages(self._inputs), warmup)

    def __call__(self, *args):
        if self.graph is None:
            return self.fn(*args)
        return self._run(args)

    def _run(self, args, warming=False):
        """Copy ``args`` in and replay."""
        flat, shape = flatten(args)
        if shape != self._shape:
            raise ValueError("CapturedStep: the arguments' structure "
                             "differs from the captured one")
        torch._foreach_copy_(self._inputs, flat)
        _replay(self.graph, self.launches, warming)
        return self._outputs


class RoutedStep:
    """:class:`StepParts` as captured steps: ``pre`` -> one host read of
    its route code -> one captured branch -> the flag's host read and the
    ``recheck`` branch where the parts ask for it (:func:`route`).

    ``pre`` is a :class:`CapturedStep`; every branch is captured at
    construction, on the example arguments' ``mid`` whatever its route,
    reading pre's own buffers (nothing is copied between them).
    :meth:`run` replays a branch on the last call's ``mid``. On the CPU a
    call is the plain composition (:func:`compose`).
    """

    def __init__(self, parts, *example_args):
        self.parts = parts
        self.pre = CapturedStep(parts.pre, *example_args)
        self._last = None
        self._graphs = None
        if self.pre.graph is None:
            return
        args = _rebuild(example_args, iter(self.pre._inputs))
        # pre's buffers hold real data for the branches' warm-up runs: a
        # replay, counted as the captures' warm-up
        mid, _ = self.pre._run(example_args, warming=True)
        shared = _storages(self.pre._inputs)
        device = self.pre._inputs[0].device
        self._graphs = {
            key: _capture(lambda fn=fn: fn(*args, mid), device, shared)
            for key, fn in parts.branches.items()}

    def __call__(self, *args):
        """(the keys run, the last branch's outputs) for one step on
        ``args``."""
        mid, code = self.pre(*args)
        self._last = (*args, mid)
        return route(self.parts.read, self.parts.recheck, self.run, code)

    def run(self, key):
        """Branch ``key`` on the last call's pre outputs."""
        if self._graphs is None:
            return self.parts.branches[key](*self._last)
        graph, outputs, launches = self._graphs[key]
        _replay(graph, launches)
        return outputs


def clone(tree):
    """A copy of every tensor of ``tree`` (nested NamedTuples), made with
    one ``_foreach_copy_`` into fresh tensors."""
    leaves, _ = flatten(tree)
    copies = [torch.empty_like(t) for t in leaves]
    if copies:
        torch._foreach_copy_(copies, leaves)
    return _rebuild(tree, iter(copies))
