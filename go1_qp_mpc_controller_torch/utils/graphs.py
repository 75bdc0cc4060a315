"""Fixed-shape steps replayed as CUDA graphs.

At batch 1 a controller step is hundreds of tiny operations, each
dispatched from Python; the host loop's four threads share one GIL, so
that dispatch, not the card, sets their speed; a batched tick is ~1,000
of them. :class:`StagedStep` records such a step once and replays it with
one call per part, the counterpart of the JAX package's jitted steps, a
``lax.switch`` / ``lax.cond`` inside included: parts that read each
other's outputs, captured in one memory pool, and a host rule that reads
the device between them and picks the parts to replay (:class:`Stages`;
:func:`compose_stages` is the plain composition that the rule follows on
the CPU; :func:`single` makes the one-part, unrouted step of a plain
function).

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


def copy_all(dsts, srcs):
    """Copy each of ``srcs`` into its place in ``dsts``, one
    ``_foreach_copy_`` a dtype: a list of one dtype takes the card's fused
    multi-tensor copy, where a mixed list copies tensor by tensor (~5 us
    of host time each, ~0.5 ms for a batched carry)."""
    groups = {}
    for dst, src in zip(dsts, srcs):
        pair = groups.setdefault(dst.dtype, ([], []))
        pair[0].append(dst)
        pair[1].append(src)
    for group_dsts, group_srcs in groups.values():
        torch._foreach_copy_(group_dsts, group_srcs)


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


class Stages(NamedTuple):
    """A fixed-shape step in parts between host reads, the counterpart of
    a jitted step with ``lax.switch`` / ``lax.cond`` inside;
    :class:`StagedStep` captures the parts, :func:`compose_stages` runs
    them plainly:

    - ``parts`` {key: (fn, reads)}: ``fn(args, mids)`` -> outputs, where
      ``args`` is the tuple of the step's arguments and ``mids`` the
      outputs of the parts named in ``reads``, each listed before the
      parts that read it. A part that reads others takes what it needs
      from ``mids``: under :func:`nest` its ``args`` are the outer
      step's;
    - ``rule(run)`` -> (routes, outputs): the host side, which calls
      ``run(key)`` (part ``key`` on the latest outputs of the parts it
      reads, returning its outputs) in the order of ``parts``, reads what
      it routes on, and names the routes it took in a tuple (empty for
      an unrouted step).
    """
    parts: dict
    rule: object


def compose_stages(stages, *args):
    """The plain composition of :class:`Stages` on ``args``, what
    :class:`StagedStep` replays: (routes, outputs)."""
    outs = {}

    def run(key):
        fn, reads = stages.parts[key]
        outs[key] = fn(args, tuple(outs[r] for r in reads))
        return outs[key]
    return stages.rule(run)


def single(fn):
    """``fn(*args)`` as one-part, unrouted :class:`Stages`: a step's call
    returns ``((), fn's outputs)``."""
    return Stages({"step": (lambda args, mids: fn(*args), ())},
                  lambda run: ((), run("step")))


def _read_keys(parts):
    return {r for _, reads in parts.values() for r in reads}


def nest(stages, enter, leave):
    """``stages`` as the middle of an outer step: its first parts (those
    that read no other) run on ``enter(args)`` for the outer ``args``, and
    the outputs of its last parts (those no other reads) go out as
    ``leave(args, outputs)``, ``args`` the outermost step's arguments: a
    ``leave`` nested inside finds the ones it reads where each ``enter``
    around it keeps them."""
    read = _read_keys(stages.parts)
    parts = {}
    for key, (fn, reads) in stages.parts.items():
        if not reads:
            fn = (lambda f: lambda args, mids: f(enter(args), mids))(fn)
        if key not in read:
            fn = (lambda f: lambda args, mids: leave(args, f(args, mids)))(fn)
        parts[key] = (fn, reads)
    return stages._replace(parts=parts)


def _capture(body, device, shared, warmup=2, pool=None):
    """``body()`` recorded as a CUDA graph after ``warmup`` eager runs (on a
    side stream; their launches stay counted and are summed in
    :data:`warmup_launches`), in the memory ``pool`` (None: a pool of its
    own). An output sharing memory with one of the ``shared`` storages is
    copied inside the graph. Returns (graph, its outputs, the launches
    each replay makes); a capture that fails raises."""
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
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
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


class StagedStep:
    """:class:`Stages` as captured steps: each call copies its arguments
    into the step's input buffers (:func:`copy_all`), then the rule
    replays the parts it runs, on the calling thread's current stream,
    and makes its host reads between them. The arguments are (nested
    NamedTuples of) tensors of fixed shapes; Python numbers the parts
    need are closed over.

    Every part is captured at construction in the order of ``parts``, on
    the example arguments, reading the output buffers of the parts it
    reads; a part that others read is replayed once after its capture
    (counted as warm-up), so that their captures' warm-up runs read real
    data. The graphs share one memory pool, which needs the rule to run
    the parts of a call in the order of ``parts``: a part captured later
    never takes the memory of an earlier part's outputs, and a part
    replayed writes only its own outputs and memory that every part
    replayed before it in the call left free. The returned outputs are the
    graphs' buffers, overwritten by the next call: the caller copies what
    it keeps. An output of a last part that would share memory with an
    input buffer is copied inside its graph, so that the outputs can go
    back in as the next call's arguments. Capture the step before other
    threads issue work on the card; a capture that fails raises. On the
    CPU (no graphs) a call is :func:`compose_stages`.
    """

    def __init__(self, stages, *example_args):
        self.stages = stages
        self._graphs = None
        flat, self._shape = flatten(example_args)
        device = flat[0].device
        if device.type != "cuda":
            return
        self._inputs = [t.clone() for t in flat]
        args = _rebuild(example_args, iter(self._inputs))
        read = _read_keys(stages.parts)
        shared = _storages(self._inputs)
        pool = torch.cuda.graph_pool_handle()
        self._graphs = {}
        for key, (fn, reads) in stages.parts.items():
            mids = tuple(self._graphs[r][1] for r in reads)
            graph, outputs, launches = self._graphs[key] = _capture(
                lambda: fn(args, mids), device,
                set() if key in read else shared, pool=pool)
            if key in read:
                _replay(graph, launches, warming=True)

    def __call__(self, *args):
        """(the rule's routes, the outputs it returns) for one step on
        ``args``."""
        if self._graphs is None:
            return compose_stages(self.stages, *args)
        flat, shape = flatten(args)
        if shape != self._shape:
            raise ValueError("StagedStep: the arguments' structure differs "
                             "from the captured one")
        copy_all(self._inputs, flat)
        return self.stages.rule(self.run)

    def run(self, key):
        """Replay part ``key`` on the last call's arguments and the latest
        outputs of the parts it reads; returns its outputs, the graph's
        buffers."""
        graph, outputs, launches = self._graphs[key]
        _replay(graph, launches)
        return outputs


def clone(tree):
    """A copy of every tensor of ``tree`` (nested NamedTuples), made with
    :func:`copy_all` into fresh tensors."""
    leaves, _ = flatten(tree)
    copies = [torch.empty_like(t) for t in leaves]
    copy_all(copies, leaves)
    return _rebuild(tree, iter(copies))
