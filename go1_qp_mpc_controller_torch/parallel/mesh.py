"""Device mesh and batch sharding for scenario sweeps over torch.distributed.

Port of the JAX package's ``parallel/mesh.py``. The reference has no
distributed layer (SURVEY.md section 2.5); the design has two parallel
axes:

- ``data``: scenarios are embarrassingly parallel; each rank of the axis
  holds a contiguous block of the batch (``shard_map``'s
  ``P(DATA_AXIS)`` split, :func:`scenario_sharding`).
- ``mpc``: intra-solve block parallelism: the condensation contraction
  H = B_qp' Q B_qp reduces over horizon-state rows, which split across
  the axis and combine with an ``all_reduce`` (``parallel/sweep.py``).

One process a card: ``torchrun --nproc_per_node=N`` across N cards (NCCL),
or one process alone (world size 1). A (N, 1) mesh is pure scenario
parallelism.
"""

import datetime
import os

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from go1_qp_mpc_controller_torch.utils.device import resolve_device

DATA_AXIS = "data"
MPC_AXIS = "mpc"
# a rank waits this long at a collective for the others (they build the
# kernels at their first use)
TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(device=None):
    """Join the process group and return the device this rank computes on.

    Under ``torchrun`` (``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` in the
    environment) the rank first makes card ``LOCAL_RANK`` its current CUDA
    device, before any tensor or kernel touches a card (the kernel wrappers
    launch on the current device), then joins over NCCL; with
    ``device="cpu"`` it joins over gloo. Without ``torchrun`` it forms a
    world of one process on a ``HashStore``. A process that has joined
    already keeps its group.

    Args:
      device: None (the CUDA card) or a torch device; only its type is
        read under ``torchrun``.
    """
    launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if launched and torch.device(device or "cuda").type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        device = torch.device("cuda", torch.cuda.current_device())
    device = resolve_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if launched:
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    return device


class Mesh:
    """A (data, mpc) ``DeviceMesh`` over the process group's ranks (rank =
    data index x mpc size + mpc index), its ``shape`` a dict like the JAX
    package's ``mesh.shape``, and the device this rank computes on."""

    def __init__(self, device_mesh, device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = {name: device_mesh.size(i) for i, name in
                      enumerate(device_mesh.mesh_dim_names)}

    def group(self, axis):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def index(self, axis):
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def make_mesh(mpc_parallel=1):
    """Build a (data, mpc) mesh over the process group's ranks (call
    :func:`init_distributed` first).

    Args:
      mpc_parallel: size of the intra-solve reduction axis (must divide the
        world size). 1 = scenario parallel only.

    Returns:
      :class:`Mesh` with axes (data, mpc).
    """
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % mpc_parallel != 0:
        raise ValueError(f"{n} devices not divisible by mpc={mpc_parallel}")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    device_mesh = init_device_mesh(device.type, (n // mpc_parallel,
                                                 mpc_parallel),
                                   mesh_dim_names=(DATA_AXIS, MPC_AXIS))
    return Mesh(device_mesh, device)


def scenario_sharding(mesh, tree):
    """This rank's scenario shard of ``tree``: the contiguous block of the
    leading (batch) axis of every tensor leaf (nested NamedTuples; other
    leaves pass), the split the JAX package's ``scenario_sharding``
    (``P(DATA_AXIS)``) makes. The batch must divide the data axis; with
    one rank on it, ``tree`` itself."""
    n = mesh.shape[DATA_AXIS]
    if n == 1:
        return tree
    leaves = [a for a in pytree.tree_leaves(tree) if torch.is_tensor(a)]
    batch = leaves[0].shape[0]
    if batch % n:
        raise ValueError(f"a batch of {batch} does not split over "
                         f"{n} data ranks")
    s = batch // n
    k = mesh.index(DATA_AXIS)
    return pytree.tree_map(
        lambda a: a[k * s:(k + 1) * s] if torch.is_tensor(a) else a, tree)


def replicated(mesh, tree):
    """The inverse of :func:`scenario_sharding`: the whole batch on every
    rank, each tensor leaf's blocks of the data axis concatenated in rank
    order (one ``all_gather`` a leaf; with one rank on the axis, ``tree``
    itself)."""
    n = mesh.shape[DATA_AXIS]
    if n == 1:
        return tree
    group = mesh.group(DATA_AXIS)

    def gather(a):
        if not torch.is_tensor(a):
            return a
        parts = [torch.empty_like(a) for _ in range(n)]
        dist.all_gather(parts, a.contiguous(), group=group)
        return torch.cat(parts)

    return pytree.tree_map(gather, tree)


def make_sharded_control_step(mesh, model, params, dt, settings=None,
                              warm_settings=None, compact_k=None,
                              robust=False, use_terrain_adapt=True):
    """The batched controller tick (``controller.control_step_batched``:
    sensors to torques with the warm carry and the three-way transition
    routing) on this rank's shard of the data axis.

    The routing decisions (the transition flags, the top-k cold
    compaction) are shard-local, so no collective runs on any tick: each
    rank routes its own scenarios warm / compacted / cold. Because the
    compaction computes exactly the per-scenario warm / cold semantics,
    per-shard routing equals the one-process program whenever no shard
    overflows its local ``compact_k``.

    Args:
      mesh: the :class:`Mesh` whose data-axis shard the step receives
        (``scenario_sharding(mesh, states)``); ranks along its mpc axis,
        if any, compute replicas (pass an (N, 1) mesh for controller
        sweeps).
      model, params: RobotModel / CtrlParams on the rank's device.
      dt: control period (a float).
      compact_k: per-shard cold sub-batch size (default 256, clamped to
        the local batch).

    Returns:
      fn: the rank's CtrlState shard -> its updated shard.
    """
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.ops import admm

    settings = admm.ADMMSettings() if settings is None else settings
    if warm_settings is None:
        warm_settings = controller.WARM_SETTINGS
    k = 256 if compact_k is None else compact_k

    def local_step(states):
        if states.contacts.device != mesh.device:
            raise ValueError(f"the shard lives on {states.contacts.device}, "
                             f"the mesh's rank on {mesh.device}")
        return controller.control_step_batched(
            states, model, params, float(dt), settings=settings,
            use_terrain_adapt=use_terrain_adapt,
            warm_settings=warm_settings, robust=robust, compact_k=k)

    return local_step
