"""Data and spatial parallelism over processes — counterpart of
``vnet_tpu/parallel/mesh.py``.

JAX runs one program over a ``(data, space)`` device mesh and lets XLA
insert the collectives. The port runs one process per GPU (a *rank*) under
``torch.distributed`` and issues them itself:

* :class:`Mesh` records where this process sits: world size, rank, local
  rank, the sizes of the data axis, of its DCN (node) part and of the
  space axis, and the process's device. Ranks are data-major and
  space-minor, as JAX reshapes its device list into the ``(data, space)``
  grid, so a space group sits inside a node; the data axis itself is
  DCN-major (node) and local-GPU-minor, torchrun's order, as
  :func:`make_multislice_mesh` lays out JAX's multi-slice ``data`` axis.
  With ``space > 1`` every rank creates two subgroups once: the ranks of
  its data row (the *space group*) and of its space column (the *data
  group*).
* :func:`batch_rows` is the contiguous block of a global batch that the
  rank's data row holds: each row loads only its own samples, in the place
  of JAX's ``shard_batch`` and ``shard_batch_per_host``;
  :meth:`Mesh.slab` is the rank's slab of the first spatial axis, which
  JAX's ``batch_sharding`` shards over ``space``.
* Collectives a training step needs (``Mesh.sum``, :func:`all_reduce_mean`
  for batch statistics, :meth:`Mesh.average_gradients`, the broadcasts) are
  no-ops on a mesh of one rank: the single-card path launches none.
* :func:`data_parallel` makes a mesh the step's: batch norms reduce their
  statistics over all its ranks and dropout draws the rank's part of the
  global mask (``models/layers.py``); with ``space > 1`` it also enters the
  spatial partition (``parallel/spatial.py``): convolutions exchange halos
  with the space group and packing is planned on the global extents, as
  GSPMD plans the unsharded program. Like JAX's ``current_partition()`` it
  is a context the step sets, not a global switch, so the sliding window,
  which runs each rank's own patches (JAX's ``shard_map``), keeps per-rank
  statistics.
* :func:`launch` runs a function on every rank: it spawns local ranks, or
  joins the group torchrun describes (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import multiprocessing as mp
import os
import socket
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "vnet_data_parallel", default=None)


@dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a ``(data, space)`` grid of ranks.

    ``data`` rows split each global batch into equal contiguous blocks; the
    ``space`` ranks of a row split the first spatial axis of the row's
    patches into equal slabs. Rank ``r`` is data index ``r // space`` and
    space index ``r % space``; ``dcn`` data rows are nodes. The grid is the
    whole process group: ``space_group`` holds the ranks of this rank's
    data row and ``data_group`` those of its space column (``None`` when
    the axis is the whole group or the mesh is one rank)."""

    world_size: int
    rank: int
    local_rank: int
    data: int
    dcn: int
    device: torch.device
    space: int = 1
    space_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space

    @property
    def space_ranks(self) -> Tuple[int, ...]:
        """The global ranks of this rank's data row, in space order."""
        first = self.data_index * self.space
        return tuple(range(first, first + self.space))

    @property
    def node(self) -> int:
        """The rank's node (its DCN index): ranks are node-major."""
        return self.rank // (self.world_size // self.dcn)

    @property
    def parallel(self) -> bool:
        """Whether collectives run: more than one rank in the grid."""
        return self.world_size > 1

    def slab(self, n: int) -> Tuple[int, int]:
        """``(start, stop)``: the rank's slab of a sharded axis of extent
        ``n`` (JAX's ``P(..., "space")``)."""
        if n % self.space:
            raise ValueError(f"an extent of {n} does not split over "
                             f"{self.space} space-parallel ranks")
        per = n // self.space
        return self.space_index * per, (self.space_index + 1) * per

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every rank (a new tensor; ``x`` itself on one
        rank); not differentiable."""
        if not self.parallel:
            return x
        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over every rank; not differentiable. A value that
        the space ranks of a row share (the loss) is thus averaged over the
        data rows."""
        return self.sum(x) / self.world_size if self.parallel else x

    def barrier(self) -> None:
        if self.parallel:
            dist.barrier()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (a picklable value)."""
        if not self.parallel:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def broadcast_row(self, obj):
        """The first space rank's ``obj`` on every rank of its data row (a
        picklable value): the row's ranks then hold the same samples,
        whatever order their loaders drew host randomness in."""
        if self.space == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.space_ranks[0],
                                   group=self.space_group)
        return box[0]

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers into every rank's ``module``, in
        one broadcast a dtype."""
        if self.parallel:
            _coalesced(list(module.parameters()) + list(module.buffers()),
                       lambda flat: dist.broadcast(flat, 0))

    def average_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Replace each ``.grad`` by its sum over the space ranks averaged
        over the data rows, in one all-reduce a dtype: a space rank's
        gradient is its slab's part of its row's, a row's is its block's
        mean."""
        if self.parallel:
            grads = [p.grad for p in params if p.grad is not None]

            def reduce(flat):
                dist.all_reduce(flat)
                flat.div_(self.data)

            _coalesced(grads, reduce)


def _coalesced(tensors, collective: Callable[[torch.Tensor], None]) -> None:
    """Run ``collective`` in place on one flat copy of ``tensors`` per
    dtype and write the results back."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        collective(flat)
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def under_torchrun() -> bool:
    """Whether torchrun (or another launcher) describes this process's rank
    in the environment (``RANK`` and ``WORLD_SIZE``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda`` without an index is the rank's own
    card ``cuda:<local_rank>``, which must exist; an explicit ``cuda:K``
    (several ranks on one card, as a ``gloo`` run may place them) or
    ``cpu`` stays as it is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    if dev.index is None:
        if local_rank >= torch.cuda.device_count():
            raise ValueError(
                f"local rank {local_rank} needs card {local_rank}, but torch "
                f"sees {torch.cuda.device_count()} card(s)")
        dev = torch.device("cuda", local_rank)
    return dev


_GROUPS = {}  # (world, data, space) -> (row groups, column groups)


def _grid_groups(world: int, data: int, space: int):
    """The space groups (one a data row) and data groups (one a space
    column) of a ``data x space`` grid, created once a process: every rank
    calls ``dist.new_group`` for every group, in the same order."""
    key = (world, data, space)
    if key not in _GROUPS:
        rows = [dist.new_group(list(range(d * space, (d + 1) * space)))
                for d in range(data)]
        cols = [dist.new_group(list(range(s, world, space)))
                for s in range(space)]
        _GROUPS[key] = rows, cols
    return _GROUPS[key]


def _grid_mesh(world, rank, local_rank, data, dcn, space, device) -> Mesh:
    space_group = data_group = None
    if space > 1 and world > 1:
        rows, cols = _grid_groups(world, data, space)
        space_group = rows[rank // space]
        data_group = cols[rank % space] if data > 1 else None
    return Mesh(world, rank, local_rank, data, dcn,
                rank_device(device, local_rank), space, space_group,
                data_group)


def make_mesh(data_parallel: int = 0, space_parallel: int = 1,
              device="cuda") -> Mesh:
    """The ``(data, space)`` mesh of this process group: ``space_parallel``
    ranks a data row, ``data_parallel`` rows (0: every rank that is left).
    Without a process group the mesh is one rank. The grid must take every
    rank of the group: a process cannot sit idle as a device outside JAX's
    mesh does, so launch as many ranks as the grid has."""
    world, rank = _world()
    if space_parallel < 1 or world % space_parallel:
        raise ValueError(f"space_parallel={space_parallel} must divide "
                         f"{world}")
    if data_parallel <= 0:
        data_parallel = world // space_parallel
    use = data_parallel * space_parallel
    if use > world:
        raise ValueError(f"mesh {data_parallel}x{space_parallel} needs {use} "
                         f"devices, have {world}")
    if use < world:
        raise ValueError(f"mesh {data_parallel}x{space_parallel} uses {use} "
                         f"of {world} ranks; launch {use} ranks")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return _grid_mesh(world, rank, local_rank, data_parallel, 1,
                      space_parallel, device)


def make_multislice_mesh(ici_data_parallel: int = 0,
                         dcn_data_parallel: int = 0,
                         space_parallel: int = 1, device="cuda") -> Mesh:
    """The data axis over several nodes: DCN (node) major, the node's GPUs
    (ICI) minor, which is torchrun's rank order (rank = node * GPUs a node
    + local rank); the space axis stays inside a node, minor to the data
    axis. 0 takes the node count from ``LOCAL_WORLD_SIZE`` (one node
    without it) and the rest from what is left."""
    world, rank = _world()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dcn_data_parallel <= 0:
        dcn_data_parallel = max(world // max(local_world, 1), 1)
    if ici_data_parallel <= 0:
        ici_data_parallel = world // (dcn_data_parallel * space_parallel)
    want = ici_data_parallel * dcn_data_parallel * space_parallel
    if want != world:
        raise ValueError(
            f"mesh dcn={dcn_data_parallel} x ici={ici_data_parallel} x "
            f"space={space_parallel} needs {want} devices, have {world}")
    per_node = world // dcn_data_parallel
    local_rank = int(os.environ.get("LOCAL_RANK", rank % per_node))
    return _grid_mesh(world, rank, local_rank,
                      dcn_data_parallel * ici_data_parallel,
                      dcn_data_parallel, space_parallel, device)


def data_parallel_size(batch_size: int, data_parallel: int,
                       devices: int) -> int:
    """The data axis a trainer uses: ``data_parallel``, or for 0 the
    largest count of ``devices`` that divides the batch, as JAX's trainer
    takes ``gcd(BatchSize, devices)``."""
    return data_parallel if data_parallel > 0 else math.gcd(batch_size,
                                                            devices)


def batch_rows(mesh: Mesh, n: int) -> Tuple[int, int]:
    """``(start, stop)``: the rank's data row's contiguous block of a global
    batch of ``n`` rows (JAX's ``P("data")`` on the leading axis)."""
    if n % mesh.data:
        raise ValueError(f"a batch of {n} does not split over {mesh.data} "
                         "data-parallel ranks")
    per = n // mesh.data
    return mesh.data_index * per, (mesh.data_index + 1) * per


def batch_sharding(mesh: Mesh) -> Callable[[tuple], tuple]:
    """JAX's ``batch_sharding``: a function from a batch's shape to the
    index of this rank's part of it — its data row's block of the leading
    axis and, with ``space > 1``, its slab of the first spatial axis."""

    def index(shape) -> tuple:
        lo, hi = batch_rows(mesh, shape[0])
        if mesh.space == 1 or len(shape) < 2:
            return (slice(lo, hi),)
        s0, s1 = mesh.slab(shape[1])
        return slice(lo, hi), slice(s0, s1)

    return index


def replicated(mesh: Mesh) -> torch.device:
    """JAX's ``replicated``: where a tensor that every rank holds whole
    lives (the rank's device)."""
    return mesh.device


def shard_batch(mesh: Mesh, *arrays):
    """This rank's part (:func:`batch_sharding`) of each host batch, as a
    tensor on its device."""
    index = batch_sharding(mesh)
    out = tuple(torch.from_numpy(np.ascontiguousarray(
        np.asarray(a)[index(np.shape(a))])).to(mesh.device) for a in arrays)
    return out if len(out) > 1 else out[0]


def pad_batch_to_multiple(batch: np.ndarray, multiple: int
                          ) -> Tuple[np.ndarray, int]:
    """Pad the leading dim up to a multiple (repeating the last sample) so a
    fixed batch shards evenly; returns (padded, original_count)."""
    b = batch.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch, b
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), b


# ----------------------------------------------------------------------
# the step's mesh
# ----------------------------------------------------------------------
@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Make ``mesh`` the mesh of the code inside: batch norms reduce their
    batch statistics over all its ranks and dropout draws the rank's part
    of the global batch's mask; with ``mesh.space > 1`` the code runs in
    the mesh's spatial partition too (``parallel/spatial.py``: halos,
    per-sample statistics and loss sums over the space group, packing
    planned on the global extents). A mesh of one rank, or ``None``,
    changes nothing."""
    active = mesh if mesh is not None and mesh.parallel else None
    with mesh_scope(active):
        if active is not None and active.space > 1:
            from .spatial import mesh_partition_scope
            with mesh_partition_scope(active):
                yield
        else:
            yield


def active_mesh() -> Optional[Mesh]:
    """The mesh :func:`data_parallel` set, if it has more than one rank."""
    return _ACTIVE.get()


@contextlib.contextmanager
def mesh_scope(mesh: Optional[Mesh]):
    """Make ``mesh``, a value :func:`active_mesh` gave (``None`` too), the
    active mesh of the code inside, and nothing else: no partition is
    entered. A recomputed block (``models/layers.py::recomputed``) runs
    under the mesh and the partition its forward saw, each as it was."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def group_mean(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``x`` averaged over the ``size`` ranks of ``group`` (the default
    group for ``None``); not differentiable."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out / size


class _AllReduceMean(torch.autograd.Function):
    """The mean over a group of ranks; its backward is the mean of the
    incoming gradients over the same group, since every rank's use of the
    mean is a part of the loss that depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return group_mean(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return group_mean(g, ctx.group, ctx.size), None, None


def all_reduce_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable mean of ``x`` over every rank of the mesh (one
    all-reduce forward, one backward)."""
    if not mesh.parallel:
        return x
    return _AllReduceMean.apply(x, None, mesh.world_size)


def group_all_reduce_mean(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Differentiable mean of ``x`` over the ``size`` ranks of ``group``."""
    return _AllReduceMean.apply(x, group, size) if size > 1 else x


# ----------------------------------------------------------------------
# process groups
# ----------------------------------------------------------------------
def default_backend(device) -> str:
    """``nccl`` for CUDA devices, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _in_group(rank: int, world_size: int, local_rank: int, backend, device,
              init_method: str, fn, args):
    """``fn(*args)`` as ``rank`` of a process group that lives as long."""
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev),
                            init_method=init_method, world_size=world_size,
                            rank=rank)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, world_size: int, backend, device,
               init_method: str, fn, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
    if torch.device(device).type == "cpu":  # share the cores, as torchrun
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    _in_group(rank, world_size, rank, backend, device, init_method, fn, args)


def launch(fn: Callable, world_size: int, backend: Optional[str] = None,
           device="cuda", init_method: Optional[str] = None, args=(),
           timeout: Optional[float] = None):
    """Run ``fn(*args)`` on every rank of a process group.

    * Under torchrun (``RANK`` and ``WORLD_SIZE`` set), this process joins
      the group torchrun describes and runs ``fn`` as its rank.
    * ``world_size`` 1: a group of one rank in this process.
    * ``world_size`` > 1: that many local ranks, spawned; ``fn`` must be
      picklable (a module-level function) and is run for its effects.

    ``backend``: ``nccl`` for CUDA and ``gloo`` for the CPU by default;
    ``gloo`` also runs several ranks on one card (``device="cuda:0"``).
    ``device``: ``cuda`` puts rank r on card r (there must be one),
    ``cuda:K`` every rank on card K, ``cpu`` the CPU. ``init_method``: a
    ``file://`` or ``tcp://`` rendezvous; a free localhost port by default.
    Returns ``fn``'s result when it ran in this process, else None; a
    spawned rank that fails stops the others and raises here. Inside a
    process group already, ``fn`` just runs.
    """
    if dist.is_available() and dist.is_initialized():
        return fn(*args)
    if under_torchrun():
        rank = int(os.environ["RANK"])
        return _in_group(rank, int(os.environ["WORLD_SIZE"]),
                         int(os.environ.get("LOCAL_RANK", rank)), backend,
                         device, init_method or "env://", fn, args)
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None
            and world_size > torch.cuda.device_count()):
        raise ValueError(f"{world_size} ranks need {world_size} cards, torch "
                         f"sees {torch.cuda.device_count()}")
    init_method = init_method or f"tcp://localhost:{free_port()}"
    if world_size == 1:
        return _in_group(0, 1, 0, backend, device, init_method, fn, args)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, backend, device, init_method, fn, args))
        for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                raise RuntimeError(f"a rank failed: exit codes {codes}")
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
    return None
