"""Data parallelism over processes — counterpart of
``vnet_tpu/parallel/mesh.py``.

JAX runs one program over a ``(data, space)`` device mesh and lets XLA
insert the collectives. The port runs one process per GPU (a *rank*) under
``torch.distributed`` and issues them itself:

* :class:`Mesh` records where this process sits: world size, rank, local
  rank, the sizes of the data axis and of its DCN (node) part, and the
  process's device. Ranks are DCN-major (node) and
  local-GPU-minor, torchrun's order, as :func:`make_multislice_mesh` lays
  out JAX's multi-slice ``data`` axis.
* :func:`batch_rows` is rank r's contiguous block of a global batch: each
  rank loads only its own samples, in the place of JAX's ``shard_batch``
  and ``shard_batch_per_host``.
* Collectives a training step needs (``Mesh.sum``, :func:`all_reduce_mean`
  for batch statistics, :meth:`Mesh.average_gradients`, the broadcasts) are
  no-ops on a data axis of one rank: the single-card path launches none.
* :func:`data_parallel` makes a mesh the step's: batch norms reduce their
  statistics over it and dropout draws the rank's rows of the global mask
  (``models/layers.py``). Like JAX's ``current_partition()`` it is a
  context the step sets, not a global switch, so the sliding window, which
  runs each rank's own patches (JAX's ``shard_map``), keeps per-rank
  statistics.
* :func:`launch` runs a function on every rank: it spawns local ranks, or
  joins the group torchrun describes (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).

Spatial partitioning (``space_parallel > 1``) is not ported yet
(ROADMAP.md, Queue 1 #6).
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

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "vnet_data_parallel", default=None)


@dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a data-parallel run.

    ``data`` ranks split each global batch into equal contiguous blocks,
    ``rank`` takes block ``rank``; ``dcn`` of them are nodes (``data //
    dcn`` local GPUs each). The data axis is the whole process group, so
    the collectives run on the default group."""

    world_size: int
    rank: int
    local_rank: int
    data: int
    dcn: int
    device: torch.device

    @property
    def node(self) -> int:
        """The rank's node (its DCN index): ranks are node-major."""
        return self.rank // (self.data // self.dcn)

    @property
    def parallel(self) -> bool:
        """Whether collectives run: more than one rank on the data axis."""
        return self.data > 1

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks (a new tensor; ``x`` itself on one
        rank); not differentiable."""
        if not self.parallel:
            return x
        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over the ranks; not differentiable."""
        return self.sum(x) / self.data if self.parallel else x

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

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers into every rank's ``module``, in
        one broadcast a dtype."""
        if self.parallel:
            _coalesced(list(module.parameters()) + list(module.buffers()),
                       lambda flat: dist.broadcast(flat, 0))

    def average_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Replace each ``.grad`` by its mean over the ranks, in one
        all-reduce a dtype."""
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


def _check_space(space_parallel: int) -> None:
    if space_parallel < 1:
        raise ValueError(f"space_parallel={space_parallel} must be >= 1")
    if space_parallel > 1:
        raise NotImplementedError(
            f"space_parallel={space_parallel}: spatial partitioning is not "
            "ported yet (ROADMAP.md, Queue 1 #6: parallel/halo.py and "
            "parallel/spatial.py come in the next slice)")


def make_mesh(data_parallel: int = 0, space_parallel: int = 1,
              device="cuda") -> Mesh:
    """The ``(data, space)`` mesh of this process group: ``data_parallel``
    ranks on the data axis, 0 for every rank. Without a process group the
    mesh is one rank. The data axis must take every rank of the group: a
    process cannot sit idle as a device outside JAX's mesh does, so launch
    as many ranks as the axis has."""
    _check_space(space_parallel)
    world, rank = _world()
    if data_parallel <= 0:
        data_parallel = world
    use = data_parallel * space_parallel
    if use > world:
        raise ValueError(f"mesh {data_parallel}x{space_parallel} needs {use} "
                         f"devices, have {world}")
    if use < world:
        raise ValueError(f"mesh {data_parallel}x{space_parallel} uses {use} "
                         f"of {world} ranks; launch {use} ranks")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return Mesh(world, rank, local_rank, data_parallel, 1,
                rank_device(device, local_rank))


def make_multislice_mesh(ici_data_parallel: int = 0,
                         dcn_data_parallel: int = 0,
                         space_parallel: int = 1, device="cuda") -> Mesh:
    """The data axis over several nodes: DCN (node) major, the node's GPUs
    (ICI) minor, which is torchrun's rank order (rank = node * GPUs a node
    + local rank), so a rank's data index is its rank. 0 takes the node
    count from ``LOCAL_WORLD_SIZE`` (one node without it) and the GPUs a
    node from the rest."""
    _check_space(space_parallel)
    world, rank = _world()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dcn_data_parallel <= 0:
        dcn_data_parallel = max(world // max(local_world, 1), 1)
    if ici_data_parallel <= 0:
        ici_data_parallel = world // dcn_data_parallel
    want = ici_data_parallel * dcn_data_parallel * space_parallel
    if want != world:
        raise ValueError(
            f"mesh dcn={dcn_data_parallel} x ici={ici_data_parallel} x "
            f"space={space_parallel} needs {want} devices, have {world}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank % ici_data_parallel))
    return Mesh(world, rank, local_rank, world, dcn_data_parallel,
                rank_device(device, local_rank))


def data_parallel_size(batch_size: int, data_parallel: int,
                       devices: int) -> int:
    """The data axis a trainer uses: ``data_parallel``, or for 0 the
    largest count of ``devices`` that divides the batch, as JAX's trainer
    takes ``gcd(BatchSize, devices)``."""
    return data_parallel if data_parallel > 0 else math.gcd(batch_size,
                                                            devices)


def batch_rows(mesh: Mesh, n: int) -> Tuple[int, int]:
    """``(start, stop)``: the rank's contiguous block of a global batch of
    ``n`` rows (JAX's ``P("data")`` on the leading axis)."""
    if n % mesh.data:
        raise ValueError(f"a batch of {n} does not split over {mesh.data} "
                         "data-parallel ranks")
    per = n // mesh.data
    return mesh.rank * per, (mesh.rank + 1) * per


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
    """Make ``mesh`` the data-parallel mesh of the code inside: batch norms
    reduce their batch statistics over its ranks and dropout draws the
    rank's rows of the global batch's mask. A mesh of one rank, or
    ``None``, changes nothing."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.parallel else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[Mesh]:
    """The mesh :func:`data_parallel` set, if it has more than one rank."""
    return _ACTIVE.get()


class _AllReduceMean(torch.autograd.Function):
    """The mean over the ranks; its backward is the mean of the incoming
    gradients, since every rank's loss depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.mean(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.mean(g), None


def all_reduce_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable mean of ``x`` over the mesh's ranks (one all-reduce
    forward, one backward)."""
    return _AllReduceMean.apply(x, mesh) if mesh.parallel else x


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
