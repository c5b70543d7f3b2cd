"""The process grid: the port's counterpart of the JAX package's
``repro/launch/mesh.py``.

JAX lays a (data, model) mesh over its devices; the port runs one process
per device and lays the same grid over the ranks of a ``torch.distributed``
world, in ``jax.make_mesh((data, model))``'s device order: rank
``d * model + e`` sits at data index ``d`` and model (expert-parallel)
index ``e``.  The grid carries the process groups the FSSDP layer talks
over:

* the **EP group** of a data index ``d``: ranks ``d * model + e`` for
  every ``e`` (the JAX ``model`` axis: the SparseAllGather of expert
  chunks and the token all-to-alls);
* the **FSDP group** of a model index ``e``: ranks ``d * model + e`` for
  every ``d`` (the JAX ``data`` axis: the all-gather of the sharded chunk
  columns);
* the world (the gate statistics, the gradient sum of replicated
  parameters).

``new_group`` is collective over the world, so every rank creates every
group, in the same order, and keeps its own two.  A function, not a module
constant: importing this module touches no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Tuple

import torch.distributed as dist


@dataclasses.dataclass
class ProcessGrid:
    """A (data, model) grid over the ranks of the default process group."""
    data: int
    model: int
    rank: int
    ep_group: Any              # this rank's EP group (size ``model``)
    fsdp_group: Any            # this rank's FSDP group (size ``data``)
    world_group: Any = None    # the default group
    ep_ranks: List[int] = dataclasses.field(default_factory=list)
    # the CUDA stream the SparseAllGather is issued from (made at its first
    # use), so the compute stream waits for its collectives only where it
    # consumes the slots
    comm_stream: Any = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def d(self) -> int:
        """This rank's data index."""
        return self.rank // self.model

    @property
    def e(self) -> int:
        """This rank's model (expert-parallel) index."""
        return self.rank % self.model


def _axis_groups(data: int, model: int, rank: int):
    """Make the EP group of every data index and the FSDP group of every
    model index (collective: every rank of the world calls it, in the same
    order) and return this rank's ``(ep_group, ep_ranks, fsdp_group)``,
    or Nones for a rank outside the ``data * model`` grid."""
    n = data * model
    d_me, e_me = rank // model, rank % model
    ep_group = fsdp_group = ep_ranks = None
    for d in range(data):                     # every rank, same order
        ranks = [d * model + e for e in range(model)]
        g = dist.new_group(ranks=ranks)
        if rank < n and d == d_me:
            ep_group, ep_ranks = g, ranks
    for e in range(model):
        ranks = [d * model + e for d in range(data)]
        g = dist.new_group(ranks=ranks)
        if rank < n and e == e_me:
            fsdp_group = g
    return ep_group, ep_ranks, fsdp_group


def make_grid(data: int, model: int) -> ProcessGrid:
    """The grid over an initialized default group of ``data * model``
    ranks.  Collective: every rank of the world must call it."""
    if not dist.is_initialized():
        raise RuntimeError("make_grid needs torch.distributed initialized "
                           "(launch.distributed.spawn or maybe_initialize)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a {data} x {model} grid needs {data * model} "
                         f"ranks, the world has {world}")
    rank = dist.get_rank()
    ep_group, ep_ranks, fsdp_group = _axis_groups(data, model, rank)
    return ProcessGrid(data, model, rank, ep_group, fsdp_group,
                       dist.group.WORLD, ep_ranks)


def private_grid(grid: ProcessGrid) -> ProcessGrid:
    """A grid over the same ranks as ``grid`` with process groups of its
    own (EP, FSDP and world), for collectives issued from another thread
    than the grid's: two threads issuing on one group can interleave their
    calls in a different order on each rank.  The serving engine builds
    its slot cache on such a grid.  Collective over the world: every rank
    calls it, in the same order."""
    rank = dist.get_rank()
    world = dist.new_group(ranks=list(range(grid.size)))
    ep_group, ep_ranks, fsdp_group = _axis_groups(grid.data, grid.model,
                                                  rank)
    return ProcessGrid(grid.data, grid.model, grid.rank, ep_group,
                       fsdp_group, world, ep_ranks)


def destroy_grid(grid: ProcessGrid) -> None:
    """Destroy the process groups of a ``private_grid`` once no collective
    on them is in flight on this rank."""
    done = []
    for g in (grid.ep_group, grid.fsdp_group, grid.world_group):
        if g is not None and all(g is not d for d in done):
            dist.destroy_process_group(g)
            done.append(g)


def production_shape(multi_pod: bool = False) -> Tuple[int, int]:
    """The (data, model) shape of the JAX package's production mesh on the
    port's two-axis grid: 16 x 16 (256 ranks), or 32 x 16 (512) for two
    pods.  The reference's ``batch`` and ``expert_ff`` rules map the
    ("pod", "data") pair onto the batch and the chunk columns
    (``repro/core/moe.py``), so its pod axis folds into ``data`` here."""
    return (32, 16) if multi_pod else (16, 16)


def make_production_grid(*, multi_pod: bool = False) -> ProcessGrid:
    """The production grid (``production_shape``) over an initialized
    default group of its size, the counterpart of the JAX package's
    ``make_production_mesh``.  Collective: every rank calls it."""
    return make_grid(*production_shape(multi_pod))


@contextlib.contextmanager
def fake_grid(data: int, model: int, rank: int = 0):
    """Open a FAKE default process group of ``data * model`` ranks as
    ``rank`` and yield its grid; destroy the group on exit.  Every
    collective on it returns at once and moves nothing, so one process can
    run a rank's step of a grid it does not have (``launch.dryrun``).  The
    backend comes from ``torch.testing._internal.distributed.fake_pg``, a
    private module of PyTorch (a test pins that it is there).  Refuses to
    run beside an existing default group."""
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_grid needs no default process group: one "
                           "is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=data * model)
    try:
        yield make_grid(data, model)
    finally:
        dist.destroy_process_group()


def make_debug_mesh(data: int = 2, model: int = 4) -> ProcessGrid:
    """Small grid for tests (the JAX package's name): the world must
    already hold ``data * model`` ranks, e.g. under
    ``launch.distributed.spawn``."""
    return make_grid(data, model)


def surviving_grid(grid: ProcessGrid, model: int) -> Optional[ProcessGrid]:
    """The (grid.data, model) grid over the first ``grid.data * model``
    ranks of the world, the counterpart of the JAX package's
    ``surviving_mesh``: the grid left after an EP rank is declared lost
    (a simulated loss drops the tail, so the survivors are a prefix), and
    the full grid again on grow-back.  Its ``world_group`` spans its own
    ranks only.  Collective: every rank of the world calls it, in the same
    order; a rank outside the new grid gets None (a spare)."""
    data = grid.data
    n = data * model
    rank = dist.get_rank()
    sub = dist.new_group(ranks=list(range(n)))
    ep_group, ep_ranks, fsdp_group = _axis_groups(data, model, rank)
    if rank >= n:
        return None
    return ProcessGrid(data, model, rank, ep_group, fsdp_group, sub,
                       ep_ranks)
