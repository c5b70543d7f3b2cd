"""Multi-process launch glue: the port's counterpart of the JAX package's
``repro/launch/distributed.py``.

JAX runs one process per host over many devices; the port runs one
process (rank) per device.  These helpers cover what a launcher must get
right:

  1. runtime init (``maybe_initialize``) from the variables that
     ``python -m torch.distributed.run`` sets, with an explicit backend:
     ``nccl`` for CUDA, ``gloo`` for the CPU;
  2. starting ranks on one machine (``spawn``): a ``FileStore``
     rendezvous in a given directory (no TCP port to collide), one intra-op
     thread per rank, a bounded wait, and every rank killed as soon as one
     fails or the wait runs out, with the failing rank's traceback in the
     error.  It is the one way the port starts ranks itself;
  3. agreeing on the Hecate scheduler state across ranks: the plans are
     pure functions of (sharding, predicted loads), and the expert counts
     the predictor observes are all-reduced inside the step, so every rank
     plans the same; ``assert_scheduler_coherence`` checks it.
"""
from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import os
import time
import traceback
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize(device="cuda") -> bool:
    """Initialize the default process group when launched by
    ``python -m torch.distributed.run`` (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` set).  Returns whether a group is up."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(_backend(device), init_method="env://")
    return True


def process_info() -> Dict[str, Any]:
    if not dist.is_initialized():
        return {"rank": 0, "world_size": 1, "backend": None}
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "backend": dist.get_backend()}


def host_stream(make_stream_fn, *, vocab_size: int, seq_len: int,
                global_batch: int, **kw) -> Iterator[Dict[str, np.ndarray]]:
    """A data stream producing only this rank's part of the global batch
    (deterministic per-rank seeds, as in ``data.pipeline``)."""
    info = process_info()
    return iter(make_stream_fn(vocab_size, seq_len, global_batch,
                               process_index=info["rank"],
                               process_count=info["world_size"], **kw))


def assert_scheduler_coherence(counts, group=None) -> np.ndarray:
    """The expert counts are all-reduced inside the step, so every rank
    holds the same ones.  Checks it (one max all-reduce of the counts and
    their negation) before they reach the predictor: ranks that planned
    from different loads would issue mismatched collectives."""
    counts = np.asarray(counts, np.float32)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return counts
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.as_tensor(counts, device=dev).reshape(-1)
    both = torch.cat([t, -t])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    hi, lo = both[:t.numel()], -both[t.numel():]
    if not torch.equal(hi, lo):
        raise RuntimeError("Hecate predictors diverged across ranks: the "
                           "observed expert counts differ")
    return counts


# ---------------------------------------------------------------------------
# spawn: ranks on one machine
# ---------------------------------------------------------------------------
def _rank_entry(fn, args, rank: int, grid: Tuple[int, int], device: str,
                backend: str, workdir: str, threads: int) -> None:
    err = os.path.join(workdir, f"rank{rank}.err")
    try:
        torch.set_num_threads(threads)
        # ranks of one machine talk over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        world = grid[0] * grid[1]
        store = dist.FileStore(os.path.join(workdir, "rendezvous"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        from repro_torch.launch.mesh import make_grid
        out = fn(make_grid(*grid), *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def spawn(fn: Callable, grid: Sequence[int], device: str = "cuda", *,
          workdir: str, args: tuple = (), timeout: float = 300.0,
          threads: int = 1, backend: Optional[str] = None) -> list:
    """Run ``fn(grid, *args)`` on ``data * model`` new processes of this
    machine and return every rank's result, in rank order.

    ``fn`` must be importable by a fresh interpreter (a module-level
    function), and its result picklable.  ``workdir``: the directory of
    the ``FileStore`` rendezvous and the results (an earlier run's are
    removed first).  ``backend`` defaults to ``nccl`` for a CUDA
    ``device`` and ``gloo`` for the CPU.
    Each rank runs ``threads`` intra-op threads.  The wait is bounded by
    ``timeout`` seconds; at the first rank that fails, or at the timeout,
    every rank still running is killed and the error carries the failing
    rank's traceback."""
    data, model = int(grid[0]), int(grid[1])
    world = data * model
    os.makedirs(workdir, exist_ok=True)
    for name in ["rendezvous"] + [f"rank{r}.{x}" for r in range(world)
                                  for x in ("pt", "err")]:
        if os.path.exists(os.path.join(workdir, name)):   # an earlier run's
            os.remove(os.path.join(workdir, name))
    backend = backend or _backend(device)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, args, r, (data, model), device, backend,
                               workdir, threads),
                         name=f"repro-rank{r}")
             for r in range(world)]
    for p in procs:
        p.start()
    pending = {p.sentinel: (r, p) for r, p in enumerate(procs)}
    deadline = time.monotonic() + timeout
    try:
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: ranks {sorted(r for r, _ in pending.values())} "
                    f"still running after {timeout:.0f} s; killed")
            for s in mp.connection.wait(list(pending), timeout=left):
                r, p = pending.pop(s)
                p.join()
                if p.exitcode != 0:
                    path = os.path.join(workdir, f"rank{r}.err")
                    tb = (open(path).read() if os.path.exists(path)
                          else "(no traceback)")
                    raise RuntimeError(f"spawn: rank {r} of {world} failed "
                                       f"(exit code {p.exitcode}):\n{tb}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
