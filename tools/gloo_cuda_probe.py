#!/usr/bin/env python3
"""Which collectives of the FSSDP layer the gloo backend carries on CUDA
tensors: two ranks that share one card, one gloo group.

    python3 tools/gloo_cuda_probe.py

Each rank issues, on CUDA tensors, every call the distributed layer
(``src/repro_torch/core/moe.py``) and the train step make:
``all_to_all_single`` (f32 and int32), ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce`` (sum and max) and a pair of
``batch_isend_irecv`` hops; it checks each result and records the error
of each call that raises.  Prints one JSON line per rank, and exits 1 if a
call failed on either rank.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(grid):
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    r, n = grid.rank, grid.size
    other = grid.ep_ranks[(grid.e + 1) % n]
    res = {}

    def call(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            res[name] = "ok" if torch.equal(got.cpu(), want) else \
                f"wrong result {got.cpu().tolist()}"
        except Exception as e:                   # noqa: BLE001 - recorded
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"

    def a2a(dt):
        x = (torch.arange(2 * n, device=dev) + 10 * r).to(dt)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=grid.ep_group)
        return out
    want = torch.tensor([10 * s + 2 * r + i for s in range(n)
                         for i in range(2)])
    call("all_to_all_single f32", lambda: a2a(torch.float32),
         want.float())
    call("all_to_all_single int32", lambda: a2a(torch.int32),
         want.to(torch.int32))

    def gather():
        out = torch.empty(2 * n, device=dev)
        dist.all_gather_into_tensor(out, torch.full((2,), float(r),
                                                    device=dev),
                                    group=grid.ep_group)
        return out
    call("all_gather_into_tensor", gather,
         torch.tensor([float(s) for s in range(n) for _ in range(2)]))

    def rs():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(2.0 * n, device=dev),
                                   group=grid.ep_group)
        return out
    call("reduce_scatter_tensor", rs,
         torch.tensor([n * (2.0 * r), n * (2.0 * r + 1)]))

    def ar(op):
        x = torch.full((3,), float(r + 1), device=dev)
        dist.all_reduce(x, op=op)
        return x
    call("all_reduce sum", lambda: ar(dist.ReduceOp.SUM),
         torch.full((3,), float(n * (n + 1) // 2)))
    call("all_reduce max", lambda: ar(dist.ReduceOp.MAX),
         torch.full((3,), float(n)))

    def hop():
        send = torch.full((4,), float(r), device=dev)
        recv = torch.empty(4, device=dev)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, other, grid.ep_group),
                dist.P2POp(dist.irecv, recv, other, grid.ep_group)]):
            w.wait()
        return recv
    call("batch_isend_irecv", hop, torch.full((4,), float(other)))
    return res


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    from repro_torch.launch.distributed import spawn
    with tempfile.TemporaryDirectory() as d:
        res = spawn(_probe, (1, 2), "cuda", workdir=d, backend="gloo",
                    timeout=300)
    bad = False
    for r, rr in enumerate(res):
        print(json.dumps({"rank": r, "torch": torch.__version__, **rr}))
        bad |= any(v != "ok" for v in rr.values())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
