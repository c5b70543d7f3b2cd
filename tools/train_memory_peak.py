"""What is alive at the device memory peak of full-width gpt-moe-s
training through the FSSDP layer, at world size 1 over NCCL.

    python3 tools/train_memory_peak.py [--steps 2] [--top 12]

Runs the Hecate loop (bf16, batch 8 x 2,048, ring plan at ep = 1, the
config's remat mode) from three starting points, each with the allocator's
history recorded from just before the loop to just after:

- ``fresh``: a state made from the seed just before the loop (as
  ``chip_smoke.py`` phase 7 runs it);
- ``stepped``: a state that took one ``build_train_step`` step first (as
  phase 8 runs each mode);
- ``warm``: a fresh state, one loop step not counted, then the loop.

For each it prints the memory held before the loop, each step's peak,
and the largest allocations made inside the loop and still alive at the
overall peak: size, stream, and when they were made (the step, and the
share of that step's allocations made before them).  The allocator's
history is kept without stacks (capturing Python stacks fails inside
the checkpointed recompute of the backward).  Needs a CUDA card.
"""
import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _live_at_peak(trace, base: int):
    """(peak bytes, index of the peak's event, [(size, alloc event index,
    stream)] alive at the peak) from one device's allocator trace;
    ``base`` is what was allocated when it started."""
    live, cur, peak, at_peak, where = {}, base, base, {}, 0
    for i, ev in enumerate(trace):
        act = ev["action"]
        if act == "alloc":
            live[ev["addr"]] = (ev["size"], i, ev.get("stream", 0))
            cur += ev["size"]
            if cur > peak:
                peak, at_peak, where = cur, dict(live), i
        elif act == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    return peak, where, sorted(at_peak.values(), key=lambda v: -v[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        sys.exit("train_memory_peak: no CUDA device")
    import repro_torch.configs as configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.moe import MoERuntime
    from repro_torch.data.pipeline import make_stream
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models import model as mdl
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    store = os.path.join(tempfile.mkdtemp(prefix="mem_peak_"), "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        grid = make_grid(1, 1)
        cfg = configs.get("gpt-moe-s")
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=3, total_steps=12)
        stream = make_stream(cfg.vocab_size, 2048, 8, kind="bytes", seed=0)
        rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(
            use_pallas=True, grid=grid, impl="ring"))
        print(f"{torch.cuda.get_device_name(0)}; gpt-moe-s "
              f"remat={cfg.remat} rematerialize={cfg.moe.rematerialize}, "
              f"batch 8 x 2,048, {args.steps} loop steps per case")
        for case in ("fresh", "stepped", "warm"):
            state = step_lib.init_state(cfg, 0, 1, dev, grid)
            sched = HecateScheduler(cfg, ep=1, impl="ring", device=str(dev))
            if case == "stepped":
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in stream.next_batch().items()}
                state, _ = step_lib.build_train_step(cfg, rt, tc)(
                    state, batch, sched.plan_arrays())
                del batch
            elif case == "warm":
                state, _ = train_loop(cfg, rt, tc, stream, scheduler=sched,
                                      state=state, num_steps=1, log_every=0,
                                      device=dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            torch.cuda.memory._record_memory_history(max_entries=400000,
                                                   context=None)
            step_peaks, marks = [], []

            def per_step(i, st, met):
                torch.cuda.synchronize()
                step_peaks.append(torch.cuda.max_memory_allocated() / 1e9)
                marks.append(len(torch.cuda.memory._snapshot()[
                    "device_traces"][0]))
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, hist = train_loop(cfg, rt, tc, stream, scheduler=sched,
                                     state=state, num_steps=args.steps,
                                     log_every=0, device=dev,
                                     callback=per_step)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            trace = snap["device_traces"][0]
            rebuilt, at, alive = _live_at_peak(trace, base)
            print(f"\n[{case}] held before the loop {base / 1e9:.2f} GB; "
                  f"peak per step {[round(p, 2) for p in step_peaks]} GB "
                  f"(from the trace {rebuilt / 1e9:.2f} GB at event {at} "
                  f"of {len(trace)}, steps end at {marks}); step ms "
                  f"{[round(h['time_s'] * 1e3, 1) for h in hist]}; "
                  f"{wall:.1f} s")
            print(f"  made in the loop and alive at the peak: "
                  f"{sum(a[0] for a in alive) / 1e9:.2f} GB in "
                  f"{len(alive)} blocks; the largest (GB, event, stream):")
            for size, i, strm in alive[:args.top]:
                print(f"    {size / 1e9:8.3f}  {i:7d}  {strm}")
            del state, hist, snap, trace, alive, sched
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
