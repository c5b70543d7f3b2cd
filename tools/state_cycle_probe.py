"""Is a dropped training state freed at once, or only by the cyclic
garbage collector?

    python3 tools/state_cycle_probe.py [--device cuda|cpu] [--layers 2]
                                       [--src OTHER_TREE/src]

Runs gpt-moe-s (full width on a card, the smoke config on the CPU) cut to
``--layers`` layers through the train step, first without a process grid
and then on a world-size-1 grid (NCCL on a card, gloo on the CPU; ring
plan, the config's remat mode), and through ``train_loop``.  Each case
makes a state from the seed, steps it, and drops the state and the step's
outputs with the collector disabled.  It prints whether a weak reference
to the chunk buffer died at once, and on a card how far
``torch.cuda.memory_allocated`` fell against the state's bytes; a case
fails when the buffer lived on or, on a card, the memory fell by less
than the state, and the exit code is 1 when any case failed.  Where the
buffer survived, it runs the collector with ``gc.DEBUG_SAVEALL`` and
prints what the collector found unreachable: a census by type, every
frame (function, file, line) and the chain of referrers from the buffer
into that garbage, which names the object that closes the cycle.
``--src`` runs another tree's package (say, an earlier commit unpacked
into a git-ignored directory) through the same cases.
"""
import argparse
import collections
import gc
import os
import sys
import tempfile
import types
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _describe(o) -> str:
    if isinstance(o, types.FrameType):
        return (f"frame {o.f_code.co_name} "
                f"{os.path.basename(o.f_code.co_filename)}:{o.f_lineno}")
    if isinstance(o, dict):
        return f"dict keys={list(o)[:8]}"
    if isinstance(o, (list, tuple)):
        return f"{type(o).__name__} of {len(o)}"
    return f"{type(o).__name__} {repr(o)[:100]}"


def _census(target) -> None:
    """Collect with DEBUG_SAVEALL and print what was unreachable, and the
    referrer chain from ``target`` into it."""
    gc.set_debug(gc.DEBUG_SAVEALL)
    gc.collect()
    gc.set_debug(0)
    garbage = list(gc.garbage)
    gc.garbage.clear()
    ids = {id(o) for o in garbage}
    kinds = collections.Counter(type(o).__name__ for o in garbage)
    print(f"    unreachable: {len(garbage)} objects: "
          f"{kinds.most_common(14)}")
    for o in garbage:
        if isinstance(o, types.FrameType):
            print(f"      {_describe(o)}")
    for o in garbage:
        if type(o).__name__ not in ("tuple", "dict", "list", "cell",
                                    "function", "frame", "Tensor",
                                    "Parameter", "type", "GenericAlias",
                                    "getset_descriptor", "UnionType",
                                    "mappingproxy", "Signature",
                                    "OrderedDict"):
            print(f"      held: {_describe(o)}")
    chain, o, seen = [], target, {id(garbage)}
    for _ in range(12):
        refs = [r for r in gc.get_referrers(o)
                if id(r) in ids and id(r) not in seen]
        if not refs:
            break
        o = refs[0]
        seen.add(id(o))
        chain.append(_describe(o))
    print("    buffer <- " + " <- ".join(chain))
    del garbage


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.moe import MoERuntime
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", 0)
    if cuda:
        torch.cuda.set_device(dev)
    cfg = configs.get("gpt-moe-s") if cuda else \
        configs.get_smoke("gpt-moe-s")
    cfg = cfg.replace(num_layers=args.layers)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=8)
    seq = args.seq if cuda else 16
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, seq + 1)).astype(np.int32)
    store = os.path.join(tempfile.mkdtemp(prefix="cycle_probe_"), "store")
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    grid = make_grid(1, 1)
    bad = 0

    def alloc():
        if cuda:
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated()
        return 0

    def case(name, grid_on, run):
        nonlocal bad
        g = grid if grid_on else None
        rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(
            use_pallas=cuda, grid=g, impl="ring" if grid_on else "ep"))
        sched = HecateScheduler(cfg, ep=1, impl="ring" if grid_on else "ep",
                                device=str(dev))
        gc.collect()
        base = alloc()
        gc.disable()
        try:
            state = step_lib.init_state(cfg, 0, 1, dev, g)
            nbytes = sum(t.numel() * t.element_size() for t in
                         adamw.leaves(state.params)
                         + adamw.leaves(state.opt.mu)
                         + adamw.leaves(state.opt.nu))
            ref = weakref.ref(state.params["moe_buffer"])
            out = run(cfg, rt, sched, state)
            with_state = alloc()
            del state, out
            after = alloc()
            dead = ref() is None
            fell = with_state - after
            print(f"  {name}: buffer freed at once: {dead}; state "
                  f"{nbytes / 1e9:.3f} GB; the drop freed {fell / 1e9:.3f} "
                  f"GB; held after it {(after - base) / 1e9:.3f} GB")
            if not dead or (cuda and fell < nbytes):
                bad += 1
                _census(ref())
        finally:
            gc.enable()
        sched.close()

    def one_step(cfg, rt, sched, state):
        fn = step_lib.build_train_step(cfg, rt, tc)
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        return fn(state, batch, sched.plan_arrays())

    def loop(cfg, rt, sched, state):
        stream = iter([{"tokens": toks}] * 2)
        return train_loop(cfg, rt, tc, stream, scheduler=sched, state=state,
                          num_steps=2, log_every=0, device=dev)

    try:
        case("plain step, first in the process", False, one_step)
        case("plain step, again", False, one_step)
        case("grid step, first on the grid", True, one_step)
        case("grid step, again", True, one_step)
        case("train_loop on the grid, 2 steps", True, loop)
    finally:
        dist.destroy_process_group()
    print(f"state_cycle_probe: {bad} case(s) held the state past the drop")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
