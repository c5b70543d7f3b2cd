"""Rank functions of the port's multi-rank tests.

``repro_torch.launch.distributed.spawn`` runs each of these on every rank
of a process grid, in a fresh interpreter that imports this module: it
imports torch and ``repro_torch`` only, never JAX.  Each reads its inputs
(made by the JAX package in the test's own subprocess) from an ``.npz``
and returns numpy results for the test to compare on the parent.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.config import ModelConfig, MoEConfig
from repro_torch.configs import get_smoke
from repro_torch.core import moe as M
from repro_torch.core.placement import (ep_materialization,
                                        homogeneous_sharding)
from repro_torch.core.schedule import (heterogeneous_sharding,
                                       sparse_materialization)
from repro_torch.launch.mesh import make_debug_mesh

TINY = ModelConfig(name="tiny", arch_type="moe", num_layers=1, d_model=16,
                   num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=128,
                   moe=MoEConfig(num_experts=8, experts_per_token=2,
                                 d_ff=24),
                   dtype="float32")
MOE_TAGS = ("ring", "a2a", "dense", "ep", "a2a-hetero")
# and olmoe's smoke config (GLU experts with SiLU) through the ring plan
OLMOE = get_smoke("olmoe-1b-7b").replace(dtype="float32")
LAYER_TAGS = MOE_TAGS + ("olmoe",)
TABLES = ("local_rows", "local_experts", "extra_experts", "ring_send_rows")


def moe_plans(loads, ep: int):
    """The plans of ``tests/test_moe_distributed.py``, made by the port."""
    sh = homogeneous_sharding(1, 8, ep)
    sh_het = heterogeneous_sharding(loads, ep, t=4, k_local=4)
    return {"ring": sparse_materialization(sh, loads, t=8, m=2, impl="ring"),
            "a2a": sparse_materialization(sh, loads, t=8, m=2, impl="a2a"),
            "dense": sparse_materialization(sh, loads, t=8, m=0,
                                            impl="dense"),
            "ep": ep_materialization(sh),
            "a2a-hetero": sparse_materialization(sh_het, loads, t=8, m=2,
                                                 impl="a2a")}


class _IndexOps(TorchDispatchMode):
    """Records every gather / scatter op with its input and output shapes."""
    KINDS = ("index", "gather", "index_select", "index_put", "scatter",
             "index_add", "take")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in self.KINDS and isinstance(args[0], torch.Tensor) \
                and isinstance(out, torch.Tensor):
            self.seen.append((name, tuple(args[0].shape), tuple(out.shape)))
        return out


def _layer(grid, tag, plan, x, wr, buf_full, capacity, use_pallas=False,
           local_first=True, spy=False, cfg=TINY):
    """One forward and backward of the layer on this rank: its output rows,
    its buffer shard's gradient, the aux and the collective record."""
    pa = M.plan_to_arrays(plan, "cpu").layer(0)
    rt = M.MoERuntime(grid=grid, impl=plan.impl, capacity=capacity,
                      use_pallas=use_pallas, local_first=local_first)
    n = x.shape[0] // grid.size
    # the spied call also differentiates the tokens: its backward then
    # runs both token all-to-alls in reverse
    xl = torch.from_numpy(x[grid.rank * n:(grid.rank + 1) * n]) \
        .requires_grad_(spy)
    buf = M.shard_buffer(torch.from_numpy(buf_full), grid).requires_grad_()
    mode = _IndexOps() if spy else None
    M.reset_collective_counts()
    with mode if spy else contextlib.nullcontext():
        y, aux = M.moe_layer(cfg, rt, xl, torch.from_numpy(wr), buf, pa)
        fwd = M.collective_counts()
        M.reset_collective_counts()
        g = torch.autograd.grad((y ** 2).sum(),
                                [buf] + ([xl] if spy else []))[0]
    out = {"y": y.detach().numpy(), "g": g.numpy(),
           "dropped": float(aux.dropped_frac),
           "dev_loads": aux.device_loads.numpy(),
           "pad_frac": float(aux.pad_frac), "fwd": fwd,
           "bwd": M.collective_counts(),
           "K": pa.local_rows.shape[-1] + pa.extra_experts.shape[-1]}
    if spy:
        out["index_ops"] = mode.seen
    return out


def moe_rank(grid, npz: str):
    """The FSSDP layer on a 2 x 4 grid, then the dispatch laws on a 1 x 8
    grid over the same eight ranks."""
    z = np.load(npz)
    x, wr, loads = z["x"], z["wr"], z["loads"]
    plans = moe_plans(loads, grid.model)
    res = {"tables": {tag: {t: np.asarray(getattr(p, t)) for t in TABLES}
                      for tag, p in plans.items()}}
    for tag in MOE_TAGS:
        res[tag] = _layer(grid, tag, plans[tag], x, wr, z[f"{tag}/buf"], 64)
    res["row_valid"] = _layer(grid, "ring", plans["ring"], x, wr,
                              z["ring/buf"], 64, use_pallas=True, spy=True)
    res["drop"] = _layer(grid, "ring", plans["ring"], x, wr, z["ring/buf"],
                         z["drop/capacity"].item())
    E, L = OLMOE.moe.num_experts, M.num_moe_layers(OLMOE)
    plan = sparse_materialization(homogeneous_sharding(L, E, grid.model),
                                  z["olmoe/loads"], t=E, m=2, impl="ring")
    res["olmoe"] = _layer(grid, "olmoe", plan, z["olmoe/x"], z["olmoe/wr"],
                          z["olmoe/buf"], 64, cfg=OLMOE)
    # the volume laws at a small capacity, as tests/test_collective_volume.py
    res["volume"] = {tag: _layer(grid, tag, plans[tag], x, wr,
                                 z[f"{tag}/buf"], 8)
                     for tag in ("ring", "a2a", "ep")}
    # tests/test_dispatch.py: every mass on expert 0, a 1 x 8 grid
    g18 = make_debug_mesh(1, 8)
    dl = np.full((1, 16), 0.01)
    dl[0, 0] = 1.0
    sh = heterogeneous_sharding(dl, 8, t=2)
    plan = sparse_materialization(sh, dl, t=16, m=6, impl="ring")
    cfg = ModelConfig(name="d", arch_type="moe", num_layers=1, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                      moe=MoEConfig(num_experts=16, experts_per_token=1,
                                    d_ff=64), dtype="float32")
    pa = M.plan_to_arrays(plan, "cpu").layer(0)
    xd = torch.from_numpy(z["disp/x"])
    n = xd.shape[0] // 8
    buf = M.shard_buffer(torch.from_numpy(z["disp/buf"]), g18)
    res["dispatch"] = {"hosts0": np.nonzero(plan.slot_tables()[1][0, :, 0]
                                            >= 0)[0]}
    for lf in (True, False):
        rt = M.MoERuntime(grid=g18, impl="ring", capacity=4096,
                          use_pallas=False, local_first=lf)
        with torch.no_grad():
            _, aux = M.moe_layer(cfg, rt, xd[g18.rank * n:(g18.rank + 1) * n],
                                 torch.from_numpy(z["disp/wr"]), buf, pa)
        res["dispatch"][lf] = (aux.device_loads.numpy(),
                               float(aux.dropped_frac))
    return res


# ---------------------------------------------------------------------------
# training: smoke gpt-moe-s on a 2 x 4 grid
# ---------------------------------------------------------------------------
def _smoke_setup(grid, npz):
    import repro_torch.configs as configs
    from repro_torch.common.params import params_from_jax
    from repro_torch.models import model as mdl
    z = np.load(npz)
    cfg = configs.get_smoke("gpt-moe-s")
    tree = {}
    for k in z.files:
        if k.startswith("params/"):
            node = tree
            *path, leaf = k.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    params = mdl.shard_params(params_from_jax(tree, "cpu"), grid)
    rt = mdl.Runtime(use_pallas=False, moe=M.MoERuntime(
        grid=grid, impl="ring", capacity=16))
    return z, cfg, params, rt


def train_rank(grid, npz: str):
    """One step's loss and gradients, then two steps of the Hecate loop
    with the plan each rank used at each step."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.params import _leaves
    from repro_torch.data.pipeline import host_slice
    from repro_torch.train import step as st
    from repro_torch.train.trainer import HecateScheduler, train_loop
    z, cfg, params, rt = _smoke_setup(grid, npz)
    L, E = M.num_moe_layers(cfg), cfg.moe.num_experts
    plan = sparse_materialization(homogeneous_sharding(L, E, grid.model),
                                  np.ones((L, E)), t=4, m=1, impl="ring")
    toks = z["tokens"][host_slice(z["tokens"].shape[0], grid.rank,
                                  grid.size)]
    metrics, grads = st.loss_and_grads(
        cfg, rt, params, {"tokens": torch.from_numpy(toks)},
        M.plan_to_arrays(plan, "cpu"))
    out = {"loss": float(metrics["loss"]),
           "grads": {"/".join(p): g.numpy() for p, g in _leaves(grads)}}
    sched = HecateScheduler(cfg, ep=grid.model, impl="ring", t=4,
                            device="cpu")
    plans = []
    plan_arrays = sched.plan_arrays

    def recorded():
        pa = plan_arrays()
        plans.append([t.numpy().copy() for t in pa])
        return pa
    sched.plan_arrays = recorded
    batches = iter([{"tokens": z["loop_tokens"][i]} for i in range(2)])
    _, hist = train_loop(cfg, rt, TrainConfig(learning_rate=3e-3,
                                              warmup_steps=1,
                                              total_steps=2),
                         batches, scheduler=sched,
                         state=_fresh_state(params), num_steps=2,
                         log_every=0, device="cpu")
    out.update(loop_losses=[h["loss"] for h in hist], plans=plans,
               predicted=sched.predictor.predict())
    from repro_torch.data.pipeline import make_stream
    from repro_torch.launch.distributed import host_stream, process_info
    out["host_batch"] = next(host_stream(
        make_stream, vocab_size=cfg.vocab_size, seq_len=8, global_batch=16,
        seed=3))["tokens"]
    out["info"] = process_info()
    return out


# ---------------------------------------------------------------------------
# overlap and re-materialization: the remat modes, hoisting, resharding
# ---------------------------------------------------------------------------
REMAT_MODES = (("save", "save", True, True), ("gather", "gather", True, True),
               ("gather_nobp", "gather", True, False),
               ("block", "block", True, True),
               ("save_serial", "save", False, True))


def with_mode(cfg, mode, pipeline=True, bwd_prefetch=True):
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, rematerialize=mode, pipeline=pipeline,
        bwd_prefetch=bwd_prefetch))


def _ring_plan(cfg, ep, m=1):
    L, E = M.num_moe_layers(cfg), cfg.moe.num_experts
    return sparse_materialization(homogeneous_sharding(L, E, ep),
                                  np.ones((L, E)), t=4, m=m, impl="ring")


def _hops(coll):
    return sum(coll.get(k, {"calls": 0})["calls"]
               for k in ("spag_ring", "sprs_ring"))


def _kept_for_backward(cfg, rt, params, batch, pa, slot_numel):
    """Slot-shaped tensors the forward keeps for the backward: those the
    saved-tensor hooks see, and the inputs the non-reentrant checkpoints
    keep for their recompute (a tensor both see counts once)."""
    from repro_torch.models import model as mdl
    from repro_torch.train import step as st
    saved, kept = [], []
    real = mdl.checkpoint

    def spy(fn, *args, **kw):
        kept.extend((a.data_ptr(), tuple(a.shape)) for a in args
                    if isinstance(a, torch.Tensor))
        return real(fn, *args, **kw)

    def pack(t):
        saved.append((t.data_ptr(), tuple(t.shape)))
        return t

    mdl.checkpoint = spy
    try:
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            st.loss_fn(cfg, rt, params, batch, pa)
    finally:
        mdl.checkpoint = real
    slot = {s for s in saved + kept if int(np.prod(s[1])) == slot_numel}
    return len(slot), len(saved), len(kept)


def remat_rank(grid, npz: str):
    """Loss, gradients, ring hops, event log and the slot-shaped tensors
    kept for the backward of each remat mode on smoke gpt-moe-s (remat on),
    then the pipeline flag on a 1 x 1 grid of the same world."""
    from repro_torch.common.params import _leaves
    from repro_torch.data.pipeline import host_slice
    from repro_torch.train import step as st
    z, cfg, params, rt = _smoke_setup(grid, npz)
    cfg = cfg.replace(remat=True)
    st._require_grad(params)
    pa = M.plan_to_arrays(_ring_plan(cfg, grid.model), "cpu")
    toks = z["tokens"][host_slice(z["tokens"].shape[0], grid.rank,
                                  grid.size)]
    batch = {"tokens": torch.from_numpy(toks)}
    K = pa.local_rows.shape[-1] + pa.extra_experts.shape[-1]
    out = {"K": K, "m": pa.extra_experts.shape[-1],
           "L": M.num_moe_layers(cfg)}
    for tag, mode, pipeline, bp in REMAT_MODES:
        c = with_mode(cfg, mode, pipeline, bp)
        M.enable_event_log()
        M.reset_collective_counts()
        try:
            metrics, grads = st.loss_and_grads(c, rt, params, batch, pa)
            events = M.event_log()
        finally:
            M.enable_event_log(False)
        out[tag] = {"loss": float(metrics["loss"]),
                    "grads": {"/".join(p): g.numpy()
                              for p, g in _leaves(grads)},
                    "hops": _hops(M.collective_counts()), "events": events,
                    "kept": _kept_for_backward(c, rt, params, batch, pa,
                                               K * M.chunk_len(c))}
    return out


def overlap_cfg(mode: str, num_layers: int = 4):
    """The model of ``tests/test_step_overlap.py``."""
    return ModelConfig(
        name="t", arch_type="moe", num_layers=num_layers, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff=256,
                      slots_per_device=2, rematerialize=mode),
        act="gelu", norm="ln", remat=False, dtype="float32")


def _np_tree(z, prefix):
    from repro_torch.common.params import params_from_jax
    tree = {}
    for k in z.files:
        if k.startswith(prefix + "/"):
            node = tree
            *path, leaf = k.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return params_from_jax(tree, "cpu")


def _clone(t):
    if isinstance(t, dict):
        return {k: _clone(v) for k, v in t.items()}
    return t.detach().clone()


def _fresh_state(params):
    """A train state of copies of ``params`` (the step updates in place)."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as st
    p = _clone(params)
    return st.TrainState(p, adamw.init(p), torch.zeros((), dtype=torch.int32))


def overlap_rank(grid, npz: str):
    """The hoisted accumulated step: gathers and hops per step for n = 1,
    2, 4 in both modes, the updated parameters against the per-microbatch
    baseline at n = 4, and at n = 2 for the JAX package's step."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.params import _leaves
    from repro_torch.data.pipeline import microbatch_rows
    from repro_torch.models import model as mdl
    from repro_torch.train import step as st
    z = np.load(npz)
    # 2 microbatches: the JAX package's batch; else 32 rows, 1 per rank
    # and microbatch at n = 4
    big = np.random.default_rng(1).integers(0, 512, (32, 17))
    params = mdl.shard_params(_np_tree(z, "params"), grid)
    rt = mdl.Runtime(use_pallas=False, moe=M.MoERuntime(
        grid=grid, impl="ring", capacity=16))
    out = {}
    for mode in ("save", "gather"):
        cfg = overlap_cfg(mode)
        pa = M.plan_to_arrays(_ring_plan(cfg, grid.model), "cpu")
        for n, hoist in ((1, None), (2, None), (4, None), (4, False)):
            toks = z["tokens"] if n == 2 else big
            batch = {"tokens": torch.from_numpy(toks[microbatch_rows(
                toks.shape[0], grid.rank, grid.size, n)])}
            fn = st.build_train_step(cfg, rt, TrainConfig(
                microbatch=n, learning_rate=1e-3), hoist_premat=hoist)
            M.enable_event_log()
            M.reset_collective_counts()
            try:
                state, metrics = fn(_fresh_state(params), batch, pa)
                events = M.event_log()
            finally:
                M.enable_event_log(False)
            out[(mode, n, hoist)] = {
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "params": {"/".join(p): t.detach().numpy()
                           for p, t in _leaves(state.params)},
                "mu": {"/".join(p): t.numpy()
                       for p, t in _leaves(state.opt.mu)},
                "hops": _hops(M.collective_counts()), "events": events}
    return out


def reshard_rank(grid, npz: str):
    """``apply_reshard`` of random buffer, mu and nu shards by the JAX
    package's permutation, then two Hecate-loop steps resharding every
    step from skewed loads."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.schedule import ReshardingPolicy
    from repro_torch.optim import adamw
    from repro_torch.train import step as st
    from repro_torch.train.trainer import (HecateScheduler, apply_reshard,
                                           train_loop)
    z, cfg, params, rt = _smoke_setup(grid, npz)

    def shard(a):
        return M.shard_buffer(torch.from_numpy(a), grid)
    state = st.TrainState(
        {"moe_buffer": shard(z["rs/buf"])},
        adamw.OptState({"moe_buffer": shard(z["rs/mu"])},
                       {"moe_buffer": shard(z["rs/nu"])},
                       torch.zeros((), dtype=torch.int32)),
        torch.zeros((), dtype=torch.int32))
    apply_reshard(state, z["rs/perm"], grid)
    assert grid.model > 1    # the all-to-all, not the local gather
    out = {"moved": {k: t["moe_buffer"].numpy() for k, t in (
        ("buf", state.params), ("mu", state.opt.mu), ("nu", state.opt.nu))}}
    sched = HecateScheduler(cfg, ep=grid.model, impl="ring", t=4,
                            device="cpu", calibrate=False,
                            resharding=ReshardingPolicy(interval=1, t=2))
    for _ in range(3):
        sched.observe(z["skew"])
    batches = iter([{"tokens": z["loop_tokens"][i]} for i in range(2)])
    _, hist = train_loop(cfg, rt, TrainConfig(learning_rate=3e-3,
                                              warmup_steps=1,
                                              total_steps=2),
                         batches, scheduler=sched,
                         state=_fresh_state(params), num_steps=2,
                         log_every=0, device="cpu")
    out.update(loop_losses=[h["loss"] for h in hist],
               owner_dev=sched.sharding.owner_dev,
               owner_row=sched.sharding.owner_row,
               plan_ahead_hits=sched.plan_ahead_hits)
    out["faults"] = {site: _planner_fault_loop(grid, z, cfg, params, site)
                     for site in ("scheduler.plan_job",
                                  "scheduler.plan_job_hang")}
    return out


def _planner_fault_loop(grid, z, cfg, params, site):
    """Three loop steps of the a2a plan (Algorithm 1's ring plan of the
    smoke model does not depend on the loads) with plan-ahead on, ``site``
    armed on rank 0 only
    at the first plan-ahead job: the tables of the plan each step used,
    those of Algorithm 1 on the prediction at that point (which the
    prefetched plan, one observation stale, need not equal), the losses
    and the fallbacks.  One small observation with a hot last expert
    comes first, so the observed counts move the prediction."""
    from repro_torch.common import faults
    from repro_torch.common.config import TrainConfig
    from repro_torch.models import model as mdl
    from repro_torch.train.trainer import HecateScheduler, train_loop
    rt = mdl.Runtime(use_pallas=False, moe=M.MoERuntime(
        grid=grid, impl="a2a", capacity=16))
    sched = HecateScheduler(cfg, ep=grid.model, impl="a2a", t=4,
                            device="cpu", calibrate=False,
                            plan_timeout_s=0.5)
    pre = np.full((M.num_moe_layers(cfg), cfg.moe.num_experts), 0.01)
    pre[:, -1] = 0.02
    sched.observe(pre)
    plans, now = [], []
    plan_arrays = sched.plan_arrays

    def recorded():
        pa = plan_arrays()
        plans.append([t.numpy().copy() for t in pa])
        fresh = sched._alg1(sched.sharding, sched.predictor.predict())
        now.append([t.numpy().copy() for t in M.tables_to_device(
            M.plan_tables(fresh), "cpu")])
        return pa
    sched.plan_arrays = recorded
    if grid.rank == 0:
        faults.inject(site, **({"hang_s": 3600.0} if "hang" in site else {}))
    try:
        batches = iter([{"tokens": z["loop_tokens"][i]} for i in (0, 1, 0)])
        _, hist = train_loop(cfg, rt, TrainConfig(learning_rate=3e-3,
                                                  warmup_steps=1,
                                                  total_steps=3),
                             batches, scheduler=sched,
                             state=_fresh_state(params), num_steps=3,
                             log_every=0, device="cpu")
    finally:
        faults.clear(site)                  # releases a hung job
    return {"plans": plans, "now": now,
            "losses": [h["loss"] for h in hist],
            "fallbacks": sched.plan_fallbacks,
            "hits": sched.plan_ahead_hits}


# ---------------------------------------------------------------------------
# checkpoints on a process grid
# ---------------------------------------------------------------------------
class PermuteOnce:
    """A resharding policy that permutes the buffer rows of every device
    once, at step ``at`` (the port of the JAX package's
    ``_ForcedPermuteReshard``): no expert changes owner, but the rows of
    the parameters and both moments move, which a resume must follow."""

    def __init__(self, at: int, seed: int = 0):
        self.at, self.seed = at, seed

    def maybe_reshard(self, step, current, predictor):
        import dataclasses
        if step != self.at:
            return current, False
        perm = np.random.default_rng(self.seed).permutation(
            current.rows_per_device).astype(np.int32)
        new = dataclasses.replace(current, owner_row=perm[current.owner_row])
        new.validate()
        return new, True


def ckpt_cfg():
    """The 2-layer model of the checkpoint and elastic cases."""
    return overlap_cfg("save", num_layers=2)


def ckpt_tokens(n: int = 8, rows: int = 8):
    return np.random.default_rng(0).integers(0, 512, (n, rows, 9)) \
        .astype(np.int32)


def ckpt_rank(grid, workdir: str):
    """Checkpoints on a grid in ``save`` mode, with one row-permuting
    reshard at step 1: (a) 6 steps uninterrupted; (b) 4 steps saving
    every 2, then an auto-resume to 6; (c) step 4's arrays bit-flipped by
    rank 0, a resume from step 2 to 6; (d) ``checkpoint.save_crash``
    armed on rank 0 only, in a fresh directory: what each rank raised and
    what the directory holds after."""
    import os

    from repro_torch.common import faults
    from repro_torch.common.config import TrainConfig
    from repro_torch.models import model as mdl
    from repro_torch.train.trainer import HecateScheduler, train_loop
    import torch.distributed as dist
    cfg = ckpt_cfg()
    rt = mdl.Runtime(use_pallas=False, moe=M.MoERuntime(
        grid=grid, impl="ring", capacity=32))
    toks = ckpt_tokens()

    def run(n, **tc_kw):
        tc = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=6,
                         keep_checkpoints=2, **tc_kw)
        sched = HecateScheduler(cfg, ep=grid.model, impl="ring", t=4,
                                device="cpu", calibrate=False,
                                resharding=PermuteOnce(at=1))
        _, hist = train_loop(cfg, rt, tc,
                             iter([{"tokens": t} for t in toks]),
                             scheduler=sched, num_steps=n, log_every=0,
                             device="cpu")
        return [(h["step"], h["loss"], h["resumes"]) for h in hist]

    ck = os.path.join(workdir, "ck")
    out = {"a": run(6), "b1": run(4, checkpoint_dir=ck, checkpoint_every=2)}
    out["b2"] = run(6, checkpoint_dir=ck)
    dist.barrier()
    if grid.rank == 0:
        faults.bitflip_file(os.path.join(ck, "step_00000004", "arrays.npz"))
    dist.barrier()
    out["c"] = run(6, checkpoint_dir=ck)
    crash = os.path.join(workdir, "crash")
    if grid.rank == 0:
        faults.inject("checkpoint.save_crash")
    try:
        run(4, checkpoint_dir=crash, checkpoint_every=2)
        out["d_raised"] = None
    except Exception as e:
        out["d_raised"] = f"{type(e).__name__}: {e}"
    finally:
        faults.clear()
    dist.barrier()
    out["d_listing"] = sorted(os.listdir(crash))
    return out


# ---------------------------------------------------------------------------
# elastic recovery on a process grid
# ---------------------------------------------------------------------------
def _elastic_rt(grid, capacity=64):
    from repro_torch.models import model as mdl
    return mdl.Runtime(use_pallas=False, moe=M.MoERuntime(
        grid=grid, impl="ring", capacity=capacity))


def _ring_pa(cfg, ep, m=1):
    L, E = M.num_moe_layers(cfg), cfg.moe.num_experts
    return M.plan_to_arrays(sparse_materialization(
        homogeneous_sharding(L, E, ep), np.ones((L, E)), t=4, m=m,
        impl="ring"), "cpu")


def _steps(cfg, rt, tc, state, pa, batches, grid):
    """The train step over ``batches`` (each rank its rows): losses, and
    whether any token dropped."""
    from repro_torch.data.pipeline import microbatch_rows
    from repro_torch.train import step as st
    fn = st.build_train_step(cfg, rt, tc)
    losses, dropped = [], 0.0
    for b in batches:
        rows = microbatch_rows(b.shape[0], grid.rank, grid.size, 0)
        state, m = fn(state, {"tokens": torch.from_numpy(b[rows])}, pa)
        losses.append(float(m["loss"]))
        dropped = max(dropped, float(m["dropped_frac"]))
    return state, losses, dropped


def _rejoin_after_shrink():
    """A supervisor of ep 4 whose lost device rejoins once the shrink is
    done (its ``mesh.device_lost`` fault cleared)."""
    from repro_torch.common import faults
    from repro_torch.train.supervisor import TrainSupervisor

    class RejoinAfterShrink(TrainSupervisor):
        def on_shrunk(self, ep_new, steps_lost):
            super().on_shrunk(ep_new, steps_lost)
            faults.clear("mesh.device_lost")

    sup = RejoinAfterShrink(ep=4, min_ep=1, runtime_factory=lambda ep:
                            _elastic_rt(sup.grid_for(ep)))
    return sup


def elastic_rank(grid, workdir: str):
    """On 4 ranks.  (1) The elastic restore of ``tests/test_serve_fleet.
    py``: 8 steps on a (2, 2) grid; 4 steps, a checkpoint, and a resume
    onto a (1, 4) grid (the buffer and both moments re-laid-out) that runs
    steps 4..7.  (2) The in-process shrink of ``tests/
    test_elastic_recovery.py`` on (1, 4): a kill-and-restart reference (4
    steps on ep 4 with checkpoints, then an elastic resume on the first 3
    ranks to step 8) and the same run with a supervisor, whose
    ``mesh.device_lost`` of EP rank 3 at step 4 shrinks it in-process to
    ep 3 (rank 3 a spare), and whose cleared fault grows it back at the
    step-6 checkpoint."""
    import os

    from repro_torch.common import faults
    from repro_torch.common.config import TrainConfig
    from repro_torch.launch.mesh import make_grid, surviving_grid
    from repro_torch.train import step as st
    from repro_torch.train.metrics import RobustnessCounters
    from repro_torch.train.supervisor import TrainSupervisor
    from repro_torch.train.trainer import (HecateScheduler,
                                           resume_train_state,
                                           save_train_state, train_loop)
    import torch.distributed as dist
    cfg = ckpt_cfg()
    toks = ckpt_tokens(8, 12)
    out = {}

    # (1) checkpoint on (2, 2), resume on (1, 4)
    g22 = make_grid(2, 2)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, keep_checkpoints=0,
                     checkpoint_dir=os.path.join(workdir, "ck22"), seed=0)
    rt22, pa2 = _elastic_rt(g22), _ring_pa(cfg, 2)
    _, out["restore_a"], drop_a = _steps(
        cfg, rt22, tc, st.init_state(cfg, 0, 2, "cpu", g22), pa2, toks, g22)
    state, _, _ = _steps(cfg, rt22, tc, st.init_state(cfg, 0, 2, "cpu", g22),
                         pa2, toks[:4], g22)
    sched2 = HecateScheduler(cfg, ep=2, impl="ring", device="cpu",
                             async_plan=False, calibrate=False)
    sched2.plan_arrays()                # the live plan: its sharding saved
    save_train_state(tc, 4, st.TrainState(state.params, state.opt,
                                          state.step * 0 + 4), sched2, g22)
    del state
    g14 = make_grid(1, 4)
    sched4 = HecateScheduler(cfg, ep=4, impl="ring", device="cpu",
                             async_plan=False, calibrate=False)
    counters = RobustnessCounters()
    state, at = resume_train_state(cfg, tc, sched4, 4, counters=counters,
                                   device="cpu", grid=g14)
    out["restore_at"] = at
    out["restore_events"] = counters.elastic_restores
    out["restore_ep"] = sched4.sharding.num_devices
    _, out["restore_b"], drop_b = _steps(cfg, _elastic_rt(g14), tc, state,
                                         _ring_pa(cfg, 4), toks[4:], g14)
    out["restore_dropped"] = max(drop_a, drop_b)
    del state

    # (2) in-process shrink and grow-back on (1, 4)
    def tc_for(d):
        return TrainConfig(learning_rate=1e-3, warmup_steps=2,
                           total_steps=8, checkpoint_dir=os.path.join(
                               workdir, d), checkpoint_every=2,
                           keep_checkpoints=0, seed=0)

    def sched(ep):
        return HecateScheduler(cfg, ep=ep, impl="ring", device="cpu",
                               async_plan=False, calibrate=False)

    def batches():
        return iter([{"tokens": t} for t in toks])
    g13 = surviving_grid(g14, 3)        # collective: every rank
    _, h1 = train_loop(cfg, _elastic_rt(g14), tc_for("ckA"), batches(),
                       scheduler=sched(4), num_steps=4, log_every=0,
                       device="cpu")
    ref = {h["step"]: h["loss"] for h in h1}
    if g13 is not None:                 # the restarted run on 3 ranks
        _, h2 = train_loop(cfg, _elastic_rt(g13), tc_for("ckA"), batches(),
                           scheduler=sched(3), num_steps=8, log_every=0,
                           device="cpu")
        ref.update({h["step"]: h["loss"] for h in h2})
    dist.barrier()

    sup = _rejoin_after_shrink()
    faults.inject("mesh.device_lost", only=3, after=4, times=None)
    try:
        state, hist = train_loop(cfg, _elastic_rt(g14), tc_for("ckB"),
                                 batches(), scheduler=sched(4), num_steps=8,
                                 log_every=0, device="cpu", supervisor=sup)
    finally:
        faults.clear()
    out.update(ref=ref, got={h["step"]: h["loss"] for h in hist},
               dropped=[h.get("dropped_frac", 0.0) for h in hist],
               last={k: hist[-1][k] for k in (
                   "device_losses", "elastic_shrinks", "grow_backs",
                   "elastic_restores")} if hist else None,
               sup_state=sup.state, sup_ep=sup.ep,
               recoveries=[{k: r[k] for k in ("ep_from", "ep_to",
                                              "steps_lost", "site")}
                           for r in sup.recoveries],
               final_step=int(state.step),
               buf_rows=int(state.params["moe_buffer"].shape[0]))
    return out


def straggler_rank(grid):
    """On a (1, 3) grid: a persistently slow EP rank 0
    (``mesh.slow_device``, armed on every rank) is de-weighted after the
    supervisor's calibration, and the reshard at step 4 gives it fewer
    expert slots than before and than its peers, as in ``tests/
    test_elastic_recovery.py``."""
    from repro_torch.common import faults
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.schedule import ReshardingPolicy
    from repro_torch.train.supervisor import TrainSupervisor
    from repro_torch.train.trainer import HecateScheduler, train_loop
    cfg = ckpt_cfg()
    toks = ckpt_tokens(8, 12)
    rt = _elastic_rt(grid)
    sched = HecateScheduler(cfg, ep=3, impl="ring", device="cpu",
                            async_plan=False, calibrate=False,
                            resharding=ReshardingPolicy(interval=4, t=2))
    sup = TrainSupervisor(ep=3, runtime_factory=lambda ep: rt,
                          calibration_steps=3, straggler_ratio=1.5)
    share0 = int((sched.sharding.owner_dev == 0).sum())
    faults.inject("mesh.slow_device", mutate=faults.slow_device(0, 6.0),
                  times=None)
    try:
        _, hist = train_loop(cfg, rt, TrainConfig(
            learning_rate=1e-3, warmup_steps=2, total_steps=8, seed=0),
            iter([{"tokens": t} for t in toks]), scheduler=sched,
            num_steps=8, log_every=0, device="cpu", supervisor=sup)
    finally:
        faults.clear()
    return {"weights": sup.device_weights(),
            "deweighted": hist[-1]["stragglers_deweighted"],
            "share0": share0,
            "share1": int((sched.sharding.owner_dev == 0).sum()),
            "peers1": [int((sched.sharding.owner_dev == d).sum())
                       for d in (1, 2)],
            "owner_dev": sched.sharding.owner_dev,
            "dropped": max(h["dropped_frac"] for h in hist),
            "losses": [h["loss"] for h in hist]}


# ---------------------------------------------------------------------------
# serving and publication on the grid: smoke gpt-moe-s on a 2 x 4 grid
# ---------------------------------------------------------------------------
SPAG = ("spag_ring", "spag_a2a", "spag_dense", "spag_fsdp")
# what a decode step on cached slots may issue: the gate's all-reduce, the
# token all-to-alls and the kept counts beside them, and the loads' sum
LAYER_ONLY = {"gate_stats", "tokens_out", "tokens_back", "counts",
              "dev_loads"}


def _spag_calls():
    c = M.collective_counts()
    return {k: c[k]["calls"] for k in SPAG if k in c}


class _StackBuilds:
    """Counts ``materialize_stack`` calls (the engine's slot builds)."""

    def __init__(self):
        self.n, self._orig = 0, M.materialize_stack

        def counted(*a, **kw):
            self.n += 1
            return self._orig(*a, **kw)
        M.materialize_stack = counted

    def close(self):
        M.materialize_stack = self._orig


def _serve_setup(grid, npz):
    from repro_torch.models import model as mdl
    z = np.load(npz)
    cfg = get_smoke("gpt-moe-s")
    rt = mdl.Runtime(use_pallas=False, moe=M.MoERuntime(
        grid=grid, impl="ring", capacity=16))
    params = {k: mdl.shard_params(_np_tree(z, k), grid)
              for k in ("params", "params2", "params3")}
    return z, cfg, rt, params, _ring_pa(cfg, grid.model)


def serve_grid_rank(grid, npz: str):
    """The engine on a 2 x 4 grid, the laws of ``tests/
    test_serve_publish.py`` and ``tests/test_serve_batching.py``: this
    rank's slots and greedy tokens (for the JAX engine's on the mesh), the
    decode step's collectives with and without cached slots (dense and
    paged), one stacked build per publication and none at steady state,
    the straddle record and a direct ``eng.params`` swap."""
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.kv_pool import PageTable
    z, cfg, rt, params, pa = _serve_setup(grid, npz)
    p1, p2, p3 = params["params"], params["params2"], params["params3"]
    prompts = z["prompts"]
    L, m = M.num_moe_layers(cfg), pa.extra_experts.shape[-1]
    out = {"L": L, "m": m}
    builds = _StackBuilds()
    try:
        eng = Engine(cfg, rt, p1, max_len=32, pa=pa)
        M.reset_collective_counts()
        slots = eng._materialized()             # the initial lazy build
        out["slots"] = slots.numpy()
        out["build_calls"] = _spag_calls()
        # the decode step: no SparseAllGather on cached slots
        rows = prompts[eng._rows(prompts.shape[0])]
        tok = torch.from_numpy(rows[:, :1].astype(np.int32))
        steps = {}
        with torch.inference_mode():
            for name, premat in (("with", slots), ("without", None)):
                M.reset_collective_counts()
                mdl.decode_step(cfg, rt, p1, mdl.init_cache(cfg, 1, 32, "cpu"),
                                tok, 0, pa, premat=premat)
                steps[("dense", name)] = M.collective_counts()
                table = torch.from_numpy(np.asarray(
                    [PageTable(4, 16, [1, 2]).row_idx()], np.int32))
                M.reset_collective_counts()
                mdl.decode_step(cfg, rt, p1,
                                mdl.init_paged_cache(cfg, 1, 12, "cpu"),
                                tok, torch.tensor([3], dtype=torch.int32),
                                pa, premat=premat, row_idx=table,
                                page_size=4)
                steps[("paged", name)] = M.collective_counts()
        out["steps"] = steps
        # greedy generate; steady state; one publication
        builds.n = 0
        M.reset_collective_counts()
        out["out0"] = eng.generate(prompts, steps=4)
        out["out0b"] = eng.generate(prompts, steps=4)
        out["steady"] = (builds.n, _spag_calls())
        M.reset_collective_counts()
        eng.publish_params(p2, wait=True)
        out["publish"] = (builds.n, _spag_calls(), eng.version)
        # the straddle: a publication lands in the middle of the 4th step
        record = []
        orig_step = eng.step_fn

        def recording_step(p, c, t, pos, pa_, pm):
            which = 2 if p is p2 else (3 if p is p3 else 0)
            record.append((eng.version, id(pm), which))
            if len(record) == 4:
                eng.publish_params(p3, version=2, wait=True)
            return orig_step(p, c, t, pos, pa_, pm)
        eng.step_fn = recording_step
        out["out1"] = eng.generate(prompts, steps=4)
        eng.step_fn = orig_step
        ids = [r[1] for r in record]
        out["straddle"] = dict(
            versions=[r[0] for r in record], which=[r[2] for r in record],
            swapped=ids[3] != ids[4], cached=len(set(ids[4:])) == 1,
            builds=builds.n, version=eng.version)
        out["out2"] = eng.generate(prompts, steps=4)
        with Engine(cfg, rt, p3, max_len=32, pa=pa, version=2) as fresh:
            out["fresh3"] = fresh.generate(prompts, steps=4)
        eng.close()
        # a direct params swap: the buffer's identity beats the counters
        with Engine(cfg, rt, p1, max_len=32, pa=pa) as eng2:
            out["swap_a"] = eng2.generate(prompts, steps=3)
            eng2.params = p3
            out["swap_b"] = eng2.generate(prompts, steps=3)
        with Engine(cfg, rt, p3, max_len=32, pa=pa) as fresh:
            out["swap_fresh"] = fresh.generate(prompts, steps=3)
    finally:
        builds.close()
    return out


def _hung_on_one_rank(grid, cfg, rt, pa, *trees):
    """C16: two replicas behind each rank's bus; replica ``h1``'s staged
    build hangs on rank 0 only, and the engines' ages read a clock the
    test sets.  Every poll's states are all-gathered (and a disagreement
    raises at once, so a split fleet cannot hang the flush after it): the
    hung replica lags on every rank at t = 1, catches up on every rank
    once its build is released, lags again and is evicted on every rank
    at t = 10 on the next publication's hang, and ``h0`` promotes the
    publication after that on every rank."""
    import time
    import types
    import warnings

    import torch.distributed as dist

    from repro_torch.common import faults
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.bus import PublicationBus
    from repro_torch.serve.engine import Engine

    def wait_for(cond, what):
        deadline = time.monotonic() + 60.0
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"rank {grid.rank}: not reached "
                                     f"within 60 s: {what}")
            time.sleep(0.005)

    def built(version, hung):
        """Each replica staged ``version``; its build done unless it is
        the one hung on this rank."""
        wait_for(lambda: all(
            e.health().staged_version == version
            and e.health().staged_pending == (hung and e.name == "h1")
            for e in engines), f"v{version} staged and built")

    def hang():
        if grid.rank == 0:
            faults.inject("replica.build_hang", only="h1", hang_s=120.0,
                          times=None)

    polls = []

    def poll():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            states = tuple(st.state for st in bus.poll().values())
        every = [None] * grid.size
        dist.all_gather_object(every, states)
        polls.append(every)
        if len(set(every)) != 1:
            raise AssertionError(f"the ranks' buses disagree after poll "
                                 f"{len(polls)}: {every}")

    clock = types.SimpleNamespace(t=0.0)
    clock.monotonic = lambda: clock.t
    real_time, engine_mod.time = engine_mod.time, clock
    engines, bus = [], None
    try:
        engines = [Engine(cfg, rt, trees[0], max_len=32, pa=pa,
                          name=f"h{i}") for i in range(2)]
        bus = PublicationBus([(e.name, e) for e in engines],
                             build_deadline_s=0.2, evict_deadline_s=3.0)
        hang()
        bus.publish_params(trees[1], version=1)
        built(1, grid.rank == 0)
        poll()                              # t = 0: nothing is late
        clock.t = 1.0
        poll()                              # h1 lags on every rank
        routed = [e.name for e in bus.route()]
        faults.clear()                      # rank 0's build completes
        built(1, False)
        poll()                              # h1 caught up on every rank
        hang()
        bus.publish_params(trees[0], version=2)
        built(2, grid.rank == 0)
        clock.t = 1.5
        poll()                              # lags again ...
        clock.t = 10.0
        poll()                              # ... and is evicted
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            bus.publish_params(trees[1], version=3, wait=True)
        return dict(polls=polls, routed=routed,
                    versions=[e.version for e in engines],
                    evictions=bus.replica_evictions)
    finally:
        faults.clear()
        if bus is not None:
            bus.close()
        for e in engines:
            e.close()
        engine_mod.time = real_time


def serve_fleet_rank(grid, npz: str):
    """On a 2 x 4 grid: four same-host replicas behind a bus (one build
    per publication, ``dedup_hits``, a crash, an eviction and a rejoin),
    the continuous-batching scheduler in lockstep (a bus publication in
    flight while it ticks included), and ``train_loop`` publishing a
    resharded buffer into a live engine."""
    import threading
    import warnings

    from repro_torch.common import faults
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.params import snapshot
    from repro_torch.core.schedule import ReshardingPolicy
    from repro_torch.serve.bus import PublicationBus
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import TERMINAL, RequestScheduler
    from repro_torch.train.trainer import HecateScheduler, train_loop
    z, cfg, rt, params, pa = _serve_setup(grid, npz)
    p1, p2, p3 = params["params"], params["params2"], params["params3"]
    prompts = z["prompts"]
    out = {}
    builds = _StackBuilds()
    try:
        # four replicas on one host
        engines = [Engine(cfg, rt, p1, max_len=32, pa=pa, name=f"r{i}")
                   for i in range(4)]
        bus = PublicationBus([(e.name, e) for e in engines],
                             max_retries=1, backoff_s=0.01)
        builds.n = 0
        M.reset_collective_counts()
        bus.publish_params(p2, version=1, wait=True)
        out["dedup"] = (builds.n, _spag_calls(), bus.dedup_hits,
                        [e.version for e in engines])
        outs = [e.generate(prompts, steps=3) for e in engines]
        with Engine(cfg, rt, p2, max_len=32, pa=pa, version=1) as fresh:
            ref = fresh.generate(prompts, steps=3)
        out["dedup_equal"] = all((o == ref).all() for o in outs)
        out["dedup_tokens"] = outs[0]
        faults.inject("replica.crash", only="r1", times=None)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            bus.publish_params(p3, version=2, wait=True)
        states = bus.poll()
        out["crash"] = (states["r1"].state, len(bus.route()),
                        [e.version for e in engines])
        faults.clear()
        builds.n = 0
        M.reset_collective_counts()
        out["rejoin"] = (bus.rejoin("r1"), engines[1].version, builds.n,
                         _spag_calls())
        ref2 = engines[0].generate(prompts, steps=3)
        out["rejoin_tokens"] = ref2
        out["rejoin_equal"] = bool(
            (engines[1].generate(prompts, steps=3) == ref2).all())
        out["fleet_dedup_hits"] = bus.dedup_hits
        bus.close()
        for e in engines:
            e.close()

        out["c16"] = _hung_on_one_rank(grid, cfg, rt, pa, p1, p2)

        # a bus publication in flight while the scheduler ticks, with no
        # flush: ranks 0..3 stage it before the first tick, ranks 4..7
        # only after the third, so for three ticks some ranks have a
        # triple staged and the others do not
        engines = [Engine(cfg, rt, p1, max_len=32, pa=pa, name=f"s{i}")
                   for i in range(2)]
        bus = PublicationBus([(e.name, e) for e in engines])
        staged, release = threading.Event(), threading.Event()
        if grid.rank < 4:
            release.set()
        stage = engines[0].publish_params

        def late(*a, **kw):
            release.wait(timeout=120)
            v = stage(*a, **kw)
            staged.set()
            return v
        engines[0].publish_params = late
        versions = []
        snap = engines[0]._snapshot

        def recorded_snapshot():
            got = snap()
            versions.append(engines[0].version)
            return got
        engines[0]._snapshot = recorded_snapshot
        with RequestScheduler(engines[0], max_slots=8, num_pages=40,
                              page_size=4, max_kv=32) as rs:
            reqs = [rs.submit(z[f"req{i}"], max_new_tokens=int(n))
                    for i, n in enumerate(z["req_new"])]
            bus.publish_params(p2, version=1)
            if grid.rank < 4:
                staged.wait(timeout=120)
            ticks = 0
            while ticks < 200 and any(r.state not in TERMINAL
                                      for r in reqs):
                rs.step()
                ticks += 1
                if ticks == 3:
                    release.set()
            release.set()
            out["inflight"] = dict(
                outputs=[r.output() for r in reqs],
                states=[r.state for r in reqs], ticks=ticks,
                deferred=engines[0].deferred_boundaries)
        bus.flush()
        out["inflight"].update(versions=versions,
                               final=[e.version for e in engines])
        bus.close()
        for e in engines:
            e.close()

        # the scheduler in lockstep (its ranks 5..7 own idle slots)
        with Engine(cfg, rt, p1, max_len=32, pa=pa) as eng:
            with RequestScheduler(eng, max_slots=8, num_pages=40,
                                  page_size=4, max_kv=32) as rs:
                reqs = [rs.submit(z[f"req{i}"], max_new_tokens=int(n))
                        for i, n in enumerate(z["req_new"])]
                rs.run(max_ticks=200)
                out["sched"] = dict(
                    outputs=[r.output() for r in reqs],
                    states=[r.state for r in reqs],
                    ticks=rs.decode_ticks)
    finally:
        builds.close()

    # train_loop resharding every step and publishing after every step
    sched = HecateScheduler(cfg, ep=grid.model, impl="ring", t=4,
                            device="cpu", calibrate=False,
                            resharding=ReshardingPolicy(interval=1, t=2))
    for _ in range(3):
        sched.observe(z["skew"])
    eng = Engine(cfg, rt, snapshot(p1), max_len=32, pa=pa)
    eng.generate(prompts, steps=1)
    published = []
    publish = eng.publish_params

    def recorded(params_, version=None, **kw):
        published.append((version, kw.get("pa")))
        return publish(params_, version=version, **kw)
    eng.publish_params = recorded
    state, hist = train_loop(cfg, rt, TrainConfig(
        learning_rate=3e-3, warmup_steps=1, total_steps=2),
        iter([{"tokens": z["loop_tokens"][i]} for i in range(2)]),
        scheduler=sched, state=_fresh_state(p1), num_steps=2,
        log_every=0, device="cpu", publish_engine=eng, publish_every=1)
    eng.flush()
    last_pa = published[-1][1]
    out["f1"] = dict(
        versions=[v for v, _ in published],
        with_plan=[p is not None for _, p in published],
        engine_pa_is_published=eng.pa is last_pa,
        version=eng.version, moved=bool((sched.sharding.owner_dev !=
                                         z["homog_owner_dev"]).any()),
        drops=hist[-1]["publish_drops"],
        tokens=eng.generate(prompts, steps=3),
        slots=eng._materialized().numpy())
    with Engine(cfg, rt, snapshot(state.params), max_len=32, pa=last_pa,
                version=eng.version) as fresh:
        out["f1"]["fresh"] = fresh.generate(prompts, steps=3)
        out["f1"]["fresh_slots"] = fresh._materialized().numpy()
    with Engine(cfg, rt, snapshot(state.params), max_len=32, pa=pa,
                version=eng.version) as stale:
        out["f1"]["stale_slots"] = stale._materialized().numpy()
    eng.close()
    return out


def elastic_publish_rank(grid, workdir: str):
    """On (1, 4): the in-process shrink of ``elastic_rank`` (EP rank 3
    lost at step 4, grown back at the step-6 checkpoint) with the loop
    publishing after every step into an engine on the full grid: the
    versions it published, which carried a plan, and the engine's tokens
    beside a fresh engine's at the trainer's (params, pa, version)."""
    import os

    from repro_torch.common import faults
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.params import snapshot
    from repro_torch.serve.engine import Engine
    from repro_torch.train import step as st
    from repro_torch.train.trainer import HecateScheduler, train_loop
    cfg = ckpt_cfg()
    toks = ckpt_tokens(8, 12)
    sup = _rejoin_after_shrink()
    rt = _elastic_rt(grid)
    state = st.init_state(cfg, 0, 4, "cpu", grid)
    prompts = toks[0][:4, :3]
    eng = Engine(cfg, rt, snapshot(state.params), max_len=16,
                 pa=_ring_pa(cfg, 4))
    published = []
    publish = eng.publish_params

    def recorded(params_, version=None, **kw):
        published.append((version, kw.get("pa")))
        return publish(params_, version=version, **kw)
    eng.publish_params = recorded
    faults.inject("mesh.device_lost", only=3, after=4, times=None)
    try:
        state, hist = train_loop(
            cfg, rt, TrainConfig(learning_rate=1e-3, warmup_steps=2,
                                 total_steps=8, checkpoint_every=2,
                                 checkpoint_dir=os.path.join(workdir, "ck"),
                                 keep_checkpoints=0, seed=0),
            iter([{"tokens": t} for t in toks]),
            scheduler=HecateScheduler(cfg, ep=4, impl="ring", device="cpu",
                                      async_plan=False, calibrate=False),
            state=state, num_steps=8, log_every=0, device="cpu",
            supervisor=sup, publish_engine=eng, publish_every=1)
    finally:
        faults.clear()
    eng.flush()
    out = dict(versions=[v for v, _ in published],
               with_plan=[p is not None for _, p in published],
               engine_pa_is_published=eng.pa is [
                   p for _, p in published if p is not None][-1],
               version=eng.version,
               last={k: hist[-1][k] for k in ("elastic_shrinks",
                                              "grow_backs",
                                              "publish_drops")},
               tokens=eng.generate(prompts, steps=3))
    with Engine(cfg, rt, snapshot(state.params), max_len=16, pa=eng.pa,
                version=eng.version) as fresh:
        out["fresh"] = fresh.generate(prompts, steps=3)
    eng.close()
    return out


# ---------------------------------------------------------------------------
# the dry run's volume law: tests/test_collective_volume.py's configuration
# (olmoe's smoke experts in f32, EP 4 on a 2 x 4 grid, 64 tokens, capacity
# 8, m = 2), the MoE layer's forward through the ring, a2a and ep plans
# ---------------------------------------------------------------------------
VOLUME_EP, VOLUME_T, VOLUME_CAP, VOLUME_M = 4, 64, 8, 2


def volume_inputs(cfg=OLMOE):
    """(plans, router, tokens, full buffer) of the volume law, numpy."""
    L, E = M.num_moe_layers(cfg), cfg.moe.num_experts
    loads = np.linspace(2, 1, E)[None].repeat(L, 0)
    sh = homogeneous_sharding(L, E, VOLUME_EP)
    plans = {impl: sparse_materialization(sh, loads, t=E, m=VOLUME_M,
                                          impl=impl)
             for impl in ("ring", "a2a")}
    plans["ep"] = ep_materialization(sh)
    rng = np.random.default_rng(0)
    wr = (rng.standard_normal((cfg.d_model, E)) * 0.1).astype(np.float32)
    x = rng.standard_normal((VOLUME_T, cfg.d_model)).astype(np.float32)
    buf = rng.standard_normal((M.buffer_rows(cfg, VOLUME_EP),
                               M.chunk_len(cfg))).astype(np.float32)
    return plans, wr, x, buf


def volume_layer(grid, plan, x, wr, buf_shard, cfg=OLMOE):
    """The forward of MoE layer 0 on this rank's rows of ``x`` (tensors,
    real or fake; ``buf_shard`` this rank's shard of the buffer)."""
    pa = M.plan_to_arrays(plan, "cpu").layer(0)
    rt = M.MoERuntime(grid=grid, impl=plan.impl, capacity=VOLUME_CAP,
                      use_pallas=False)
    n = x.shape[0] // grid.size
    with torch.no_grad():
        return M.moe_layer(cfg, rt, x[grid.rank * n:(grid.rank + 1) * n],
                           wr, buf_shard, pa)


def volume_rank(grid):
    """Each plan's collective record of the layer's forward."""
    plans, wr, x, buf = volume_inputs()
    shard = M.shard_buffer(torch.from_numpy(buf), grid)
    out = {}
    for tag, plan in plans.items():
        M.reset_collective_counts()
        volume_layer(grid, plan, torch.from_numpy(x), torch.from_numpy(wr),
                     shard)
        out[tag] = M.collective_counts()
    return out
