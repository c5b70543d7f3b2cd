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
           local_first=True, spy=False):
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
        y, aux = M.moe_layer(TINY, rt, xl, torch.from_numpy(wr), buf, pa)
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
                         batches, scheduler=sched, num_steps=2,
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
