"""The reference's dense layouts on the port's process grid
(``common.sharding``, ``models.parallel``) against the JAX package.

Metadata: for every config of the registry, under ``tp`` and ``zero``, on
the 16 x 16 grid and on the two-pod 32 x 16 grid (the reference's 2 x 16
x 16 mesh), the resolved rules and every leaf's ``logical_to_pspec``
equal the reference's, every parameter leaf's shard shape equals the one
the reference's own ``shape_aware_pspec`` gives (on a duck-typed mesh:
the axis names and the device array's shape are all it reads), the chunk
buffer's the FSSDP layer's ``P(ep_axis, fsdp_axes)``; and a rank's
training-state bytes are the sum of those shards'.  The hoisting budget
counts the ring plan's slots.

Steps on a real 2 x 4 gloo grid (one spawn, ``torch_dist_cases.
layout_rank``), from JAX's single-device weights through
``params_from_jax`` and ``shard_params``: for a smoke MoE config
(gpt-moe-s), one whose KV heads do not divide ``model`` (qwen1.5: 2 over
4), a hybrid (Jamba: Mamba, attention and MoE) and the encoder-decoder
(Whisper), the train step's loss and gathered gradients under ``tp``,
``zero`` and ``tp`` with ``grad_constraint``, and under ``tp`` and
``zero`` the prefill's last logits, every rank's block of the cache, and
a decode step after the prefill.  Tolerances as in
``tests/test_torch_arch_smoke.py``: 1e-5 for the loss and of the largest
logit, 5e-4 of each gradient's largest entry (Whisper's measured ones).

The sequence-sharded decode (``long_500k``'s batch of 1) on a 4 x 1 gloo
grid (``split_kv_rank``): every step's logits equal the unsplit decode's
and JAX's.  One torch intra-op thread.
"""
import dataclasses
import os
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.common import sharding as jshd  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.train import step as jst  # noqa: E402
from repro.train.trainer import HecateScheduler as JScheduler  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common import sharding as shd  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.core import moe as M  # noqa: E402
from repro_torch.core.placement import homogeneous_sharding  # noqa: E402
from repro_torch.launch import inputs  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402
from repro_torch.launch.dryrun import storage_bytes  # noqa: E402
from repro_torch.launch.mesh import ProcessGrid  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve.engine import (build_prefill_step,  # noqa: E402
                                      build_serve_step)
from repro_torch.train.trainer import HecateScheduler  # noqa: E402

import torch_dist_cases as cases  # noqa: E402

ALL = configs.PAPER + configs.ASSIGNED
MESHES = {"16x16": ((16, 16), 1), "2x16x16": ((32, 16), 2)}
B, S, MAX_LEN = 8, 16, 32
# Relative to each tensor's largest entry; 5e-4 for gradients and 1e-5 for
# logits and caches (``tests/test_torch_arch_smoke.py``) but where these
# inputs are ill-conditioned in f32 (measured on the CPU): Whisper's
# gradients lie up to 1.11e-2 from JAX's on the grid (the arch smoke's
# 2.5e-2 kept), its logits 2.98e-4 and its cache 2.45e-4 (the port on one
# device: 3.16e-4 and 2.06e-4); Jamba's gradients 6.69e-4 (one device:
# 6.63e-4), its cache 1.30e-4 (one device: 1.01e-4), its decode logits
# 1.42e-5; gpt-moe-s's decode logits under ``zero`` 1.27e-5 (qwen1.5's on
# one device: 1.12e-5).
GRAD_TOL = {"whisper-medium": 2.5e-2, "jamba-v0.1-52b": 7e-4}
LOGIT_TOL = {"whisper-medium": 3.5e-4, "jamba-v0.1-52b": 2e-5,
             "gpt-moe-s": 1.5e-5}
CACHE_TOL = {"whisper-medium": 3.5e-4, "jamba-v0.1-52b": 1.5e-4}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zero_rules():
    """The reference's ``ZERO_RULES``: ``repro.launch.dryrun`` sets
    ``XLA_FLAGS`` when imported, so it is imported after JAX's backend is
    up and the variable put back."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import ZERO_RULES
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return ZERO_RULES


def _duck_mesh(gshape, pods):
    """What ``resolve_rules`` and ``shape_aware_pspec`` read of a mesh."""
    data, model = gshape
    if pods > 1:
        names, shape = ("pod", "data", "model"), (pods, data // pods, model)
    else:
        names, shape = ("data", "model"), (data, model)
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape),
                                 shape=dict(zip(names, shape)))


def _ref_shard(shape, spec, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        k = 1
        for a in shd.dim_axes(e):
            k *= sizes[a]
        out.append(n // k)
    return tuple(out)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["tp", "zero"])
@pytest.mark.parametrize("arch", ALL)
def test_every_leaf_shard_equals_the_reference_shape_aware_pspec(arch, mode,
                                                                 mesh):
    gshape, pods = MESHES[mesh]
    jm = _duck_mesh(gshape, pods)
    rules = jshd.resolve_rules(jm, _zero_rules() if mode == "zero" else None)
    prules = shd.resolve_rules(jm.axis_names, shd.mode_rules(mode))
    assert prules == rules
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    grid = ProcessGrid(gshape[0], gshape[1], 0, None, None, pod=pods)
    layouts = dict(_flat(mdl.param_layouts(cfg, grid, mode)))
    decls = dict(_flat(jmdl.param_decls(jcfg, gshape[1])))
    assert sorted(layouts) == sorted(decls)
    want_bytes = 0
    for path, p in decls.items():
        if path == ("moe_buffer",):
            spec = ("model", jinputs.batch_axes(jm))   # P(ep_axis, fsdp_axes)
        else:
            spec = jshd.shape_aware_pspec(p.shape, p.axes, rules, jm)
        want = _ref_shard(p.shape, spec, jm)
        got = shd.shard_shape(p.shape, layouts[path], grid.sizes)
        assert got == want, (path, got, want)
        assert shd.logical_to_pspec(p.axes, prules) == tuple(
            jshd.logical_to_pspec(p.axes, rules)), path
        size = np.dtype(p.dtype or cfg.param_dtype).itemsize
        want_bytes += int(np.prod(want)) * (size + 8)  # + f32 mu, nu
    from torch._subclasses.fake_tensor import FakeTensorMode
    lay = mdl.make_layout(cfg, grid, mode, global_batch=256)
    state = inputs.abstract_state(cfg, grid, FakeTensorMode(), lay)
    assert storage_bytes(state) == want_bytes + 2 * 4  # + count, step



def test_hoisting_budget_counts_the_plan_s_slots():
    """``train.step.hoisted_bytes`` counts each MoE layer's slots as the
    ring plan's tables size them on the 16 x 16 grid (local rows plus
    extra slots), in the compute dtype, with a microbatch's cotangent and
    their f32 sum in ``save`` mode: under ``HOIST_BYTES`` for gpt-moe-s
    and olmoe, over it for Jamba (whose step then gathers per
    microbatch)."""
    from repro_torch.train import step as st
    grid = ProcessGrid(16, 16, 0, None, None)
    got = {}
    for arch in ("gpt-moe-s", "olmoe-1b-7b", "jamba-v0.1-52b"):
        cfg = configs.get(arch)
        pa = inputs.concrete_plan(cfg, 16, "ring", device="cpu")
        k = pa.local_rows.shape[-1] + pa.extra_experts.shape[-1]
        n = pa.local_rows.shape[0] * k * M.chunk_len(cfg)
        assert cfg.dtype == "bfloat16"
        per = 2 * 2 + 4 if cfg.moe.rematerialize == "save" else 2
        assert st.hoisted_bytes(cfg, grid) == n * per, arch
        got[arch] = st.hoisted_bytes(cfg, grid) <= st.HOIST_BYTES
    assert got == {"gpt-moe-s": True, "olmoe-1b-7b": True,
                   "jamba-v0.1-52b": False}


# ---------------------------------------------------------------------------
# steps on a 2 x 4 gloo grid against JAX's single device
# ---------------------------------------------------------------------------
def _jax_setup(name, b, s, seed=0):
    """JAX's smoke config (the MoE capacity factor of ``cases.layout_cfg``,
    which the mesh-less JAX layer does not read), its weights, a batch of
    ``b`` rows (tokens: ``s + 1`` a row; Whisper: frames too) and the ``ep``
    plan."""
    cfg = cases.layout_cfg(name)
    jcfg = jconfigs.get_smoke(name)
    if jcfg.moe.enabled:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cfg.moe.capacity_factor))
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        batch["encoder_input"] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model), np.float32)
    jpa = (JScheduler(jcfg, ep=1, impl="ep").plan_arrays()
           if jcfg.moe.enabled else None)
    return cfg, jcfg, jparams, batch, jpa


def _pad_cache(cache, n):
    out = {}
    for name, leaves in cache.items():
        if isinstance(leaves, dict) and "k" in leaves:
            out[name] = {k: jnp.pad(t, ((0, 0), (0, 0), (0, n - t.shape[2]),
                                        (0, 0), (0, 0)))
                         for k, t in leaves.items()}
        else:
            out[name] = leaves
    return out


def _jax_layout_side(name):
    cfg, jcfg, jparams, batch, jpa = _jax_setup(name, B, S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jst.loss_fn(jcfg, jmdl.Runtime(), p, jb, jpa),
        has_aux=True))(jparams)
    pb = {k: v[:, :-1] if k == "tokens" else v for k, v in jb.items()}
    last, cache = jax.jit(jeng.build_prefill_step(jcfg, jmdl.Runtime()))(
        jparams, pb, jpa)
    nxt = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 1)
                                            ).astype(np.int32)
    logits, _ = jax.jit(lambda p, c, t: jmdl.decode_step(
        jcfg, jmdl.Runtime(), p, c, t, jnp.int32(S), jpa))(
            jparams, _pad_cache(cache, MAX_LEN), jnp.asarray(nxt))
    np_tree = jax.tree.map(np.asarray, jparams)
    return {"rank_inputs": {"params": np_tree, "batch": batch,
                            "next": nxt, "max_len": MAX_LEN},
            "loss": float(jm["loss"]),
            "grads": {"/".join(p): np.asarray(g) for p, g in _flat(jg)},
            "last": np.asarray(last),
            "cache": {"/".join(p): np.asarray(t) for p, t in _flat(cache)},
            "decode": np.asarray(logits)}


@pytest.fixture(scope="module")
def layout_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("layouts")
    want = {name: _jax_layout_side(name) for name in cases.LAYOUT_ARCHS}
    path = str(d / "inputs.pt")
    torch.save({n: w["rank_inputs"] for n, w in want.items()}, path)
    got = spawn(cases.layout_rank, (2, 4), "cpu", workdir=str(d / "ranks"),
                args=(path,), timeout=600)
    return want, got


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    scale = max(1e-12, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=tol * scale, rtol=0, err_msg=what)


def _buffer_rows_to_one(cfg, g, ep):
    """A grid's buffer gradient (rows of ``ep`` ranks) in the single
    device's row order."""
    L, E = M.num_moe_layers(cfg), cfg.moe.num_experts
    src, _ = shd.elastic_row_remap(homogeneous_sharding(L, E, ep),
                                   homogeneous_sharding(L, E, 1),
                                   M.buffer_rows(cfg, 1))
    return g[src]


@pytest.mark.parametrize("train", ["tp/False", "zero/False", "tp/True"])
@pytest.mark.parametrize("name", cases.LAYOUT_ARCHS)
def test_train_step_loss_and_gradients_match_jax(layout_runs, name, train):
    """Every rank's loss, and every leaf's gradient gathered from the
    shards, against ``jax.value_and_grad`` of the reference's loss on one
    device (the buffer's rows re-laid out from the grid's EP size)."""
    want, got = layout_runs
    w = want[name]
    cfg = cases.layout_cfg(name)
    for r in got:
        _close(r[name][f"train/{train}"]["loss"], w["loss"], 1e-5, "loss")
    grads = got[0][name][f"train/{train}"]["grads"]
    assert sorted(grads) == sorted(w["grads"])
    for k, g in grads.items():
        if k == "moe_buffer":
            g = _buffer_rows_to_one(cfg, g, 4)
        _close(g, w["grads"][k], GRAD_TOL.get(name, 5e-4), k)


@pytest.mark.parametrize("mode", ["tp/8", "zero/8", "zero/2"])
@pytest.mark.parametrize("name", cases.LAYOUT_ARCHS)
def test_prefill_logits_cache_and_decode_match_jax(layout_runs, name, mode):
    """The prefill's last-position logits, each rank's block of the cache
    (its rows, its KV heads, its Mamba channels and heads) and the next
    token's decode logits against JAX's single device, under ``tp`` and
    ``zero`` on the 8 rows (``zero`` splits them over both axes) and
    under ``zero`` on the first 2 (split over ``data`` alone, replicated
    over ``model``: the vocabulary then runs tensor-parallel and the MoE
    layer takes a share of the rows)."""
    want, got = layout_runs
    w = want[name]
    tol = LOGIT_TOL.get(name, 1e-5)
    ctol = CACHE_TOL.get(name, 1e-5)
    rows = int(mode.split("/")[1])
    for r in got:
        res = r[name][f"serve/{mode}"]
        _close(res["last"], w["last"][:rows], tol, "prefill logits")
        assert sorted(res["cache"]) == sorted(w["cache"])
        for k, t in res["cache"].items():
            idx = tuple(slice(None) if sl is None else slice(*sl)
                        for sl in res["slices"][k])
            ref = w["cache"][k][idx]
            assert t.shape == ref.shape, (k, t.shape, ref.shape)
            _close(t, ref, ctol, k)
        _close(res["decode"], w["decode"][:rows], tol, "decode logits")


# ---------------------------------------------------------------------------
# the sequence-sharded decode on a 4 x 1 gloo grid
# ---------------------------------------------------------------------------
SPLIT_PROMPT, SPLIT_LEN = 40, 64        # gemma2's window: 32


def _split_kv_side(name):
    """JAX's and the unsplit port's decode of one sequence: the prompt's
    prefill into a cache of ``SPLIT_LEN`` positions, then the remaining
    tokens one by one (logits of each step)."""
    cfg, jcfg, jparams, _, jpa = _jax_setup(name, 1, SPLIT_PROMPT)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, SPLIT_PROMPT + 4)).astype(np.int32)
    _, jc = jeng.build_prefill_step(jcfg, jmdl.Runtime())(
        jparams, {"tokens": jnp.asarray(toks[:, :SPLIT_PROMPT])}, jpa)
    jc = _pad_cache(jc, SPLIT_LEN)
    step = jax.jit(lambda c, t, i: jmdl.decode_step(
        jcfg, jmdl.Runtime(), jparams, c, t, i, jpa))
    np_tree = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_tree, "cpu")
    pa = (HecateScheduler(cfg, ep=1, impl="ep", device="cpu").plan_arrays()
          if cfg.moe.enabled else None)
    rt = mdl.Runtime(use_pallas=False)
    tt = torch.from_numpy(toks)
    _, tc = build_prefill_step(cfg, rt)(params, {"tokens": tt[:, :SPLIT_PROMPT]},
                                        pa)
    tc = cases._pad_seq_cache(cfg, tc, SPLIT_LEN)
    tstep = build_serve_step(cfg, rt)
    jax_l, port_l = [], []
    for i in range(SPLIT_PROMPT, toks.shape[1]):
        lg, jc = step(jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        jax_l.append(np.asarray(lg)[:, 0])
        lt, tc = tstep(params, tc, tt[:, i:i + 1], i, pa)
        port_l.append(lt[:, 0].numpy())
    return ({"params": np_tree, "tokens": toks, "prompt": SPLIT_PROMPT,
             "max_len": SPLIT_LEN},
            np.stack(jax_l, 1), np.stack(port_l, 1))


# the whole model's f32 rounding, measured on the CPU: the grid's logits
# lie 5.06e-6 (Gemma-2) and 9.44e-6 (Jamba, whose MoE layer runs the
# FSSDP layer on the grid) of the largest from the unsplit decode's, and
# 4.52e-5 and 3.04e-5 from JAX's, where the unsplit decode lies 4.01e-5
# and 2.38e-5 from JAX's
SPLIT_TOL = {"gemma2-9b": (7e-6, 5e-5), "jamba-v0.1-52b": (1.2e-5, 4e-5)}


def test_sequence_sharded_decode_equals_the_unsplit_one(tmp_path):
    """Batch 1 on a 4 x 1 grid: the decode cache sequence-sharded over
    ``data`` (16 positions a rank), Gemma-2's window of 32 and its logit
    softcap across the shards, Jamba's attention among its Mamba layers.
    On every rank one decode attention (global and windowed) over the
    sharded cache equals the same attention over the whole cache within
    1e-6 of its largest output in f32, and the logits of 4 decode steps
    after a prefill equal the unsplit decode's and JAX's (``SPLIT_TOL``,
    of the largest logit)."""
    sides = {n: _split_kv_side(n) for n in cases.SPLIT_KV_ARCHS}
    path = str(tmp_path / "inputs.pt")
    torch.save({n: v[0] for n, v in sides.items()}, path)
    got = spawn(cases.split_kv_rank, (4, 1), "cpu",
                workdir=str(tmp_path / "ranks"), args=(path,), timeout=300)
    for name, (_, jax_l, port_l) in sides.items():
        to_port, to_jax = SPLIT_TOL[name]
        for r in got:
            assert max(r[name]["attention"].values()) <= 1e-6, r[name]
            _close(r[name]["logits"], port_l, to_port,
                   f"{name}: against the unsplit")
            _close(r[name]["logits"], jax_l, to_jax, f"{name}: against JAX")
