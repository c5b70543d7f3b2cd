"""The one-layer-ahead SparseAllGather and the three remat modes of the
port on a process grid, against the JAX package.

The JAX side (one ``run_distributed`` subprocess, 8 host devices, an
``.npz`` written once for the module) takes ``jax.value_and_grad`` of
smoke gpt-moe-s's train loss with ``remat`` on, the ring plan, ``m = 1``
and ``capacity = 16`` on a (2, 4) mesh, in ``save``, ``gather`` (with and
without ``bwd_prefetch``) and ``block`` mode.  The port side runs every
mode, and ``save`` without the pipeline, on 8 gloo ranks of a 2 x 4 grid
with the weights carried over through numpy (``tests/torch_dist_cases.py
::remat_rank``), with the event log on (the port of
``tests/test_pipeline_remat.py``'s jaxpr walks).  Loss to 1e-5, every
gradient leaf to 1e-4 of its largest value; the call-order and ring-hop
laws; the slot-shaped tensors each mode keeps for the backward.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402

JAX_SCRIPT = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs.gpt_moe_s import smoke
from repro.core.placement import homogeneous_sharding
from repro.core.schedule import sparse_materialization
from repro.core import moe as moe_core
from repro.models import model as mdl
from repro.train import step as jst

cfg = smoke().replace(remat=True)
EP = 4
mesh = jax.make_mesh((2, EP), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,)*2)
L = moe_core.num_moe_layers(cfg)
E = cfg.moe.num_experts
plan = sparse_materialization(homogeneous_sharding(L, E, EP),
                              np.ones((L, E)), t=4, m=1, impl="ring")
pa = moe_core.plan_to_arrays(plan)
rt = mdl.Runtime(mesh=mesh, moe=moe_core.MoERuntime(
    mesh=mesh, batch_axes=("data",), impl="ring", m=1, capacity=16))
params = mdl.init_params(cfg, jax.random.PRNGKey(0), ep=EP)
tokens = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (8, 17)).astype(np.int32)
out = {"tokens": tokens}


def flat(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + "/" + k)
    else:
        yield prefix, np.asarray(tree)


out.update(dict(flat(params, "params")))
for tag, mode, bp in (("save", "save", True), ("gather", "gather", True),
                      ("gather_nobp", "gather", False),
                      ("block", "block", True)):
    c = cfg.replace(moe=dataclasses.replace(cfg.moe, rematerialize=mode,
                                            bwd_prefetch=bp))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jst.loss_fn(c, rt, p, {"tokens": jnp.asarray(tokens)}, pa),
        has_aux=True))(params)
    out[tag + "/loss"] = np.asarray(loss)
    out.update(dict(flat(grads, tag + "/grads")))
np.savez(%(out)r, **out)
print("JAX REMAT ORACLE WRITTEN")
"""

JAX_TAGS = ("save", "gather", "gather_nobp", "block")


@pytest.fixture(scope="module")
def both(tmp_path_factory, dist):
    d = tmp_path_factory.mktemp("remat")
    npz = str(d / "jax.npz")
    out = dist(JAX_SCRIPT % {"out": npz}, n_devices=8)
    assert "JAX REMAT ORACLE WRITTEN" in out
    ranks = spawn(cases.remat_rank, (2, 4), "cpu", workdir=str(d / "ranks"),
                  args=(npz,), timeout=300)
    return dict(np.load(npz)), ranks


def _grad(ranks, tag, name, data=2, model=4):
    """A leaf's gradient: rank 0's for a replicated leaf (equal on every
    rank), the buffer assembled from its shards."""
    if name != "moe_buffer":
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[tag]["grads"][name],
                                          ranks[0][tag]["grads"][name])
        return ranks[0][tag]["grads"][name]
    return np.concatenate([
        np.concatenate([ranks[d * model + e][tag]["grads"][name]
                        for d in range(data)], axis=1)
        for e in range(model)])


def _idx(events, kind, layer, phase):
    got = [i for i, e in enumerate(events) if e == (kind, layer, phase)]
    assert got, (kind, layer, phase)
    return got


@pytest.mark.parametrize("tag", JAX_TAGS)
def test_mode_matches_jax_grad_of_the_same_mode(both, tag):
    """Loss within 1e-5 and every gradient leaf within 1e-4 of its
    largest value of ``jax.grad`` in the same mode on the mesh."""
    jx, ranks = both
    losses = {r[tag]["loss"] for r in ranks}
    assert len(losses) == 1, losses
    assert abs(losses.pop() - float(jx[f"{tag}/loss"])) <= 1e-5
    names = sorted(ranks[0][tag]["grads"])
    assert len(names) == len([k for k in jx if k.startswith(f"{tag}/grads/")])
    for name in names:
        want = jx[f"{tag}/grads/{name}"]
        got = _grad(ranks, tag, name)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= 1e-4 * scale, (tag, name)


@pytest.mark.parametrize("tag", ["gather", "gather_nobp", "block",
                                 "save_serial"])
def test_modes_agree_with_save(both, tag):
    """Every mode computes the same loss and gradients as ``save`` to 1e-5
    relative."""
    _, ranks = both
    a, b = ranks[0][tag], ranks[0]["save"]
    assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    for name in b["grads"]:
        for r in (0, 5):
            ga, gb = ranks[r][tag]["grads"][name], ranks[r]["save"]["grads"][
                name]
            scale = max(float(np.abs(gb).max()), 1e-30)
            assert np.abs(ga - gb).max() <= 1e-5 * scale, (tag, name)


@pytest.mark.parametrize("tag,law", [("save", 2), ("gather", 3),
                                     ("gather_nobp", 3), ("block", 3),
                                     ("save_serial", 2)])
def test_ring_hops_per_step(both, tag, law):
    """``save`` 2·m·L (L gathers, L SparseReduceScatters), ``gather`` and
    ``block`` 3·m·L (each layer's slots are gathered once more in the
    backward), on every rank."""
    _, ranks = both
    r0 = ranks[0]
    assert r0["m"] == 1 and r0["L"] == 2
    for r in ranks:
        assert r[tag]["hops"] == law * r0["m"] * r0["L"], (tag, r[tag]["hops"])


def test_save_forward_gathers_one_layer_ahead(both):
    """In the forward of ``save``: one SparseAllGather per MoE layer, and
    layer l+1's is issued before layer l's grouped FFN; none in the
    backward."""
    _, ranks = both
    L = ranks[0]["L"]
    for r in ranks:
        ev = r["save"]["events"]
        spag = [e for e in ev if e[0] == "spag"]
        assert spag == [("spag", l, "fwd") for l in range(L)], spag
        for l in range(L - 1):
            assert _idx(ev, "spag", l + 1, "fwd")[0] \
                < _idx(ev, "ffn", l, "fwd")[0]


def test_serial_save_gathers_only_inside_each_layer(both):
    """``pipeline=False``: each layer's gather comes after the previous
    layer's grouped FFN and before its own: no gather runs ahead."""
    _, ranks = both
    L = ranks[0]["L"]
    ev = ranks[0]["save_serial"]["events"]
    assert [e for e in ev if e[0] == "spag"] == [("spag", l, "fwd")
                                                 for l in range(L)]
    for l in range(L):
        s = _idx(ev, "spag", l, "fwd")[0]
        assert s < _idx(ev, "ffn", l, "fwd")[0]
        if l:
            assert s > _idx(ev, "ffn", l - 1, "fwd")[0]


def test_gather_backward_regathers_one_layer_ahead(both):
    """``gather`` with ``bwd_prefetch``: the last layer gathers its own
    slots first (warm-up); layer l-1's re-gather is issued before layer
    l's backward grouped FFN (its recompute, then dgrad and wgrad); each
    layer's SparseReduceScatter comes after its kernels; no re-gather
    before the first layer."""
    _, ranks = both
    L = ranks[0]["L"]
    for r in ranks:
        ev = r["gather"]["events"]
        bwd = [e for e in ev if e[2] == "bwd" and e[0] == "spag"]
        assert bwd == [("spag", l, "bwd") for l in reversed(range(L))], bwd
        for l in range(1, L):
            assert _idx(ev, "spag", l - 1, "bwd")[0] \
                < _idx(ev, "ffn", l, "bwd")[0]
        for l in range(L):
            assert _idx(ev, "ffn", l, "bwd")[0] \
                < _idx(ev, "ffn_bwd", l, "bwd")[0] \
                < _idx(ev, "ffn_bwd_end", l, "bwd")[0] \
                < _idx(ev, "sprs", l, "bwd")[0]


def test_gather_without_bwd_prefetch_regathers_its_own_layer(both):
    """``bwd_prefetch=False``: each layer's backward re-gathers its own
    slots, right before its recompute."""
    _, ranks = both
    L = ranks[0]["L"]
    ev = ranks[0]["gather_nobp"]["events"]
    for l in range(L):
        s = _idx(ev, "spag", l, "bwd")[0]
        assert s < _idx(ev, "ffn", l, "bwd")[0]
        if l + 1 < L:
            assert s > _idx(ev, "sprs", l + 1, "bwd")[0]


@pytest.mark.parametrize("tag,law", [("save", 2), ("gather", 0),
                                     ("gather_nobp", 0), ("block", 0)])
def test_slot_shaped_tensors_kept_for_the_backward(both, tag, law):
    """``gather`` keeps no (K, chunk_len) tensor for the backward (neither
    a saved tensor nor a checkpoint input); ``save`` keeps one per MoE
    layer, the checkpointed layer's slots; ``block`` keeps only each
    superblock's input."""
    _, ranks = both
    for r in ranks:
        slot, n_saved, n_kept = r[tag]["kept"]
        assert slot == law, (tag, slot)
        assert n_saved + n_kept > 0


def test_pipeline_flag_is_inert_without_a_grid():
    """Without a process grid the pipeline is off and the forward is the
    world-size-1 path, bit for bit, whatever the flags say."""
    import repro_torch.configs as configs
    from repro_torch.models import model as mdl
    from repro_torch.train.trainer import HecateScheduler
    cfg = configs.get_smoke("gpt-moe-s")
    assert cfg.moe.pipeline and cfg.moe.rematerialize == "save"
    rt = mdl.Runtime(use_pallas=False)
    assert not mdl._use_pipeline(cfg, rt) and not mdl._use_bwd_pipe(cfg, rt)
    pa = HecateScheduler(cfg, device="cpu").plan_arrays()
    params = mdl.init_params(cfg, 0, "cpu")
    toks = torch.zeros((2, 8), dtype=torch.int64)
    outs = []
    for c in (cfg, cases.with_mode(cfg, "save", pipeline=False),
              cases.with_mode(cfg, "gather")):
        with torch.no_grad():
            logits, _ = mdl.forward(c, rt, params, toks, pa=pa)
        outs.append(logits)
    assert outs[0].shape == (2, 8, cfg.vocab_size)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
