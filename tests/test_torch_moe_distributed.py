"""The port's FSSDP MoE layer across ranks against the JAX package.

The JAX side runs ``tests/test_moe_distributed.py``'s script (same config,
seeds, loads and plans) on a 2 x 4 mesh of 8 host devices in one
``run_distributed`` subprocess, which writes its inputs and outputs to an
``.npz`` once for the module.  The port side runs the same inputs on 8
gloo ranks of a 2 x 4 process grid (``launch.distributed.spawn``, a
``FileStore`` rendezvous under ``tmp_path``, one thread per rank), then the
dispatch laws of ``tests/test_dispatch.py`` on a 1 x 8 grid of the same
ranks (``tests/torch_dist_cases.py::moe_rank``).  Tolerances are the
reference's own: forward 1e-4, buffer gradient 1e-4 relative to its
largest entry.  The volume laws of ``tests/test_collective_volume.py``
are read from the port's own record of the bytes each collective moved
(``core.moe.collective_counts``), and the jaxpr laws of
``tests/test_fused_ffn_path.py`` become call-count laws.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402

JAX_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.common.config import ModelConfig, MoEConfig
from repro.core.placement import homogeneous_sharding, ep_materialization
from repro.core.schedule import sparse_materialization, heterogeneous_sharding
from repro.core import moe as M
from repro.core.moe import PlanArrays

OUT = %(out)r
cfg = ModelConfig(name="tiny", arch_type="moe", num_layers=1, d_model=16,
                  num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=128,
                  moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff=24),
                  dtype="float32")
EP = 4
AX = ("data", "model")
mesh = jax.make_mesh((2, EP), AX,
                     axis_types=(jax.sharding.AxisType.Auto,)*2)
L = M.num_moe_layers(cfg)
sh = homogeneous_sharding(L, 8, EP)
loads = np.arange(8)[::-1].astype(float)[None, :]
key = jax.random.PRNGKey(0)
kb, kw, kx = jax.random.split(key, 3)
rows4 = M.buffer_rows(cfg, EP)
buf = jax.random.normal(kb, (rows4, M.chunk_len(cfg))) * 0.05
wr = jax.random.normal(kw, (cfg.d_model, 8)) * 0.5
x = jax.random.normal(kx, (64, cfg.d_model))
sh1 = homogeneous_sharding(L, 8, 1)
rpd = rows4 // EP
gidx = (sh.owner_dev * rpd + sh.owner_row).reshape(-1)
ref_buf = buf[gidx]
pa1 = PlanArrays(**jax.tree.map(lambda a: a[0],
                 M.plan_to_arrays(ep_materialization(sh1))._asdict()))
y_ref, _ = M.moe_layer(cfg, M.MoERuntime(mesh=None), x, wr, ref_buf, pa1)
g_ref = jax.grad(lambda b: jnp.sum(
    M.moe_layer(cfg, M.MoERuntime(mesh=None), x, wr, b, pa1)[0] ** 2)
    )(ref_buf)
sh_het = heterogeneous_sharding(loads, EP, t=4, k_local=4)
out = dict(x=np.asarray(x), wr=np.asarray(wr), loads=loads,
           y_ref=np.asarray(y_ref), g_ref=np.asarray(g_ref))
xs = jax.device_put(x, NamedSharding(mesh, P(AX, None)))


def per_device_dropped(rt, pa_l, bufs, mesh_, ax):
    # the layer body's own (per-device) dropped fraction
    body = partial(M._moe_body, cfg, rt.impl, "model", rt.batch_axes,
                   M._m_of(rt, pa_l), rt.capacity, False, rt.local_first,
                   False)
    f = shard_map(lambda a, v, w, b, p: body(a, v, w, b, p)[4][None],
                  mesh=mesh_,
                  in_specs=(P(ax, None), P(ax), P(), P("model", "data"),
                            M.plan_arrays_specs(mesh_, "model")),
                  out_specs=P(ax), check_rep=False)
    xs_ = jax.device_put(x, NamedSharding(mesh_, P(ax, None)))
    return np.asarray(jax.jit(f)(xs_, jnp.ones((x.shape[0],), bool), wr,
                                 bufs, pa_l))


def run(tag, shx, plan, cap):
    pa = M.plan_to_arrays(plan)
    pa_l = PlanArrays(**jax.tree.map(lambda a: a[0], pa._asdict()))
    rt = M.MoERuntime(mesh=mesh, batch_axes=("data",), impl=plan.impl,
                      m=plan.m, capacity=cap)
    rpdx = shx.rows_per_device
    gix = (shx.owner_dev * rpdx + shx.owner_row).reshape(-1)
    bufx = jnp.zeros((rpdx * EP, M.chunk_len(cfg))).at[gix].set(ref_buf)
    bufs = jax.device_put(bufx, NamedSharding(mesh, P("model", "data")))
    y, aux = jax.jit(lambda xx, bb: M.moe_layer(cfg, rt, xx, wr, bb, pa_l)
                     )(xs, bufs)
    g = jax.jit(jax.grad(lambda bb: jnp.sum(
        M.moe_layer(cfg, rt, xs, wr, bb, pa_l)[0] ** 2)))(bufs)
    out.update({f"{tag}/buf": np.asarray(bufx), f"{tag}/y": np.asarray(y),
                f"{tag}/g": np.asarray(g), f"{tag}/gix": np.asarray(gix),
                f"{tag}/dev_loads": np.asarray(aux.device_loads),
                f"{tag}/pad_frac": np.asarray(aux.pad_frac),
                f"{tag}/dropped": per_device_dropped(rt, pa_l, bufs, mesh,
                                                     AX)})
    for t in ("local_rows", "local_experts", "extra_experts",
              "ring_send_rows"):
        out[f"{tag}/{t}"] = np.asarray(getattr(plan, t))


plans = {"ring": (sh, sparse_materialization(sh, loads, t=8, m=2,
                                              impl="ring")),
         "a2a": (sh, sparse_materialization(sh, loads, t=8, m=2,
                                             impl="a2a")),
         "dense": (sh, sparse_materialization(sh, loads, t=8, m=0,
                                               impl="dense")),
         "ep": (sh, ep_materialization(sh)),
         "a2a-hetero": (sh_het, sparse_materialization(sh_het, loads, t=8,
                                                       m=2, impl="a2a"))}
for tag, (shx, plan) in plans.items():
    run(tag, shx, plan, 64)
run("drop", *plans["ring"], %(drop_cap)d)
out["drop/capacity"] = np.asarray(%(drop_cap)d)

# tests/test_dispatch.py's setup on a 1 x 8 mesh
EP8, T8, E8 = 8, 2048, 16
cfg8 = ModelConfig(name="d", arch_type="moe", num_layers=1, d_model=64,
                   num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                   moe=MoEConfig(num_experts=E8, experts_per_token=1,
                                 d_ff=64), dtype="float32")
mesh8 = jax.make_mesh((1, EP8), AX,
                      axis_types=(jax.sharding.AxisType.Auto,)*2)
buf8 = jax.random.normal(key, (M.buffer_rows(cfg8, EP8),
                               M.chunk_len(cfg8))) * 0.05
x8 = jax.random.normal(key, (T8, cfg8.d_model)) + 2.0
wr8 = (jax.random.normal(key, (cfg8.d_model, E8)) * 0.01
       ).at[:, :1].set(8.0 / (2.0 * cfg8.d_model))
dl = np.full((1, E8), 0.01); dl[0, 0] = 1.0
plan8 = sparse_materialization(heterogeneous_sharding(dl, EP8, t=2), dl,
                               t=E8, m=6, impl="ring")
pa8 = PlanArrays(**jax.tree.map(lambda a: a[0],
                 M.plan_to_arrays(plan8)._asdict()))
out.update({"disp/x": np.asarray(x8), "disp/wr": np.asarray(wr8),
            "disp/buf": np.asarray(buf8)})
for lf in (True, False):
    rt8 = M.MoERuntime(mesh=mesh8, batch_axes=("data",), impl=plan8.impl,
                       m=plan8.m, capacity=4096, local_first=lf)
    _, aux = jax.jit(lambda xx, bb: M.moe_layer(cfg8, rt8, xx, wr8, bb, pa8)
                     )(jax.device_put(x8, NamedSharding(mesh8, P(AX, None))),
                       jax.device_put(buf8, NamedSharding(mesh8,
                                                          P("model", "data"))))
    out[f"disp/{int(lf)}/dev_loads"] = np.asarray(aux.device_loads)

# tests/test_collective_volume.py's configuration: olmoe's smoke config
# (GLU experts with SiLU) through the ring plan, against its oracle
import repro.configs as C
cfgo = C.get_smoke("olmoe-1b-7b").replace(dtype="float32")
Eo, Lo = cfgo.moe.num_experts, M.num_moe_layers(cfgo)
sho = homogeneous_sharding(Lo, Eo, EP)
loadso = np.linspace(2, 1, Eo)[None].repeat(Lo, 0)
kob, kow, kox = jax.random.split(jax.random.PRNGKey(1), 3)
ref_bufo = jax.random.normal(kob, (M.buffer_rows(cfgo, 1),
                                   M.chunk_len(cfgo))) * 0.05
wro = jax.random.normal(kow, (cfgo.d_model, Eo)) * 0.1
xo = jax.random.normal(kox, (64, cfgo.d_model))
pa1o = PlanArrays(**jax.tree.map(lambda a: a[0], M.plan_to_arrays(
    ep_materialization(homogeneous_sharding(Lo, Eo, 1)))._asdict()))
plano = sparse_materialization(sho, loadso, t=Eo, m=2, impl="ring")
pa_o = PlanArrays(**jax.tree.map(lambda a: a[0],
                  M.plan_to_arrays(plano)._asdict()))
rto = M.MoERuntime(mesh=mesh, batch_axes=("data",), impl="ring", m=2,
                   capacity=64)
gixo = (sho.owner_dev * sho.rows_per_device + sho.owner_row).reshape(-1)
bufo = jnp.zeros((sho.rows_per_device * EP, M.chunk_len(cfgo))
                 ).at[gixo].set(ref_bufo)
bufso = jax.device_put(bufo, NamedSharding(mesh, P("model", "data")))
xso = jax.device_put(xo, NamedSharding(mesh, P(AX, None)))
yo = jax.jit(lambda xx, bb: M.moe_layer(cfgo, rto, xx, wro, bb, pa_o)[0]
             )(xso, bufso)
go = jax.jit(jax.grad(lambda bb: jnp.sum(
    M.moe_layer(cfgo, rto, xso, wro, bb, pa_o)[0] ** 2)))(bufso)
oracle = M.MoERuntime(mesh=None)
out.update({
    "olmoe/x": np.asarray(xo), "olmoe/wr": np.asarray(wro),
    "olmoe/loads": loadso, "olmoe/buf": np.asarray(bufo),
    "olmoe/y": np.asarray(yo), "olmoe/g": np.asarray(go),
    "olmoe/gix": np.asarray(gixo),
    "olmoe/y_ref": np.asarray(M.moe_layer(cfgo, oracle, xo, wro, ref_bufo,
                                          pa1o)[0]),
    "olmoe/g_ref": np.asarray(jax.grad(lambda b: jnp.sum(M.moe_layer(
        cfgo, oracle, xo, wro, b, pa1o)[0] ** 2))(ref_bufo))})
np.savez(OUT, **out)
print("JAX ORACLE WRITTEN")
"""

DROP_CAP = 1          # tokens per (source, slot) cell: drops tokens


@pytest.fixture(scope="module")
def both(tmp_path_factory, dist):
    d = tmp_path_factory.mktemp("moe_dist")
    npz = str(d / "jax.npz")
    out = dist(JAX_SCRIPT % {"out": npz, "drop_cap": DROP_CAP}, n_devices=8)
    assert "JAX ORACLE WRITTEN" in out
    ranks = spawn(cases.moe_rank, (2, 4), "cpu", workdir=str(d / "ranks"),
                  args=(npz,), timeout=300)
    return dict(np.load(npz)), ranks


def _rows(ranks, key, sub="y"):
    return np.concatenate([r[key][sub] for r in ranks])


def _full_grad(ranks, key, data=2, model=4):
    """The global (rows, chunk_len) gradient from the ranks' shards."""
    return np.concatenate([
        np.concatenate([ranks[d * model + e][key]["g"] for d in range(data)],
                       axis=1)
        for e in range(model)])


@pytest.mark.parametrize("tag", cases.MOE_TAGS)
def test_port_plans_equal_the_reference_plans(both, tag):
    jx, ranks = both
    for t in cases.TABLES:
        np.testing.assert_array_equal(ranks[0]["tables"][tag][t],
                                      jx[f"{tag}/{t}"])


def _oracle(jx, tag, what):
    """The mesh-less oracle's output or gradient for ``tag``: the tiny
    config's, or the olmoe case's own."""
    return jx.get(f"{tag}/{what}", jx[what])


@pytest.mark.parametrize("tag", cases.LAYER_TAGS)
def test_forward_matches_jax_mesh_and_oracle(both, tag):
    """Every plan of the tiny config, and olmoe's smoke config (GLU experts
    with SiLU) through the ring plan."""
    jx, ranks = both
    y = _rows(ranks, tag)
    assert np.abs(y - jx[f"{tag}/y"]).max() < 1e-4
    assert np.abs(y - _oracle(jx, tag, "y_ref")).max() < 1e-4


@pytest.mark.parametrize("tag", cases.LAYER_TAGS)
def test_buffer_grad_matches_jax_mesh_and_oracle(both, tag):
    """The hand-written SparseReduceScatter lands the gradient on the
    owner's rows: the assembled shards equal JAX's transpose of its gather
    and the oracle's gradient."""
    jx, ranks = both
    g = _full_grad(ranks, tag)
    want = jx[f"{tag}/g"]
    assert np.abs(g - want).max() / np.abs(want).max() < 1e-4
    ref = _oracle(jx, tag, "g_ref")
    assert np.abs(g[jx[f"{tag}/gix"]] - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize("tag", cases.MOE_TAGS)
def test_layer_statistics_match_jax(both, tag):
    """Per-rank dropped fraction (none at capacity 64), the device loads
    and the padding fraction summed over the world."""
    jx, ranks = both
    np.testing.assert_array_equal([r[tag]["dropped"] for r in ranks],
                                  jx[f"{tag}/dropped"])
    for r in ranks:
        np.testing.assert_array_equal(r[tag]["dev_loads"],
                                      jx[f"{tag}/dev_loads"])
        assert abs(r[tag]["pad_frac"] - float(jx[f"{tag}/pad_frac"])) < 1e-6


def test_row_valid_layout_matches_oracle(both):
    """``use_pallas``: the grouped FFN runs over the uncompacted (K, M·C, D)
    layout with per-source valid prefixes (the plain versions here), as
    ``tests/test_sort_dispatch.py``'s Pallas case; real padding reported."""
    jx, ranks = both
    assert np.abs(_rows(ranks, "row_valid") - jx["y_ref"]).max() < 1e-4
    g = _full_grad(ranks, "row_valid")
    ref = jx["g_ref"]
    assert np.abs(g[jx["ring/gix"]] - ref).max() / np.abs(ref).max() < 1e-4
    pf = ranks[0]["row_valid"]["pad_frac"]
    assert 0.0 < pf < 1.0 and abs(pf - float(jx["ring/pad_frac"])) < 1e-6


def test_over_capacity_tokens_drop_as_in_jax(both):
    """ROADMAP C2: a capacity of one token per cell drops tokens; the port
    masks them out before its ``index_put_`` and drops exactly the entries
    JAX's ``mode="drop"`` scatter drops."""
    jx, ranks = both
    dropped = np.asarray([r["drop"]["dropped"] for r in ranks])
    assert dropped.max() > 0.0
    np.testing.assert_array_equal(dropped, jx["drop/dropped"])
    assert np.abs(_rows(ranks, "drop") - jx["drop/y"]).max() < 1e-4
    g = _full_grad(ranks, "drop")
    assert np.abs(g - jx["drop/g"]).max() / np.abs(jx["drop/g"]).max() < 1e-4


def test_collective_volumes(both):
    """Eq. (1)/(2), from the port's record of bytes sent to other ranks:
    ring moves m·chunk_bytes_local per rank exactly, a2a m·(M−1)·
    chunk_bytes_local above the token dispatch, ep no chunk byte, and
    ring < a2a."""
    _, ranks = both
    m, M = 2, 4
    chunk_bytes_local = cases.M.chunk_len(cases.TINY) * 4 // 2
    for r in ranks:
        v = {t: r["volume"][t]["fwd"] for t in ("ring", "a2a", "ep")}
        ring = v["ring"]["spag_ring"]["bytes"]
        a2a = v["a2a"]["spag_a2a"]["bytes"]
        assert ring == m * chunk_bytes_local
        assert a2a == m * (M - 1) * chunk_bytes_local
        assert not {"spag_ring", "spag_a2a", "spag_dense"} & set(v["ep"])
        # the token dispatch moves (M, K, C, D): the same for ring and a2a
        assert v["ring"]["tokens_out"] == v["a2a"]["tokens_out"]
        assert ring < a2a


def test_ring_call_counts_and_no_compaction_copy(both):
    """``tests/test_fused_ffn_path.py``'s jaxpr law as a call-count law:
    per layer the ring issues m single hops forward and m reverse hops
    backward, one token all-to-all each way (and its reverse), and no
    gather or scatter maps a (K, M·C, D) tensor to another."""
    _, ranks = both
    m, M, cap, D = 2, 4, 64, cases.TINY.d_model
    for r in ranks:
        rv = r["row_valid"]
        assert rv["fwd"]["spag_ring"]["calls"] == m
        assert rv["bwd"]["sprs_ring"]["calls"] == m
        assert "spag_ring" not in rv["bwd"] and "sprs_ring" not in rv["fwd"]
        for kind in ("tokens_out", "tokens_back", "counts", "spag_fsdp"):
            assert rv["fwd"][kind]["calls"] == 1, kind
        for kind in ("tokens_out_bwd", "tokens_back_bwd", "sprs_fsdp"):
            assert rv["bwd"][kind]["calls"] == 1, kind
        bad = (rv["K"], M * cap, D)
        assert not [op for op in rv["index_ops"]
                    if op[1] == bad and op[2] == bad]


def test_dispatch_laws_on_one_by_eight(both):
    """``tests/test_dispatch.py`` on a 1 x 8 grid: nothing dropped at a
    generous capacity, every token processed once, round-robin spreads the
    hot expert's tokens evenly over its hosts, local-first keeps each
    rank's own load; the device loads equal JAX's."""
    jx, ranks = both
    T, EP = 2048, 8
    disp = ranks[0]["dispatch"]
    hosts = sorted(disp["hosts0"])
    assert len(hosts) >= 6
    for lf in (True, False):
        for r in ranks:
            dev, dropped = r["dispatch"][lf]
            assert dropped == 0.0
            assert abs(dev.sum() - T) < 1e-3
            np.testing.assert_array_equal(dev, jx[f"disp/{int(lf)}/dev_loads"])
    shares = disp[False][0][hosts]
    assert shares.max() - shares.min() <= 0.25 * shares.mean() + EP
    covered = disp[True][0][hosts]
    assert (covered >= 0.6 * T / EP).all() or len(hosts) < EP
