"""Serving on a process grid against the JAX engine on a mesh: the
engine's slot cache through the stacked SparseAllGather, greedy
``generate`` and the publication laws of ``tests/test_serve_publish.py``
and ``tests/test_serve_batching.py``.

The JAX side (one ``run_distributed`` subprocess, 8 host devices, an
``.npz`` written once for the module) serves the smoke gpt-moe-s from
``init_params(PRNGKey(0), ep=4)`` on a (2, 4) mesh with the ring plan,
``m = 1`` and ``capacity = 16``, as the reference's publish script does,
and writes its engine's slots and greedy tokens.  The port side runs 8
gloo ranks of a 2 x 4 process grid (``tests/torch_dist_cases.py::
serve_grid_rank``) from the same weights: each rank's slots must equal
the JAX engine's slots of its EP index to 1e-6 of the largest value (the
cast of f32 weights moves nothing), and the tokens JAX's, bit for bit.
``spawn``'s timeout bounds every multi-rank run, so a deadlock fails the
test rather than hanging it.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402

JAX_SCRIPT = r"""
import numpy as np, jax
from repro.configs.gpt_moe_s import smoke
from repro.core.placement import homogeneous_sharding
from repro.core.schedule import sparse_materialization
from repro.core import moe as moe_core
from repro.models import model as mdl
from repro.serve.engine import Engine

cfg = smoke()
EP = 4
mesh = jax.make_mesh((2, EP), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,)*2)
L = moe_core.num_moe_layers(cfg)
E = cfg.moe.num_experts
sh = homogeneous_sharding(L, E, EP)
plan = sparse_materialization(sh, np.ones((L, E)), t=4, m=1, impl="ring")
pa = moe_core.plan_to_arrays(plan)
rt = mdl.Runtime(mesh=mesh, moe=moe_core.MoERuntime(
    mesh=mesh, batch_axes=("data",), impl="ring", m=1, capacity=16))
trees = {name: mdl.init_params(cfg, jax.random.PRNGKey(seed), ep=EP)
         for seed, name in enumerate(("params", "params2", "params3"))}
prompts = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (8, 3)).astype(np.int32)
out = {"prompts": prompts}
eng = Engine(cfg, rt, trees["params"], max_len=32, pa=pa)
out["slots"] = np.asarray(eng._materialized())
out["out0"] = eng.generate(prompts, steps=4)
eng.publish_params(trees["params2"], wait=True)
out["out1"] = eng.generate(prompts, steps=4)
eng.close()


def flat(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + "/" + k)
    else:
        yield prefix, np.asarray(tree)


for name, tree in trees.items():
    out.update(dict(flat(tree, name)))
np.savez(%(out)r, **out)
print("JAX SERVE ORACLE WRITTEN")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory, dist):
    d = tmp_path_factory.mktemp("serve_grid")
    npz = str(d / "jax.npz")
    out = dist(JAX_SCRIPT % {"out": npz}, n_devices=8)
    assert "JAX SERVE ORACLE WRITTEN" in out
    ranks = spawn(cases.serve_grid_rank, (2, 4), "cpu",
                  workdir=str(d / "ranks"), args=(npz,), timeout=300)
    return dict(np.load(npz)), ranks


def test_grid_slots_equal_the_jax_engines_slots_of_each_rank(both):
    """F2: rank (d, e) builds the JAX engine's slots of EP index e, with
    L·m ring hops and L FSDP all-gathers."""
    jx, ranks = both
    want = jx["slots"]                          # (L, M, K, chunk_len)
    for rank, r in enumerate(ranks):
        got = r["slots"]
        assert got.shape == (want.shape[0], 1) + want.shape[2:]
        np.testing.assert_allclose(got[:, 0], want[:, rank % 4], rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        assert r["build_calls"] == {"spag_ring": r["L"] * r["m"],
                                    "spag_fsdp": r["L"]}


def test_materialize_chunks_refuses_tables_of_more_than_one_rank():
    cfg = get_smoke("gpt-moe-s")
    pa = cases._ring_pa(cfg, 4)
    buf = torch.zeros(moe.buffer_rows(cfg, 4), moe.chunk_len(cfg))
    with pytest.raises(ValueError, match="materialize_stack"):
        moe.materialize_chunks(cfg, buf, pa)


def test_grid_generate_greedy_tokens_equal_jax_on_the_mesh(both):
    """Every rank returns the whole batch, JAX's tokens bit for bit,
    before and after a publication (the port's second run has another
    publication land in its 4th step: its first 5 tokens are v1's)."""
    jx, ranks = both
    for r in ranks:
        np.testing.assert_array_equal(r["out0"], jx["out0"])
        np.testing.assert_array_equal(r["out0b"], jx["out0"])
        np.testing.assert_array_equal(r["out1"][:, :5], jx["out1"][:, :5])


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_decode_step_on_cached_slots_issues_no_sparse_all_gather(both,
                                                                 cache):
    _, ranks = both
    for r in ranks:
        with_, without = r["steps"][(cache, "with")], \
            r["steps"][(cache, "without")]
        assert set(with_) <= cases.LAYER_ONLY, with_
        assert with_["gate_stats"]["calls"] == r["L"]
        assert without["spag_ring"]["calls"] == r["L"] * r["m"]
        assert without["spag_fsdp"]["calls"] == r["L"]


def test_one_publication_is_one_stacked_build_and_none_at_steady_state(
        both):
    _, ranks = both
    for r in ranks:
        assert r["steady"] == (0, {})
        builds, calls, version = r["publish"]
        assert (builds, version) == (1, 0)      # staged, not promoted
        assert calls == {"spag_ring": r["L"] * r["m"], "spag_fsdp": r["L"]}


def test_straddling_step_reads_old_state_and_direct_swap_wins(both):
    """As ``tests/test_serve_publish.py``: v1 live from the first
    boundary, the step the v2 publication lands in reads v1 throughout,
    the next boundary swaps params and slots together; the served tokens
    equal a fresh engine's at v2.  A direct ``eng.params`` assignment
    rebuilds the slots from the new buffer."""
    _, ranks = both
    for r in ranks:
        s = r["straddle"]
        assert s["versions"][0] == 1 and s["which"][0] == 2
        assert s["versions"][3] == 1 and s["which"][3] == 2
        assert s["versions"][4] == 2 and s["which"][4] == 3
        assert s["swapped"] and s["cached"]
        assert s["builds"] == 2 and s["version"] == 2
        np.testing.assert_array_equal(r["out2"], r["fresh3"])
        assert not (r["out0"] == r["out2"]).all()
        np.testing.assert_array_equal(r["swap_b"], r["swap_fresh"])
        assert not (r["swap_a"] == r["swap_b"]).all()
