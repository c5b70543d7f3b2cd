"""``tests/test_sort_dispatch.py``'s dispatch laws for the port's
``core.moe.replica_dispatch``: against the one-hot / cumsum oracle (that
file's ``_onehot_reference`` and parity checks), and on its fixed cases
against the JAX package's dispatch, on random multi-rank slot tables with and without
``local_first``, the degenerate corners (capacity 1, k = E, one hot
expert, an empty valid mask) and first-come-first-kept drops.  The
Pallas group-size case of that file is
``tests/test_torch_moe_distributed.py::test_row_valid_layout_matches_oracle``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import moe as jmoe  # noqa: E402

from repro_torch.core import moe  # noqa: E402

from test_sort_dispatch import (_check_dispatch_parity,  # noqa: E402
                                _make_tables, _onehot_reference)


def _case(tables, e_safe, valid, K, capacity, local_first, mes,
          with_jax=False):
    """The port's dispatch on ``tables`` (``_make_tables``) against the
    one-hot oracle, and with ``with_jax`` bit for bit against the JAX
    package's (eager JAX compiles each new shape, so the sweep leaves it
    out)."""
    es, rep, nrep = (np.asarray(t) for t in tables)
    for me in mes:
        got = moe.replica_dispatch(
            torch.from_numpy(e_safe), torch.from_numpy(valid),
            *(torch.from_numpy(t.copy()) for t in (es, rep, nrep)),
            me, K, capacity, local_first)
        got = tuple(g.numpy() for g in got)
        want = _onehot_reference(e_safe, valid, es, rep, nrep, me, K,
                                 capacity, local_first)
        _check_dispatch_parity(got, want, valid, K)
        if with_jax:
            jgot = jmoe.replica_dispatch(
                jnp.asarray(e_safe), jnp.asarray(valid), *tables, me, K=K,
                capacity=capacity, local_first=local_first)
            for g, j in zip(got, jgot):
                np.testing.assert_array_equal(g, np.asarray(j))


@pytest.mark.parametrize("local_first", [True, False])
@pytest.mark.parametrize("n,M,K,E,capacity", [
    (64, 4, 3, 8, 4), (257, 8, 4, 16, 3), (1024, 8, 8, 48, 7)])
def test_replica_dispatch_matches_onehot_and_jax(n, M, K, E, capacity,
                                                 local_first):
    rng = np.random.default_rng(n + M + K + E)
    tables = _make_tables(rng, M, K, E)
    e_safe = rng.integers(0, E, (n,)).astype(np.int32)
    valid = rng.random(n) > 0.2
    _case(tables, e_safe, valid, K, capacity, local_first,
          (0, M - 1, M // 2), with_jax=True)


@pytest.mark.parametrize("assign_mode", ["uniform", "one_expert",
                                         "all_experts"])
def test_replica_dispatch_degenerate_sweep(assign_mode):
    """The reference's seeded sweep: capacity 1, k = E, one hot expert,
    empty and full valid masks, both dispatch rules."""
    seeds = {"uniform": 11, "one_expert": 22, "all_experts": 33}
    rng = np.random.default_rng(seeds[assign_mode])
    for trial in range(12):
        M = int(rng.integers(2, 9))
        K = int(rng.integers(1, 7))
        E = int(rng.integers(1, M * K + 1))
        T = int(rng.integers(1, 25))
        k = E if trial % 3 == 0 else int(rng.integers(1, E + 1))
        capacity = 1 if trial % 4 == 0 else int(rng.integers(1, 7))
        valid_mode = ["random", "all", "none"][trial % 3]
        tables = _make_tables(rng, M, K, E)
        n = T * k
        if assign_mode == "one_expert":
            e_safe = np.full((n,), int(rng.integers(0, E)), np.int32)
        elif assign_mode == "all_experts":
            e_safe = np.tile(np.arange(E, dtype=np.int32), -(-n // E))[:n]
        else:
            e_safe = rng.integers(0, E, (n,)).astype(np.int32)
        valid = {"all": np.ones((n,), bool), "none": np.zeros((n,), bool),
                 "random": rng.random(n) > 0.3}[valid_mode]
        _case(tables, e_safe, valid, K, capacity, bool(trial % 2),
              (int(rng.integers(0, M)),))


def test_segment_ranks_naive():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 7, (333,)).astype(np.int32)
    want = np.zeros_like(keys)
    seen = {}
    for i, k in enumerate(keys):
        want[i] = seen.get(int(k), 0)
        seen[int(k)] = want[i] + 1
    got = moe.segment_ranks(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dispatch_first_come_first_kept():
    """Capacity drops hit the LAST arrivals in flat order."""
    expert_slot = torch.tensor([[0, -1], [-1, 0]], dtype=torch.int32)
    replicas = torch.tensor([[0], [1]], dtype=torch.int32)
    n_rep = torch.tensor([1, 1], dtype=torch.int32)
    e_safe = torch.zeros((10,), dtype=torch.int32)
    valid = torch.ones((10,), dtype=torch.bool)
    dest, slot, pos, keep, cnt = moe.replica_dispatch(
        e_safe, valid, expert_slot, replicas, n_rep, 0, 1, 4, True)
    np.testing.assert_array_equal(keep.numpy(), [True] * 4 + [False] * 6)
    np.testing.assert_array_equal(pos.numpy(), np.arange(10))
    assert int(cnt[0, 0]) == 4
