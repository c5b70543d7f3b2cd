"""``tests/test_serve_batching.py``'s laws of continuous batching for the
port's scheduler, on the gpt-moe-s smoke engine on the CPU (no JAX:
these are laws, not comparisons): the page pool and page tables, mixed
lengths decoded together and a preempted sequence each giving their own
``Engine.generate`` trace, and overload as a typed result — queue and
length rejections, deadlines, prefill crashes, page exhaustion and the
chaos soak of all three serve fault sites.  That file's other laws are
held elsewhere: paged against dense decode in
``tests/test_torch_publish.py::test_paged_decode_step_parity_vs_dense``
and ``tests/test_torch_paged_gather.py``, the scheduler against
``generate`` in ``tests/test_torch_publish.py::
test_scheduler_matches_engine_generate``, publication and routing in
``::test_prefill_straddling_publication_reads_one_version`` and
``::test_route_orders_replicas_by_scheduler_load``, the collective law on
a grid in ``tests/test_torch_serve_grid.py::
test_decode_step_on_cached_slots_issues_no_sparse_all_gather``.
"""
import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common import faults  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.kv_pool import KVPagePool, PageTable  # noqa: E402
from repro_torch.serve.scheduler import (DONE, REJECTED,  # noqa: E402
                                         TERMINAL, TIMED_OUT,
                                         RequestScheduler)


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    faults.clear()
    torch.set_num_threads(n)


def _engine(max_len=32):
    cfg = configs.get_smoke("gpt-moe-s")
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(moe.num_moe_layers(cfg),
                                       cfg.moe.num_experts, 1)), "cpu")
    params = mdl.init_params(cfg, 0, "cpu")
    return Engine(cfg, mdl.Runtime(), params, max_len=max_len, pa=pa)


def test_kv_pool_alloc_free_deterministic():
    pool = KVPagePool(num_pages=5, page_size=4)
    assert pool.usable_pages == 4 and pool.num_rows == 20
    a = pool.alloc(2)
    assert a == [1, 2]                  # lowest first, page 0 reserved
    assert pool.alloc(2) == [3, 4]
    assert pool.alloc(1) is None        # exhaustion is a result
    assert pool.used_frac == 1.0
    pool.free(a)
    assert pool.alloc(2) == [1, 2]      # deterministic after free
    with pytest.raises(AssertionError):
        pool.free([0])                  # the trash page is never freed
    pool2 = KVPagePool(num_pages=3, page_size=2)
    p = pool2.alloc(1)
    pool2.free(p)
    with pytest.raises(AssertionError):
        pool2.free(p)                   # double free


def test_page_table_row_idx_maps_tokens_and_parks_tail_on_trash():
    t = PageTable(page_size=4, max_kv=12, pages=[3, 1])
    rows = t.row_idx()
    assert rows.shape == (12,)
    np.testing.assert_array_equal(rows[:8], [12, 13, 14, 15, 4, 5, 6, 7])
    np.testing.assert_array_equal(rows[8:], 0)      # trash page
    assert t.capacity == 8


def test_mixed_length_concurrent_parity():
    with _engine() as eng:
        prompts = [[7], [1, 2, 3], [4, 5, 6, 8, 9], [2, 4, 6, 8, 1, 3, 5]]
        base = {i: eng.generate(np.asarray([p], np.int32), steps=5)[0]
                for i, p in enumerate(prompts)}
        with RequestScheduler(eng, max_slots=4, num_pages=17, page_size=4,
                              max_kv=32) as rs:
            reqs = [rs.submit(p, max_new_tokens=5) for p in prompts]
            rs.run(max_ticks=200)
            for i, r in enumerate(reqs):
                assert r.state == DONE
                np.testing.assert_array_equal(r.output(), base[i])
            assert max(r.preemptions for r in reqs) == 0


def test_preemption_is_lossless_and_youngest_first():
    with _engine() as eng:
        base_a = eng.generate(np.asarray([[1, 2, 3]], np.int32), steps=10)[0]
        base_b = eng.generate(np.asarray([[4, 5, 6]], np.int32), steps=10)[0]
        with RequestScheduler(eng, max_slots=2, num_pages=5, page_size=4,
                              max_kv=16) as rs:
            a = rs.submit([1, 2, 3], max_new_tokens=10)
            b = rs.submit([4, 5, 6], max_new_tokens=10)
            rs.run(max_ticks=300)
            assert a.state == DONE and b.state == DONE
            assert rs.requests_preempted >= 1
            assert a.preemptions == 0   # the oldest always progresses
            assert b.preemptions >= 1
            np.testing.assert_array_equal(a.output(), base_a)
            np.testing.assert_array_equal(b.output(), base_b)
            assert rs.robustness().requests_preempted == \
                rs.requests_preempted


def test_typed_rejections_never_raise():
    with _engine() as eng:
        with RequestScheduler(eng, max_slots=1, num_pages=5, page_size=4,
                              max_kv=16, max_queue=1) as rs:
            too_long = rs.submit(list(range(1, 15)), max_new_tokens=10)
            assert too_long.state == REJECTED
            assert too_long.finish_reason == "too_long"
            ok = rs.submit([1, 2], max_new_tokens=2)
            overflow = rs.submit([3, 4], max_new_tokens=2)
            assert overflow.state == REJECTED
            assert overflow.finish_reason == "queue_full"
            assert rs.requests_rejected == 2
            rs.run(max_ticks=50)
            assert ok.state == DONE


def test_ttl_reaps_queued_and_wedged_requests():
    now = [0.0]
    with _engine() as eng:
        with RequestScheduler(eng, max_slots=1, num_pages=9, page_size=4,
                              max_kv=16, default_ttl_s=10.0,
                              clock=lambda: now[0]) as rs:
            active = rs.submit([1, 2], max_new_tokens=12)
            queued = rs.submit([3, 4], max_new_tokens=2, ttl_s=5.0)
            faults.inject("serve.request_hang", exc=RuntimeError("wedge"),
                          only=active.rid, times=None)
            for _ in range(4):
                rs.step()               # the hung request makes no progress
            assert active.state == "DECODING" and len(active.generated) == 1
            now[0] = 6.0
            rs.step()                   # the queued deadline fires first
            assert queued.state == TIMED_OUT and queued.finish_reason == "ttl"
            now[0] = 11.0
            rs.step()
            assert active.state == TIMED_OUT
            assert rs.requests_timed_out == 2
            assert rs.pool.free_pages == rs.pool.usable_pages


def test_prefill_crash_retries_then_rejects():
    with _engine() as eng:
        faults.inject("serve.prefill_crash", exc=RuntimeError("boom"),
                      times=1)
        with RequestScheduler(eng, max_slots=1, num_pages=9, page_size=4,
                              max_kv=16, max_prefill_retries=1) as rs:
            r = rs.submit([1, 2, 3], max_new_tokens=3)
            rs.run(max_ticks=50)
            assert r.state == DONE and r.prefill_failures == 1
        faults.clear()
        faults.inject("serve.prefill_crash", exc=RuntimeError("boom"),
                      times=None)
        with RequestScheduler(eng, max_slots=1, num_pages=9, page_size=4,
                              max_kv=16, max_prefill_retries=1) as rs:
            r = rs.submit([1, 2, 3], max_new_tokens=3)
            rs.run(max_ticks=50)
            assert r.state == REJECTED and r.finish_reason == "prefill_crash"
            assert rs.pool.free_pages == rs.pool.usable_pages


def test_page_exhaustion_at_admission_waits_then_admits():
    with _engine() as eng:
        faults.inject("serve.page_exhausted", exc=RuntimeError("full"),
                      times=2)
        with RequestScheduler(eng, max_slots=1, num_pages=9, page_size=4,
                              max_kv=16) as rs:
            r = rs.submit([1, 2], max_new_tokens=2)
            rs.step()
            assert r.state == "QUEUED"  # the first allocation: exhausted
            rs.run(max_ticks=50)
            assert r.state == DONE


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_soak_every_request_terminates(seed):
    """The three serve fault sites armed in a seeded random order with
    random budgets: nothing raises, every request ends in one terminal
    state, the counters account for each, and the pool drains."""
    rng = random.Random(seed)
    with _engine() as eng:
        with RequestScheduler(eng, max_slots=2, num_pages=7, page_size=4,
                              max_kv=16, max_queue=8,
                              default_ttl_s=3.0) as rs:
            reqs = [rs.submit([rng.randrange(1, 500) for _ in
                               range(rng.randrange(1, 6))],
                              max_new_tokens=rng.randrange(1, 8))
                    for _ in range(6)]
            hang_rid = rng.choice(reqs).rid
            sites = [
                lambda: faults.inject("serve.page_exhausted",
                                      exc=RuntimeError("full"),
                                      times=rng.randrange(1, 4)),
                lambda: faults.inject("serve.request_hang",
                                      exc=RuntimeError("wedge"),
                                      only=hang_rid, times=None),
                lambda: faults.inject("serve.prefill_crash",
                                      exc=RuntimeError("boom"),
                                      times=rng.randrange(1, 3)),
            ]
            rng.shuffle(sites)
            for arm in sites:
                arm()
            rs.run(max_ticks=3000)
            states = [r.state for r in reqs]
            assert all(s in TERMINAL for s in states), states
            n_done = sum(s == DONE for s in states)
            assert n_done == rs.requests_completed
            assert len(reqs) - n_done == \
                rs.requests_rejected + rs.requests_timed_out
            assert rs.pool.free_pages == rs.pool.usable_pages
