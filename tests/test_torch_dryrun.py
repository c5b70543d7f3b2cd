"""The port's dry run (``launch/inputs.py``, ``launch/dryrun.py``) against
the JAX package's, and its own laws.

Against JAX: the input shapes and mesh config, the applicability rules,
the microbatch depth and the analytic memory model on (N, 1) grids, the
roofline's model FLOPs, and the plan tables.  ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices when imported, so it is imported only
inside ``_jax_dryrun``, after JAX's backend is up, and the variable is put
back at once.

Laws: a fake step counts the FLOPs and the argument bytes of the same
step run for real over gloo; the collective bytes of olmoe's MoE layer on
a fake 2 x 4 grid meet ``tests/test_collective_volume.py``'s Eq. 1/2
assertions and equal what a real 2 x 4 gloo run records; FLOPs are linear
in the depth; a full-width record on the 16 x 16 grid; the unsupported and
the failed record.  One torch intra-op thread, small models but one
full-width fake step (~10 s).
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.common import config as jconfig  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common import config as tconfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import inputs  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402
from repro_torch.launch.mesh import ProcessGrid, fake_grid, make_grid  # noqa: E402

import torch_dist_cases as cases  # noqa: E402

ALL = configs.PAPER + configs.ASSIGNED
MOE = [a for a in ALL if configs.get(a).moe.enabled]
SMALL_TRAIN = tconfig.ShapeConfig("small_train", 32, 2, "train")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dryrun():
    jax.devices()                       # the backend keeps its device count
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return jdryrun


def _n_by_one(n):
    return (jax.sharding.AbstractMesh((n, 1), ("data", "model")),
            ProcessGrid(n, 1, 0, None, None))


def _pairs():
    for a in ALL:
        yield jconfigs.get(a), configs.get(a)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def test_input_shapes_and_mesh_config_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in
            tconfig.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfig.INPUT_SHAPES.items()}
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        j, t = jconfig.MeshConfig(shape, axes), tconfig.MeshConfig(shape,
                                                                   axes)
        for attr in ("num_devices", "batch_axes", "model_size",
                     "batch_size"):
            assert getattr(t, attr) == getattr(j, attr), attr
    assert tconfig.MeshConfig() == tconfig.MeshConfig((16, 16),
                                                      ("data", "model"))


def test_applicability_agrees_for_every_config_and_shape():
    for jcfg, cfg in _pairs():
        for name in tconfig.INPUT_SHAPES:
            js, ts = jconfig.INPUT_SHAPES[name], tconfig.INPUT_SHAPES[name]
            assert inputs.effective_seq(cfg, ts) == \
                jinputs.effective_seq(jcfg, js)
            assert inputs.skip_reason(cfg, ts) == \
                jinputs.skip_reason(jcfg, js)
            assert inputs.shape_note(cfg, ts) == jinputs.shape_note(jcfg, js)


@pytest.mark.parametrize("n", [1, 16, 256])
def test_microbatches_and_memory_model_agree_on_n_by_one_grids(n):
    jdry = _jax_dryrun()
    mesh, grid = _n_by_one(n)
    assert inputs.mesh_batch_size(grid) == jinputs.mesh_batch_size(mesh)
    for jcfg, cfg in _pairs():
        for name in tconfig.INPUT_SHAPES:
            js, ts = jconfig.INPUT_SHAPES[name], tconfig.INPUT_SHAPES[name]
            if js.mode == "train":
                assert dryrun.default_microbatches(cfg, ts, grid) == \
                    jdry.default_microbatches(jcfg, js, mesh)
            got = dryrun.analytic_memory(cfg, ts, grid)
            want = jdry.analytic_memory(jcfg, js, mesh)
            for k in ("weights_bytes", "total_bytes_est"):
                assert got[k] == want[k], (cfg.name, name, k)
            assert got["fits_80g_hbm"] == (want["total_bytes_est"] < 80e9)


def test_roofline_model_flops_agree():
    jdry = _jax_dryrun()
    rec = {"cost": {"flops": 3.5e14, "bytes_accessed": 2.0e13,
                    "collective_bytes_total": 4.0e10},
           "memory": {"argument_bytes_per_device": 2.0e10,
                      "output_bytes_per_device": 1.9e10}}
    for jcfg, cfg in _pairs():
        for name in tconfig.INPUT_SHAPES:
            js, ts = jconfig.INPUT_SHAPES[name], tconfig.INPUT_SHAPES[name]
            got = dryrun.roofline_terms(cfg, ts, rec, 256)
            want = jdry.roofline_terms(jcfg, js, rec, 256)
            for k in ("model_flops", "hlo_flops_global",
                      "useful_flops_ratio"):
                assert got[k] == want[k], (cfg.name, name, k)


def test_concrete_plan_tables_are_byte_identical():
    for arch in MOE:
        jcfg, cfg = jconfigs.get(arch), configs.get(arch)
        for ep in (1, 4, 16):
            for impl in ("ring", "a2a", "dense", "ep"):
                want = jinputs.concrete_plan(jcfg, ep, impl)
                got = inputs.concrete_plan(cfg, ep, impl, device="cpu")
                for f in want._fields:
                    w = np.asarray(getattr(want, f))
                    g = getattr(got, f).numpy()
                    assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), \
                        (arch, ep, impl, f)


# ---------------------------------------------------------------------------
# laws of the dry run
# ---------------------------------------------------------------------------
def test_fake_backend_is_there_and_fake_grid_refuses_a_second_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa
    with fake_grid(2, 4) as g:
        assert dist.get_backend() == "fake" and g.size == 8
        assert (g.data, g.model, g.rank) == (2, 4, 0)
        with pytest.raises(RuntimeError, match="already initialized"):
            with fake_grid(1, 1):
                pass
    assert not dist.is_initialized()


def test_fake_step_counts_the_flops_and_arguments_of_the_real_step(tmp_path):
    """The smoke config's train step, dry-run on a fake 1 x 1 grid and run
    for real on CPU tensors over a gloo world of one: the same FLOPs
    (``FlopCounterMode``) and the same argument bytes (state, batch and
    plan tables)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.common.config import TrainConfig
    from repro_torch.train import step as step_lib
    cfg = configs.get_smoke("gpt-moe-s")
    rec = dryrun.dryrun_combo(cfg, SMALL_TRAIN, grid=(1, 1))
    assert rec["status"] == "ok"
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        grid = make_grid(1, 1)
        state = step_lib.init_state(cfg, 0, 1, "cpu", grid)
        g = torch.Generator().manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 33),
                                         generator=g, dtype=torch.int32)}
        pa = inputs.concrete_plan(cfg, 1, "ring", device="cpu")
        args = (state, batch, pa)
        tc = TrainConfig(microbatch=dryrun.default_microbatches(
            cfg, SMALL_TRAIN, grid))
        step = step_lib.build_train_step(cfg, inputs.make_runtime(cfg, grid),
                                         tc)
        arg_bytes = dryrun.storage_bytes(args)
        with FlopCounterMode(display=False) as fc:
            _, metrics = step(*args)
    finally:
        dist.destroy_process_group()
    assert np.isfinite(float(metrics["loss"]))
    assert rec["cost"]["flops"] == fc.get_total_flops() > 0
    assert rec["memory"]["argument_bytes_per_device"] == arg_bytes
    assert rec["cost_raw"] == rec["cost"]
    assert rec["memory"]["peak_estimate_per_device"] == \
        arg_bytes + rec["memory"]["temp_bytes_per_device"]


def test_olmoe_layer_volumes_meet_eq_1_2_and_equal_a_real_grid(tmp_path):
    """``tests/test_collective_volume.py``'s assertions with its config and
    tolerances, on the wire bytes a fake 2 x 4 grid's rank 0 counts; the
    bytes per kind also equal rank 0's collective record of a real 2 x 4
    gloo run of the same forward."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    plans, wr, x, buf = cases.volume_inputs()
    fake = {}
    with fake_grid(2, cases.VOLUME_EP) as g:
        for tag, plan in plans.items():
            mode = FakeTensorMode(allow_non_fake_inputs=True)
            xs, ws, bs = (mode.from_tensor(torch.from_numpy(a))
                          for a in (x, wr, buf))
            shard = mode.from_tensor(cases.M.shard_buffer(
                torch.from_numpy(buf), g))
            acct = dryrun.StepAccount()
            with mode, acct:
                cases.volume_layer(g, plan, xs, ws, shard)
            fake[tag] = dict(acct.collective_bytes)
    m, ep_ranks = cases.VOLUME_M, cases.VOLUME_EP
    chunk_bytes_local = cases.M.chunk_len(cases.OLMOE) * 4 // 2
    ring, a2a, ep = fake["ring"], fake["a2a"], fake["ep"]
    expect_ring = m * chunk_bytes_local
    got_ring = ring.get("collective-permute", 0)
    assert abs(got_ring - expect_ring) <= 0.25 * expect_ring
    expect_a2a = m * (ep_ranks - 1) * chunk_bytes_local
    got_a2a = a2a.get("all-to-all", 0) - ep.get("all-to-all", 0)
    assert abs(got_a2a - expect_a2a) <= 0.3 * expect_a2a
    assert ep.get("collective-permute", 0) == 0
    assert got_ring < got_a2a

    real = spawn(cases.volume_rank, (2, cases.VOLUME_EP), "cpu",
                 workdir=str(tmp_path / "ranks"), timeout=300)[0]
    kind = {"spag_ring": "collective-permute", "spag_a2a": "all-to-all",
            "tokens_out": "all-to-all", "tokens_back": "all-to-all",
            "counts": "all-to-all", "spag_fsdp": "all-gather",
            "gate_stats": "all-reduce", "dev_loads": "all-reduce"}
    for tag in plans:
        want = {}
        for k, v in real[tag].items():
            if v["bytes"]:
                want[kind[k]] = want.get(kind[k], 0) + v["bytes"]
        got = {k: v for k, v in fake[tag].items() if v}
        assert got == want, (tag, got, want)


@pytest.mark.parametrize("arch", ["gpt-moe-s", "whisper-medium"])
def test_flops_are_linear_in_depth(arch):
    """FLOPs at full depth equal FLOPs at one superblock plus (n_sb - 1)
    times the difference between two superblocks and one (the reference's
    extrapolation, exact here)."""
    cfg = configs.get_smoke(arch)
    n_sb = 4
    flops = {d: dryrun.dryrun_combo(dryrun._reduced_cfg(cfg, d), SMALL_TRAIN,
                                    grid=(1, 2))["cost"]["flops"]
             for d in (1, 2, n_sb)}
    assert flops[n_sb] == flops[1] + (n_sb - 1) * (flops[2] - flops[1])
    assert flops[2] > flops[1] > 0


def test_full_width_gpt_moe_s_train_4k_on_the_16_by_16_grid():
    rec = dryrun.dryrun_combo("gpt-moe-s", "train_4k")
    assert rec["status"] == "ok" and rec["grid"] == [16, 16]
    assert not dist.is_initialized()
    mem, cost, roof = rec["memory"], rec["cost"], rec["roofline"]
    assert mem["peak_estimate_per_device"] > mem["argument_bytes_per_device"]
    assert mem["output_bytes_per_device"] > 0
    assert set(cost["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert cost["collective_bytes_total"] == sum(
        cost["collective_bytes"].values())
    cfg = configs.get("gpt-moe-s")
    assert roof["model_flops"] == 6 * cfg.active_param_count() * 256 * 4096
    assert roof["useful_flops_ratio"] == roof["model_flops"] / (
        cost["flops"] * 256)
    assert rec["memory_model"]["fits_80g_hbm"]


def test_prefill_32k_on_the_16_by_16_grid_is_unsupported():
    rec = dryrun.dryrun_combo("gpt-moe-s", "prefill_32k")
    assert rec["status"] == "unsupported"
    assert "not a multiple of the grid's 256 ranks" in rec["reason"]
    assert "tensor-parallel" in rec["reason"]
    assert not dist.is_initialized()


def test_a_step_that_raises_is_failed_and_main_exits_1(tmp_path,
                                                       monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "run_fake_step", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gpt-moe-s", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.load(open(tmp_path / "gpt_moe_s_train_4k_single_ring.json"))
    assert rec["status"] == "FAILED" and rec["error"] == "boom"
    assert not dist.is_initialized()


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_prefill_and_decode_steps_on_a_small_grid(mode):
    """The serving steps of a dense and an MoE smoke config on a fake 1 x 2
    grid: a record with every section, and the decode's arguments hold the
    dense cache of its rows."""
    shape = tconfig.ShapeConfig(f"small_{mode}", 32, 4, mode)
    for arch in ("gpt-moe-s", "smollm-360m"):
        cfg = configs.get_smoke(arch)
        rec = dryrun.dryrun_combo(cfg, shape, grid=(1, 2))
        assert rec["status"] == "ok", rec
        assert rec["cost"]["flops"] > 0
        assert rec["roofline"]["model_flops"] == \
            2 * cfg.active_param_count() * 4 * (32 if mode == "prefill"
                                                else 1)
        if mode == "decode":
            cache = 2 * cfg.num_layers * 2 * 32 * cfg.num_kv_heads \
                * cfg.head_dim * 4
            assert rec["memory"]["argument_bytes_per_device"] > cache


def test_perf_opts():
    cfg = configs.get_smoke("gpt-moe-s")
    rec = dryrun.dryrun_combo(cfg, SMALL_TRAIN, grid=(1, 1),
                              perf_opts={"capacity_factor": 4.0})
    assert rec["status"] == "ok" and rec["perf_opts"] == {
        "capacity_factor": 4.0}
    for po in ({"grad_constraint": True}, {"sharding_mode": "zero"}):
        with pytest.raises(ValueError, match="not ported"):
            dryrun.dryrun_combo(cfg, SMALL_TRAIN, grid=(1, 1), perf_opts=po)


class _AllOps(cases._IndexOps):
    """Every op's (name, first input's shape, output's shape)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if args and isinstance(args[0], torch.Tensor) \
                and isinstance(out, torch.Tensor):
            self.seen.append((func.overloadpacket.__name__.rstrip("_"),
                              tuple(args[0].shape), tuple(out.shape)))
        return out


def test_smoke_train_step_on_a_fake_grid_has_no_compaction_copies():
    """``tests/test_fused_ffn_path.py``'s acceptance law for the whole
    training step, checked on a fake 2 x 4 grid: gpt-moe-s's smoke step
    through the ring plan runs the grouped FFN over the uncompacted
    (K, M·C, D) layout, and no gather or scatter maps a tensor of that
    shape to another (the layer-level law on real ranks is
    ``tests/test_torch_moe_distributed.py::
    test_ring_call_counts_and_no_compaction_copy``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import moe
    from repro_torch.kernels import ops
    cfg = configs.get_smoke("gpt-moe-s")
    shape = tconfig.ShapeConfig("small_train", 32, 8, "train")
    with fake_grid(2, 4) as g:
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        step, args = dryrun._step_and_args(cfg, shape, g, "ring", mode)
        spy = _AllOps()
        with mode, ops.reference_mode(), spy:
            step(*args)
    pa = args[2]
    K = pa.local_rows.shape[-1] + pa.extra_experts.shape[-1]
    C = moe.auto_capacity(cfg, 32, g.model, K)
    layout = (K, g.model * C, cfg.d_model)
    assert any(op[2] == layout for op in spy.seen)
    assert not [op for op in spy.seen if op[0] in cases._IndexOps.KINDS
                and op[1] == layout and op[2] == layout]
