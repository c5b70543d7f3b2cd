"""``tests/test_models.py``'s laws of RoPE, the sliding-window mask, the
final logit softcap and the prefill cache for the port (no JAX: laws, not
comparisons).  That file's M-RoPE, attention-decode and Mamba-2 laws are
``tests/test_torch_families.py``'s, held to JAX there."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers as ly  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve.engine import (build_prefill_step,  # noqa: E402
                                      build_serve_step)


def test_rope_rotation_preserves_norm():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 4, 64)).astype(np.float32))
    pos = torch.arange(8).expand(2, 8)
    y = ly.apply_rope(x, pos, 10_000.0)
    np.testing.assert_allclose(x.norm(dim=-1).numpy(),
                               y.norm(dim=-1).numpy(), rtol=1e-4)


def test_rope_relative_property():
    """<rope(q, i), rope(k, j)> depends only on i - j."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 1, 1, 64)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 1, 64)).astype(
        np.float32))

    def dot_at(i, j):
        qi = ly.apply_rope(q, torch.full((1, 1), i), 10_000.0)
        kj = ly.apply_rope(k, torch.full((1, 1), j), 10_000.0)
        return float((qi * kj).sum())
    assert abs(dot_at(3, 1) - dot_at(10, 8)) < 1e-3


def test_sliding_window_mask():
    m = attn.make_mask(6, 6, causal=True, window=3)[0, 0].numpy()
    assert m[5, 5] and m[5, 3] and not m[5, 2]      # a window of 3
    assert not m[0, 1]                              # causal


def test_final_softcap_bounds_logits():
    cfg = configs.get_smoke("gemma2-9b")
    params = mdl.init_params(cfg, 0, "cpu")
    with torch.no_grad():
        logits, _ = mdl.forward(cfg, mdl.Runtime(), params,
                                torch.zeros((1, 8), dtype=torch.int32))
    assert float(logits.abs().max()) <= cfg.final_logit_softcap + 1e-3


def test_prefill_cache_matches_decode_path():
    """The prefill step's cache continues as a loop of decode steps
    would."""
    cfg = configs.get_smoke("smollm-360m")
    rt = mdl.Runtime()
    params = mdl.init_params(cfg, 3, "cpu")
    P = 6
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, P)).astype(np.int32))
    last, cache = build_prefill_step(cfg, rt)(params, {"tokens": toks},
                                              None)
    cache2 = mdl.init_cache(cfg, 2, P, "cpu")
    step = build_serve_step(cfg, rt)
    for i in range(P):
        logits, cache2 = step(params, cache2, toks[:, i:i + 1], i, None)
    np.testing.assert_allclose(last.numpy(), logits.numpy(), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(cache["l0"]["k"].numpy(),
                               cache2["l0"]["k"][:, :, :P].numpy(),
                               atol=1e-4, rtol=1e-3)
