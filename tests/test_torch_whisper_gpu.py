"""Whisper on the card: the flash-attention kernel (B4) inside the
decoder's one-shot prefill.  Every test needs a CUDA device and skips
without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_whisper_gpu.py

At full width cut to 2 encoder and 2 decoder layers in f32 (no route to
flip: Whisper has no experts) the prefill through B4 gives the plain
path's logits and cache within ``TOL`` of their largest entry; the
encoder and the cross attention take the plain path in both, so B4
launches once per decoder layer; and two identical bf16 prefills give
the same bits.  ``TOL`` is ``chip_smoke.py``'s for its f32 cuts: B4 sums
in another order than the plain version, and the random-init model
amplifies that (``tools/whisper_f32_error.py``); measured on an H100,
the logits lie 1.1e-4 of the largest apart at 448 tokens, 1.8e-5 at 90.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _setup(dev, dtype, S):
    cfg = configs.get("whisper-medium").replace(num_layers=2,
                                                encoder_layers=2,
                                                dtype=dtype)
    params = mdl.init_params(cfg, 0, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, S),
                                     generator=g, device=dev,
                                     dtype=torch.int32),
             "encoder_input": torch.randn((2, cfg.encoder_seq_len,
                                           cfg.d_model), generator=g,
                                          device=dev)}
    return cfg, params, batch


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


@pytest.mark.gpu
@pytest.mark.parametrize("S", [17, 300, 448])
def test_prefill_through_b4_matches_the_plain_path(cuda, S):
    cfg, params, batch = _setup(cuda, "float32", S)
    prefill = engine.build_prefill_step(cfg, mdl.Runtime())
    n0 = ops.launch_counts()["flash_attention_fwd"]
    got_l, got_c = prefill(params, batch, None)
    assert ops.launch_counts()["flash_attention_fwd"] - n0 == \
        cfg.num_layers
    with ops.reference_mode():
        want_l, want_c = prefill(params, batch, None)
    scale = float(want_l.abs().max())
    assert float((got_l - want_l).abs().max()) <= TOL * scale
    want = dict(_flat(want_c))
    assert sorted(want) == ["l0/k", "l0/v", "xk", "xv"]
    for k, t in _flat(got_c):
        assert float((t - want[k]).abs().max()) <= \
            TOL * float(want[k].abs().max()), k


@pytest.mark.gpu
def test_two_identical_bf16_prefills_are_bitwise_equal(cuda):
    cfg, params, batch = _setup(cuda, "bfloat16", 90)
    prefill = engine.build_prefill_step(cfg, mdl.Runtime())
    a_l, a_c = prefill(params, batch, None)
    b_l, b_c = prefill(params, batch, None)
    assert torch.equal(a_l, b_l)
    for (k, x), (_, y) in zip(_flat(a_c), _flat(b_c)):
        assert torch.equal(x, y), k
