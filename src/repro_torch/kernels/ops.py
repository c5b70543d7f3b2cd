"""The kernel dispatcher, counterpart of the JAX package's
``repro/kernels/ops.py``.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version in ``kernels/ref.py``.  Nothing falls back: a kernel that
fails to build or launch raises.  ``reference_mode()`` is an explicit
opt-in that routes CUDA tensors to the plain versions too, so a caller can
compare the two on the card; only tests and ``chip_smoke.py`` enter it.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_mlp as _gm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

_MODE = threading.local()


@contextlib.contextmanager
def reference_mode():
    """Within this context every op computes its plain version, on
    whatever device its inputs are (thread-local; nests)."""
    prev = getattr(_MODE, "reference", False)
    _MODE.reference = True
    try:
        yield
    finally:
        _MODE.reference = prev


def _use_kernel(t: torch.Tensor) -> bool:
    return t.is_cuda and not getattr(_MODE, "reference", False)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    return {**_gm.LAUNCHES,
            "flash_attention_fwd": _fa.launches,
            "paged_decode_attention": _pa.launches}


def reset_launch_counts() -> None:
    for k in _gm.LAUNCHES:
        _gm.LAUNCHES[k] = 0
    _fa.launches = _pa.launches = 0


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def grouped_mlp(x, wi, wg, wo, group_sizes=None, row_valid=None, *,
                act: str = "silu_glu", train: bool = False):
    """Grouped expert FFN: x (K,T,D) -> (K,T,D).  Validity is
    ``group_sizes`` (K,) (valid-row prefix) or ``row_valid`` (K,T); None =
    every row valid.  Invalid rows come back exactly zero.

    When an operand requires grad, or with ``train``, the call goes
    through ``GroupedMLPFunction``: the training form of the forward, then
    dgrad and wgrad in the backward (kernels for CUDA tensors, their
    step-wise plain versions otherwise); else through the inference form.
    ``train`` without grad is the forward of a layer whose backward
    re-runs it (re-materialization): both runs then give the same bits."""
    if train or _needs_grad(x, wi, wg, wo):
        k_, t_ = x.shape[:2]
        if row_valid is None and group_sizes is None:
            mask = torch.ones((k_, t_), dtype=torch.int32, device=x.device)
        else:
            mask = ref.row_mask(t_, group_sizes, row_valid,
                                device=x.device).to(torch.int32)
        return _gm.GroupedMLPFunction.apply(x, wi, wg, wo, mask, act,
                                            _use_kernel(x))
    if _use_kernel(x):
        return _gm.grouped_mlp(x, wi, wg, wo, group_sizes, row_valid,
                               act=act)
    return ref.grouped_mlp_ref(x, wi, wg, wo, act=act,
                               group_sizes=group_sizes, row_valid=row_valid)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Flash attention, q/k/v (B,S,N,H).  GQA K/V are expanded to the query
    heads here, once per prefill, as the JAX package does.

    The kernel has no backward: a CUDA call whose operands require grad
    raises rather than cut the autograd graph (training runs the plain
    attention, as the JAX package trains with XLA attention)."""
    if _use_kernel(q) and _needs_grad(q, k, v):
        raise RuntimeError("flash_attention: the CUDA kernel has no "
                           "backward; run attention with use_pallas=False "
                           "when gradients are needed")
    nq, nkv = q.shape[2], k.shape[2]
    if nq != nkv:
        rep = nq // nkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    if _use_kernel(q):
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def paged_decode_attention(q, k_pool, v_pool, row_idx, positions, *,
                           page_size: int, window: int = 0,
                           softcap: float = 0.0):
    """Block-paged decode attention over the flat KV pool.

    q: (B, nq, hd); k/v_pool: (num_rows, nkv, hd); row_idx: (B, max_kv)
    int32 per-token pool rows (page-aligned: the kernel consumes the
    page-granular table ``row_idx[:, ::page_size] // page_size``);
    positions: (B,) int32 write positions.  Native GQA."""
    if row_idx.shape[1] % page_size:
        raise ValueError(f"row_idx width {row_idx.shape[1]} is not a "
                         f"multiple of page_size {page_size}")
    if _use_kernel(q):
        block_tbl = (row_idx[:, ::page_size] // page_size).to(
            torch.int32).contiguous()
        return _pa.paged_decode_attention(
            q.contiguous(), k_pool, v_pool, block_tbl,
            positions.to(torch.int32).contiguous(), page_size=page_size,
            window=window, softcap=softcap)
    return ref.paged_decode_attention_ref(q, k_pool, v_pool, row_idx,
                                          positions, window=window,
                                          softcap=softcap)
