"""Paged decode attention on the card: wrapper of ``csrc/paged_attention.cu``.

The CUDA kernel replaces the JAX package's Pallas kernel
``repro/kernels/paged_attention.py::_kernel``.  This module checks the
operands, allocates the output, launches on the current stream and counts
launches; ``kernels/ref.paged_decode_attention_ref`` is its plain version
(it takes the per-token ``row_idx``, this wrapper the page table derived
from it in ``kernels/ops.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("paged_attention")
    if lib.paged_decode_attention.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_attention.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                               I, I, I, I, F, F, I, P]
        lib.paged_decode_attention.restype = I
    return lib


def paged_decode_attention(q, k_pool, v_pool, block_tbl, positions, *,
                           page_size: int, window: int = 0,
                           softcap: float = 0.0):
    """q: (B, nq, hd); k/v_pool: (num_rows, nkv, hd) flat page pool;
    block_tbl: (B, max_kv/page_size) int32 pool-page ids; positions: (B,)
    int32 write positions.  CUDA tensors; q and the pools of one dtype
    (float32 or bfloat16); hd <= 256.  Returns (B, nq, hd) in q's
    dtype."""
    global launches
    b, nq, h = q.shape
    num_rows, nkv, hk = k_pool.shape
    ts = (q, k_pool, v_pool, block_tbl, positions)
    if not all(t.is_cuda for t in ts):
        raise ValueError("paged_decode_attention kernel needs CUDA tensors")
    if (q.dtype not in _DTYPES or k_pool.dtype != q.dtype
            or v_pool.dtype != q.dtype):
        raise TypeError(f"paged_decode_attention takes one dtype of "
                        f"{list(_DTYPES)}, got "
                        f"{q.dtype, k_pool.dtype, v_pool.dtype}")
    if block_tbl.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("block_tbl and positions must be int32")
    if (hk != h or v_pool.shape != k_pool.shape or nq % nkv
            or num_rows % page_size or block_tbl.dim() != 2
            or block_tbl.shape[0] != b or positions.shape != (b,)):
        raise ValueError(
            f"paged_decode_attention shapes: q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, table {tuple(block_tbl.shape)}, "
            f"positions {tuple(positions.shape)}, page_size {page_size}")
    if h > 256:
        raise ValueError(f"paged_decode_attention takes hd <= 256, got {h}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode_attention needs contiguous tensors")
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tbl.data_ptr(), positions.data_ptr(), out.data_ptr(), b, nq,
        nkv, h, num_rows, block_tbl.shape[1], page_size, int(window),
        float(softcap), 1.0 / (h ** 0.5), _DTYPES[q.dtype], stream)
    _build.check(lib, code, "paged_decode_attention")
    launches += 1
    return out
