"""Flash attention forward on the card: wrapper of ``csrc/flash_attention.cu``.

The CUDA kernel replaces the JAX package's Pallas kernel
``repro/kernels/flash_attention.py::_kernel``.  This module checks the
operands, allocates the output, launches on the current stream and counts
launches; ``kernels/ref.flash_attention_ref`` is its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [P, P, P, P, I, I, I, I, I, I,
                                            ctypes.c_float, I, P]
        lib.flash_attention_fwd.restype = I
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q/k/v: (B, S, N, H) contiguous CUDA tensors of one dtype (float32 or
    bfloat16), equal heads; any S >= 1 (the tail tile's query rows are
    zero-filled and not written, its keys zero-filled and masked);
    H <= 128."""
    global launches
    b, s, n, h = q.shape
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one dtype of "
                        f"{list(_DTYPES)}, got {q.dtype, k.dtype, v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if s < 1:
        raise ValueError(f"flash_attention takes S >= 1, got S={s}")
    if h > 128:
        raise ValueError(f"flash_attention kernel takes H <= 128, got {h}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q/k/v")
    o = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, n, h,
        int(causal), int(window), 1.0 / (h ** 0.5), _DTYPES[q.dtype],
        stream)
    _build.check(lib, code, "flash_attention_fwd")
    launches += 1
    return o
