"""Grouped expert FFN forward on the card: wrapper of ``csrc/grouped_mlp.cu``.

The CUDA kernel replaces the JAX package's Pallas kernel
``repro/kernels/grouped_mlp.py::_fwd_kernel`` (inference form).  This
module checks and prepares the operands, allocates the output, launches on
the current stream and counts launches; ``kernels/ref.grouped_mlp_ref`` is
its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import row_mask

launches = 0          # kernel launches since the last reset
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"gelu": 0, "silu": 1}
_BF = 64              # the kernel's F chunk


def _lib():
    lib = _build.load("grouped_mlp")
    if lib.grouped_mlp_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        L = ctypes.c_longlong
        lib.grouped_mlp_fwd.argtypes = [P, P, P, P, P, P, P, I, I, I, I, L,
                                        L, L, I, I, I, P]
        lib.grouped_mlp_fwd.restype = I
    return lib


def grouped_mlp(x, wi, wg, wo, group_sizes=None, row_valid=None, *,
                act: str = "silu_glu"):
    """x: (K, T, D); wi/wg: (K, D, F); wo: (K, F, D); CUDA tensors of one
    dtype (float32 or bfloat16).  Validity: ``group_sizes`` (K,) or
    ``row_valid`` (K, T) (wins); None = every row valid.  Returns (K, T, D)
    with invalid rows exactly zero."""
    global launches
    k_, t_, d = x.shape
    f_ = wi.shape[-1]
    ops_ = [x, wi, wo] + ([wg] if wg is not None else [])
    if not all(a.is_cuda for a in ops_):
        raise ValueError("grouped_mlp kernel needs CUDA tensors")
    if x.dtype not in _DTYPES or any(a.dtype != x.dtype for a in ops_):
        raise TypeError(f"grouped_mlp kernel takes one dtype of "
                        f"{list(_DTYPES)}, got {[a.dtype for a in ops_]}")
    if wi.shape != (k_, d, f_) or wo.shape != (k_, f_, d) or (
            wg is not None and wg.shape != wi.shape):
        raise ValueError(f"grouped_mlp shapes: x {tuple(x.shape)}, wi "
                         f"{tuple(wi.shape)}, wo {tuple(wo.shape)}")
    if d > 1024:
        raise ValueError(f"grouped_mlp kernel takes D <= 1024, got {d}")
    if row_valid is None and group_sizes is None:
        mask = torch.ones((k_, t_), dtype=torch.int32, device=x.device)
    else:
        mask = row_mask(t_, group_sizes, row_valid,
                        device=x.device).to(torch.int32).contiguous()
    if mask.shape != (k_, t_):
        raise ValueError(f"validity shape {tuple(mask.shape)} != {(k_, t_)}")
    if not x.is_contiguous():
        raise ValueError("grouped_mlp kernel needs a contiguous x")
    for name, a in (("wi", wi), ("wg", wg), ("wo", wo)):
        # slot k may sit anywhere (a view into the (K, chunk_len) slots);
        # within a slot the matrix must be dense row-major
        if a is not None and a.stride()[1:] != (a.shape[2], 1):
            raise ValueError(f"grouped_mlp kernel needs {name} contiguous "
                             f"within each slot, strides {a.stride()}")
    # a decode-sized call (one sub-tile of rows per slot) gives every
    # 64-wide F chunk its own block, a prefill-sized one four chunks; each
    # F range's partial sums land in its own f32 plane of `part`
    f_split = _BF * (1 if t_ <= 16 else 4)
    part = torch.empty((-(-f_ // f_split), k_, t_, d), dtype=torch.float32,
                       device=x.device)
    y = torch.empty_like(x)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.grouped_mlp_fwd(
        x.data_ptr(), wi.data_ptr(), wg.data_ptr() if wg is not None else None,
        wo.data_ptr(), mask.data_ptr(), part.data_ptr(), y.data_ptr(), k_,
        t_, d, f_,
        wi.stride(0), wg.stride(0) if wg is not None else 0, wo.stride(0),
        f_split, _ACTS["silu" if act.startswith("silu") else "gelu"],
        _DTYPES[x.dtype], stream)
    _build.check(lib, code, "grouped_mlp_fwd")
    launches += 1
    return y
