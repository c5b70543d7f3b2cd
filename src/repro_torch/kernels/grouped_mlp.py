"""Grouped expert FFN on the card: wrappers of ``csrc/grouped_mlp.cu``
(forward) and ``csrc/grouped_mlp_bwd.cu`` (dgrad, wgrad), and the
``torch.autograd.Function`` that wires the three together.

The CUDA kernels replace the JAX package's Pallas kernels
``repro/kernels/grouped_mlp.py::_fwd_kernel`` (inference and training
form), ``::_dgrad_kernel`` and ``::_wgrad_kernel``.  Each wrapper checks
and prepares the operands, allocates the outputs, launches on the current
stream and counts its launches in ``LAUNCHES``; ``kernels/ref.py`` holds
the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.ref import row_mask

# kernel launches since the last reset, per entry point
LAUNCHES = {"grouped_mlp_fwd": 0, "grouped_mlp_fwd_train": 0,
            "grouped_mlp_dgrad": 0, "grouped_mlp_wgrad": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"gelu": 0, "silu": 1}
_BF = 64              # the kernels' F chunk
_WG_TILE = 32         # token rows per staged tile of wgrad

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGS = {
    "grouped_mlp": {
        "grouped_mlp_fwd": [_P] * 7 + [_I] * 4 + [_L] * 3 + [_I] * 3 + [_P],
        "grouped_mlp_fwd_train": ([_P] * 8 + [_I] * 4 + [_L] * 3
                                  + [_I] * 2 + [_P]),
    },
    "grouped_mlp_bwd": {
        "grouped_mlp_dgrad": [_P] * 11 + [_I] * 6 + [_P],
        "grouped_mlp_wgrad": [_P] * 11 + [_I] * 6 + [_P],
    },
}


def _lib(name: str):
    lib = _build.load(name)
    for fn, args in _SIGS[name].items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = args
            f.restype = _I
    return lib


def _act_code(act: str) -> int:
    return _ACTS["silu" if act.startswith("silu") else "gelu"]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(x, wi, wg, wo, what: str):
    """Device, dtype and shape checks shared by the entry points; returns
    (K, T, D, F)."""
    k_, t_, d = x.shape
    f_ = wi.shape[-1]
    ops_ = [x, wi, wo] + ([wg] if wg is not None else [])
    if not all(a.is_cuda for a in ops_):
        raise ValueError(f"{what} kernel needs CUDA tensors")
    if x.dtype not in _DTYPES or any(a.dtype != x.dtype for a in ops_):
        raise TypeError(f"{what} kernel takes one dtype of {list(_DTYPES)}, "
                        f"got {[a.dtype for a in ops_]}")
    if wi.shape != (k_, d, f_) or wo.shape != (k_, f_, d) or (
            wg is not None and wg.shape != wi.shape):
        raise ValueError(f"{what} shapes: x {tuple(x.shape)}, wi "
                         f"{tuple(wi.shape)}, wo {tuple(wo.shape)}")
    if d > 1024:
        raise ValueError(f"{what} kernel takes D <= 1024, got {d}")
    return k_, t_, d, f_


def _check_slots(**mats):
    """Slot k may sit anywhere (a view into the (K, chunk_len) slots);
    within a slot the matrix must be dense row-major."""
    for name, a in mats.items():
        if a is not None and a.stride()[1:] != (a.shape[2], 1):
            raise ValueError(f"grouped_mlp kernel needs {name} contiguous "
                             f"within each slot, strides {a.stride()}")


def _mask_i32(mask, k_, t_):
    if mask.shape != (k_, t_) or not mask.is_cuda:
        raise ValueError(f"validity must be a CUDA (K, T) = {(k_, t_)} "
                         f"tensor, got {tuple(mask.shape)}")
    return mask.to(torch.int32).contiguous()


def grouped_mlp(x, wi, wg, wo, group_sizes=None, row_valid=None, *,
                act: str = "silu_glu"):
    """Inference form.  x: (K, T, D); wi/wg: (K, D, F); wo: (K, F, D); CUDA
    tensors of one dtype (float32 or bfloat16).  Validity: ``group_sizes``
    (K,) or ``row_valid`` (K, T) (wins); None = every row valid.  Returns
    (K, T, D) with invalid rows exactly zero."""
    k_, t_, d, f_ = _check(x, wi, wg, wo, "grouped_mlp")
    if row_valid is None and group_sizes is None:
        mask = torch.ones((k_, t_), dtype=torch.int32, device=x.device)
    else:
        mask = _mask_i32(row_mask(t_, group_sizes, row_valid,
                                  device=x.device), k_, t_)
    if not x.is_contiguous():
        raise ValueError("grouped_mlp kernel needs a contiguous x")
    _check_slots(wi=wi, wg=wg, wo=wo)
    # a decode-sized call (one sub-tile of rows per slot) gives every
    # 64-wide F chunk its own block, a prefill-sized one four chunks; each
    # F range's partial sums land in its own f32 plane of `part`
    f_split = _BF * (1 if t_ <= 16 else 4)
    part = torch.empty((-(-f_ // f_split), k_, t_, d), dtype=torch.float32,
                       device=x.device)
    y = torch.empty_like(x)
    lib = _lib("grouped_mlp")
    code = lib.grouped_mlp_fwd(
        x.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
        mask.data_ptr(), part.data_ptr(), y.data_ptr(), k_, t_, d, f_,
        wi.stride(0), wg.stride(0) if wg is not None else 0, wo.stride(0),
        f_split, _act_code(act), _DTYPES[x.dtype], _stream(x))
    _build.check(lib, code, "grouped_mlp_fwd")
    LAUNCHES["grouped_mlp_fwd"] += 1
    return y


def grouped_mlp_fwd_train(x, wi, wg, wo, mask, *, act: str = "silu_glu"):
    """Training form: ``(y, h1, h2)`` as ``ref.grouped_mlp_fwd_train_ref``
    returns them (h2 None without a gate).  mask: (K, T) CUDA validity.
    y is written whole; h1 and h2 only in the 16-row sub-tiles that hold a
    valid row (elsewhere they are left unwritten, as the Pallas kernel
    leaves its skipped tiles, and dgrad reads them at valid rows only)."""
    k_, t_, d, f_ = _check(x, wi, wg, wo, "grouped_mlp_fwd_train")
    mask = _mask_i32(mask, k_, t_)
    x = x.contiguous()
    _check_slots(wi=wi, wg=wg, wo=wo)
    y = torch.empty_like(x)
    h1 = torch.empty((k_, t_, f_), dtype=x.dtype, device=x.device)
    h2 = None if wg is None else torch.empty_like(h1)
    lib = _lib("grouped_mlp")
    code = lib.grouped_mlp_fwd_train(
        x.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
        mask.data_ptr(), y.data_ptr(), h1.data_ptr(), _ptr(h2), k_, t_, d,
        f_, wi.stride(0), wg.stride(0) if wg is not None else 0,
        wo.stride(0), _act_code(act), _DTYPES[x.dtype], _stream(x))
    _build.check(lib, code, "grouped_mlp_fwd_train")
    LAUNCHES["grouped_mlp_fwd_train"] += 1
    return y, h1, h2


def grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg, wo, *,
                      act: str = "silu_glu"):
    """``(dx, dh1, dh2, h)`` as ``ref.grouped_mlp_dgrad_ref`` returns them.
    The weights are transposed into contiguous copies here (woᵀ (K, D, F),
    wiᵀ/wgᵀ (K, F, D)), so that the kernel's loops read them along their
    rows."""
    k_, t_, d, f_ = _check(dy, wi, wg, wo, "grouped_mlp_dgrad")
    mask = _mask_i32(mask, k_, t_)
    if h1.shape != (k_, t_, f_) or (wg is not None and (
            h2 is None or h2.shape != h1.shape)):
        raise ValueError(f"grouped_mlp_dgrad residual shapes "
                         f"{tuple(h1.shape)} != {(k_, t_, f_)}")
    if any(a is not None and a.dtype != dy.dtype for a in (h1, h2)):
        raise TypeError("grouped_mlp_dgrad residuals must be of dy's dtype")
    dy, h1 = dy.contiguous(), h1.contiguous()
    h2 = None if wg is None else h2.contiguous()
    wo_t = wo.transpose(1, 2).contiguous()
    wi_t = wi.transpose(1, 2).contiguous()
    wg_t = None if wg is None else wg.transpose(1, 2).contiguous()
    dx = torch.empty_like(dy)
    dh1 = torch.empty_like(h1)
    h = torch.empty_like(h1)
    dh2 = None if wg is None else torch.empty_like(h1)
    lib = _lib("grouped_mlp_bwd")
    code = lib.grouped_mlp_dgrad(
        dy.data_ptr(), wo_t.data_ptr(), wi_t.data_ptr(), _ptr(wg_t),
        mask.data_ptr(), h1.data_ptr(), _ptr(h2), dx.data_ptr(),
        dh1.data_ptr(), _ptr(dh2), h.data_ptr(), k_, t_, d, f_,
        _act_code(act), _DTYPES[dy.dtype], _stream(dy))
    _build.check(lib, code, "grouped_mlp_dgrad")
    LAUNCHES["grouped_mlp_dgrad"] += 1
    return dx, dh1, dh2, h


def valid_tiles(mask, tile: int = _WG_TILE):
    """mask (K, T) -> (tiles (K, ceil(T/tile)) int32, counts (K,) int32):
    slot k's token tiles that hold a valid row come first in ``tiles[k]``,
    in increasing order, and ``counts[k]`` says how many there are (a
    stable sort on the device; no host sync)."""
    k_, t_ = mask.shape
    nt = -(-t_ // tile)
    m = torch.nn.functional.pad(mask.bool(), (0, nt * tile - t_))
    hit = m.view(k_, nt, tile).any(-1)
    tiles = torch.argsort((~hit).to(torch.uint8), dim=1, stable=True)
    return (tiles.to(torch.int32).contiguous(),
            hit.sum(1).to(torch.int32).contiguous())


def grouped_mlp_wgrad(x, dy, mask, dh1, dh2, h):
    """``(dwi, dwg, dwo)`` as ``ref.grouped_mlp_wgrad_ref`` returns them,
    in x's dtype."""
    k_, t_, d = x.shape
    f_ = dh1.shape[-1]
    ops_ = [x, dy, dh1, h] + ([dh2] if dh2 is not None else [])
    if not all(a.is_cuda for a in ops_):
        raise ValueError("grouped_mlp_wgrad kernel needs CUDA tensors")
    if x.dtype not in _DTYPES or any(a.dtype != x.dtype for a in ops_):
        raise TypeError(f"grouped_mlp_wgrad kernel takes one dtype of "
                        f"{list(_DTYPES)}, got {[a.dtype for a in ops_]}")
    if dy.shape != x.shape or any(a.shape != (k_, t_, f_) for a in ops_[2:]):
        raise ValueError("grouped_mlp_wgrad shapes disagree")
    mask = _mask_i32(mask, k_, t_)
    x, dy, dh1, h = (a.contiguous() for a in (x, dy, dh1, h))
    dh2 = None if dh2 is None else dh2.contiguous()
    tiles, counts = valid_tiles(mask)
    dwi = torch.empty((k_, d, f_), dtype=x.dtype, device=x.device)
    dwg = None if dh2 is None else torch.empty_like(dwi)
    dwo = torch.empty((k_, f_, d), dtype=x.dtype, device=x.device)
    lib = _lib("grouped_mlp_bwd")
    code = lib.grouped_mlp_wgrad(
        x.data_ptr(), dy.data_ptr(), mask.data_ptr(), dh1.data_ptr(),
        _ptr(dh2), h.data_ptr(), tiles.data_ptr(), counts.data_ptr(),
        dwi.data_ptr(), _ptr(dwg), dwo.data_ptr(), k_, t_, d, f_,
        tiles.shape[1], _DTYPES[x.dtype], _stream(x))
    _build.check(lib, code, "grouped_mlp_wgrad")
    LAUNCHES["grouped_mlp_wgrad"] += 1
    return dwi, dwg, dwo


class GroupedMLPFunction(torch.autograd.Function):
    """The grouped expert FFN with its backward: the port of the JAX
    package's ``_make_grouped_mlp`` custom VJP.

    ``apply(x, wi, wg, wo, mask, act, kernel)``: the forward runs the
    training form and saves ``(x, wi, wg, wo, mask, h1, h2)``; the backward
    runs dgrad, then wgrad, and gives invalid rows exactly zero gradient.
    ``kernel`` picks the stages: the CUDA kernels, or the step-wise plain
    versions of ``kernels/ref.py`` (CPU tensors, or ``reference_mode``).
    It is fixed at the forward, because the backward runs on autograd's
    own thread.  wg may be None (no gate); mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, wi, wg, wo, mask, act, kernel):
        fwd = grouped_mlp_fwd_train if kernel else \
            ref.grouped_mlp_fwd_train_ref
        y, h1, h2 = fwd(x, wi, wg, wo, mask, act=act)
        ctx.save_for_backward(x, wi, wg, wo, mask, h1, h2)
        ctx.act, ctx.kernel = act, kernel
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wi, wg, wo, mask, h1, h2 = ctx.saved_tensors
        dgrad, wgrad = ((grouped_mlp_dgrad, grouped_mlp_wgrad) if ctx.kernel
                        else (ref.grouped_mlp_dgrad_ref,
                              ref.grouped_mlp_wgrad_ref))
        dx, dh1, dh2, h = dgrad(dy, mask, h1, h2, wi, wg, wo, act=ctx.act)
        dwi, dwg, dwo = wgrad(x, dy, mask, dh1, dh2, h)
        return (dx, dwi.to(wi.dtype), None if wg is None else
                dwg.to(wg.dtype), dwo.to(wo.dtype), None, None, None)
