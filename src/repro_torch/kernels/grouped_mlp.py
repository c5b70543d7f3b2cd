"""Grouped expert FFN on the card: wrappers of ``csrc/grouped_mlp.cu``
(forward) and ``csrc/grouped_mlp_bwd.cu`` (dgrad, wgrad), and the
``torch.autograd.Function`` that wires the three together.

The CUDA kernels replace the JAX package's Pallas kernels
``repro/kernels/grouped_mlp.py::_fwd_kernel`` (inference and training
form), ``::_dgrad_kernel`` and ``::_wgrad_kernel``.  Each wrapper checks
and prepares the operands, allocates the outputs, launches on the current
stream and counts its launches in ``LAUNCHES``; ``kernels/ref.py`` holds
the plain versions.

In bfloat16 every stage runs on the tensor cores.  The training forward
and dgrad (``csrc/grouped_mlp_tc.cuh``) are two tile products each,
launched over the 64-row token tiles that hold a valid row
(``tile_list``); the outputs' zero rows are written beside them (by the
forward's product blocks, by a bandwidth-bound pass of its own in dgrad).
The list's length sizes a compact scratch (h for the forward, the low half
of dh1 for dgrad), so building it reads one count back to the host;
``GroupedMLPFunction`` builds it once per forward and hands it to dgrad and
wgrad.  wgrad walks each slot's range of that list (``tile_starts``, a
device-side search).  The inference form runs the forward's two products
over a tile list of the length the host knows (every tile, -1 past the
listed ones; ``ref.tile_list_padded``), which its C call builds on the
device, so the serving path reads nothing back.
Float32 keeps the FMA loops of the first port, with the output columns
cut into chunks of 1,024 over blocks (D up to ``F32_MAX_D``; above 3,072
the input rows go through shared memory in two halves of D).
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
_BF = 64              # the float32 kernels' F chunk
# the float32 forward and dgrad keep 16 rows of D f32 values in shared
# memory up to D = 3,072 (csrc/grouped_mlp.cuh GM_MAX_D), and half of them
# at a time up to twice that; bfloat16 has no limit on D
F32_MAX_D = 6144
TC_TILE = 64          # token rows per tile of the tensor-core kernels

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGS = {
    "grouped_mlp": {
        "grouped_mlp_fwd": [_P] * 7 + [_I] * 4 + [_L] * 3 + [_I] * 3 + [_P],
        "grouped_mlp_fwd_bf16": ([_P] * 6 + [_I] + [_P] * 2 + [_I] * 4
                                 + [_L] * 3 + [_I, _P]),
        "grouped_mlp_fwd_train": ([_P] * 8 + [_I] * 4 + [_L] * 3
                                  + [_I] * 2 + [_P]),
        "grouped_mlp_fwd_train_bf16": ([_P] * 6 + [_I] + [_P] * 4
                                       + [_I] * 4 + [_L] * 3 + [_I, _P]),
    },
    "grouped_mlp_bwd": {
        "grouped_mlp_dgrad": [_P] * 11 + [_I] * 6 + [_P],
        "grouped_mlp_dgrad_bf16": ([_P] * 8 + [_I] + [_P] * 5 + [_I] * 4
                                   + [_L] * 3 + [_I, _P]),
        "grouped_mlp_wgrad": [_P] * 11 + [_I] * 5 + [_P],
        "grouped_mlp_wgrad_bf16": [_P] * 11 + [_I] * 4 + [_P],
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
    if x.dtype == torch.float32 and d > F32_MAX_D:
        raise ValueError(f"{what} float32 kernel takes D <= {F32_MAX_D}, "
                         f"got {d}")
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
    y = torch.empty_like(x)
    lib = _lib("grouped_mlp")
    strides = (wi.stride(0), wg.stride(0) if wg is not None else 0,
               wo.stride(0))
    if x.dtype == torch.bfloat16:
        # no host sync: the kernel's tile list and the scratch have the
        # length the host knows, every 64-row tile of the call
        n = k_ * -(-t_ // TC_TILE)
        tiles = torch.empty(n, dtype=torch.int32, device=x.device)
        hs = torch.empty((n * TC_TILE, f_), dtype=x.dtype, device=x.device)
        code = lib.grouped_mlp_fwd_bf16(
            x.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
            mask.data_ptr(), tiles.data_ptr(), tiles.numel(), hs.data_ptr(),
            y.data_ptr(), k_, t_, d, f_, *strides, _act_code(act),
            _stream(x))
    else:
        # a decode-sized call (one sub-tile of rows per slot) gives every
        # 64-wide F chunk its own block, a prefill-sized one four chunks;
        # each F range's partial sums land in its own f32 plane of `part`
        f_split = _BF * (1 if t_ <= 16 else 4)
        part = torch.empty((-(-f_ // f_split), k_, t_, d),
                           dtype=torch.float32, device=x.device)
        code = lib.grouped_mlp_fwd(
            x.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
            mask.data_ptr(), part.data_ptr(), y.data_ptr(), k_, t_, d, f_,
            *strides, f_split, _act_code(act), _DTYPES[x.dtype], _stream(x))
    _build.check(lib, code, "grouped_mlp_fwd")
    LAUNCHES["grouped_mlp_fwd"] += 1
    return y


def grouped_mlp_fwd_train(x, wi, wg, wo, mask, *, act: str = "silu_glu",
                          tiles=None):
    """Training form: ``(y, h1, h2)`` as ``ref.grouped_mlp_fwd_train_ref``
    returns them (h2 None without a gate).  mask: (K, T) CUDA validity.
    y is written whole.  h1 and h2 are written where the token tile holds
    a valid row (zero on its invalid rows: 64-row tiles in bfloat16, 16-row
    sub-tiles in float32) and left unwritten elsewhere, as the Pallas
    kernel leaves its skipped tiles; dgrad reads them at valid rows only.
    ``tiles``: ``tile_list(mask)`` if the caller has it (bfloat16)."""
    k_, t_, d, f_ = _check(x, wi, wg, wo, "grouped_mlp_fwd_train")
    mask = _mask_i32(mask, k_, t_)
    x = x.contiguous()
    _check_slots(wi=wi, wg=wg, wo=wo)
    y = torch.empty_like(x)
    h1 = torch.empty((k_, t_, f_), dtype=x.dtype, device=x.device)
    h2 = None if wg is None else torch.empty_like(h1)
    lib = _lib("grouped_mlp")
    strides = (wi.stride(0), wg.stride(0) if wg is not None else 0,
               wo.stride(0))
    if x.dtype == torch.bfloat16:
        tiles = _tiles(mask, tiles)
        hs = torch.empty((tiles.numel() * TC_TILE, f_), dtype=x.dtype,
                         device=x.device)
        code = lib.grouped_mlp_fwd_train_bf16(
            x.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
            mask.data_ptr(), tiles.data_ptr(), tiles.numel(), hs.data_ptr(),
            y.data_ptr(), h1.data_ptr(), _ptr(h2), k_, t_, d, f_, *strides,
            _act_code(act), _stream(x))
    else:
        code = lib.grouped_mlp_fwd_train(
            x.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
            mask.data_ptr(), y.data_ptr(), h1.data_ptr(), _ptr(h2), k_, t_,
            d, f_, *strides, _act_code(act), _DTYPES[x.dtype], _stream(x))
    _build.check(lib, code, "grouped_mlp_fwd_train")
    LAUNCHES["grouped_mlp_fwd_train"] += 1
    return y, h1, h2


def grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg, wo, *,
                      act: str = "silu_glu", tiles=None):
    """``(dx, dh1, dh2, h)`` as ``ref.grouped_mlp_dgrad_ref`` returns them.
    bfloat16 reads the weights in the layout the slots hold them and takes
    dx from dh1 split into two bfloat16 terms, hi = the dh1 output and
    lo = dh1 - hi (``ref.grouped_mlp_dgrad_split_ref``); ``tiles`` as for
    ``grouped_mlp_fwd_train``.  float32 transposes the weights into
    contiguous copies here (woᵀ (K, D, F), wiᵀ/wgᵀ (K, F, D)), so that its
    loops read them along their rows."""
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
    dx = torch.empty_like(dy)
    dh1 = torch.empty_like(h1)
    h = torch.empty_like(h1)
    dh2 = None if wg is None else torch.empty_like(h1)
    lib = _lib("grouped_mlp_bwd")
    if dy.dtype == torch.bfloat16:
        _check_slots(wi=wi, wg=wg, wo=wo)
        tiles = _tiles(mask, tiles)
        lo = torch.empty(((2 if wg is not None else 1) * tiles.numel()
                          * TC_TILE, f_), dtype=dy.dtype, device=dy.device)
        code = lib.grouped_mlp_dgrad_bf16(
            dy.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(),
            mask.data_ptr(), h1.data_ptr(), _ptr(h2), tiles.data_ptr(),
            tiles.numel(), lo.data_ptr(), dx.data_ptr(), dh1.data_ptr(),
            _ptr(dh2), h.data_ptr(), k_, t_, d, f_, wi.stride(0),
            wg.stride(0) if wg is not None else 0, wo.stride(0),
            _act_code(act), _stream(dy))
    else:
        wo_t = wo.transpose(1, 2).contiguous()
        wi_t = wi.transpose(1, 2).contiguous()
        wg_t = None if wg is None else wg.transpose(1, 2).contiguous()
        code = lib.grouped_mlp_dgrad(
            dy.data_ptr(), wo_t.data_ptr(), wi_t.data_ptr(), _ptr(wg_t),
            mask.data_ptr(), h1.data_ptr(), _ptr(h2), dx.data_ptr(),
            dh1.data_ptr(), _ptr(dh2), h.data_ptr(), k_, t_, d, f_,
            _act_code(act), _DTYPES[dy.dtype], _stream(dy))
    _build.check(lib, code, "grouped_mlp_dgrad")
    LAUNCHES["grouped_mlp_dgrad"] += 1
    return dx, dh1, dh2, h


def tile_list(mask, tile: int = TC_TILE):
    """mask (K, T) -> int32 ids ``k * ceil(T/tile) + t`` of the token tiles
    that hold a valid row, in increasing order: the grid of the tensor-core
    training kernels.  Its length sizes their scratch, so this reads one
    count back to the host."""
    return ref.tile_hits(mask, tile).flatten().nonzero().flatten() \
        .to(torch.int32)


def tile_starts(tiles, k_: int, t_: int, tile: int = TC_TILE):
    """(K + 1,) int32 for a list as ``tile_list`` returns it: slot k's
    tiles are ``tiles[starts[k]:starts[k + 1]]`` (the list is sorted by
    ``k * ceil(T/tile) + t``).  A search on the device; no host sync."""
    nt = -(-t_ // tile)
    bounds = torch.arange(k_ + 1, dtype=torch.int32, device=tiles.device)
    return torch.searchsorted(tiles, bounds * nt, out_int32=True)


def _tiles(mask, tiles):
    """``tiles`` as the caller gave it (checked), else ``tile_list(mask)``."""
    if tiles is None:
        return tile_list(mask)
    if tiles.dtype != torch.int32 or tiles.dim() != 1 or not tiles.is_cuda:
        raise ValueError("tiles must be a 1-D CUDA int32 tensor, as "
                         "tile_list returns it")
    return tiles.contiguous()


def grouped_mlp_wgrad(x, dy, mask, dh1, dh2, h, *, tiles=None):
    """``(dwi, dwg, dwo)`` as ``ref.grouped_mlp_wgrad_ref`` returns them,
    in x's dtype.  ``tiles``: ``tile_list(mask)`` if the caller has it, as
    ``GroupedMLPFunction`` does; else it is built here (one host sync)."""
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
    tiles = _tiles(mask, tiles)
    starts = tile_starts(tiles, k_, t_)
    dwi = torch.empty((k_, d, f_), dtype=x.dtype, device=x.device)
    dwg = None if dh2 is None else torch.empty_like(dwi)
    dwo = torch.empty((k_, f_, d), dtype=x.dtype, device=x.device)
    lib = _lib("grouped_mlp_bwd")
    args = (x.data_ptr(), dy.data_ptr(), mask.data_ptr(), dh1.data_ptr(),
            _ptr(dh2), h.data_ptr(), tiles.data_ptr(), starts.data_ptr(),
            dwi.data_ptr(), _ptr(dwg), dwo.data_ptr(), k_, t_, d, f_)
    if x.dtype == torch.bfloat16:
        code = lib.grouped_mlp_wgrad_bf16(*args, _stream(x))
    else:
        code = lib.grouped_mlp_wgrad(*args, _DTYPES[x.dtype], _stream(x))
    _build.check(lib, code, "grouped_mlp_wgrad")
    LAUNCHES["grouped_mlp_wgrad"] += 1
    return dwi, dwg, dwo


class GroupedMLPFunction(torch.autograd.Function):
    """The grouped expert FFN with its backward: the port of the JAX
    package's ``_make_grouped_mlp`` custom VJP.

    ``apply(x, wi, wg, wo, mask, act, kernel)``: the forward runs the
    training form and saves ``(x, wi, wg, wo, mask, h1, h2)``; the backward
    runs dgrad, then wgrad, and gives invalid rows exactly zero gradient.
    In bfloat16 the forward builds the tensor-core kernels' tile list once
    and hands it to all three stages.
    ``kernel`` picks the stages: the CUDA kernels, or the step-wise plain
    versions of ``kernels/ref.py`` (CPU tensors, or ``reference_mode``).
    It is fixed at the forward, because the backward runs on autograd's
    own thread.  wg may be None (no gate); mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, wi, wg, wo, mask, act, kernel):
        ctx.tiles = None
        if kernel:
            if x.dtype == torch.bfloat16:       # one host sync, shared
                ctx.tiles = tile_list(mask)
            y, h1, h2 = grouped_mlp_fwd_train(x, wi, wg, wo, mask, act=act,
                                              tiles=ctx.tiles)
        else:
            y, h1, h2 = ref.grouped_mlp_fwd_train_ref(x, wi, wg, wo, mask,
                                                      act=act)
        ctx.save_for_backward(x, wi, wg, wo, mask, h1, h2)
        ctx.act, ctx.kernel = act, kernel
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wi, wg, wo, mask, h1, h2 = ctx.saved_tensors
        if ctx.kernel:
            dx, dh1, dh2, h = grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg, wo,
                                                act=ctx.act, tiles=ctx.tiles)
            dwi, dwg, dwo = grouped_mlp_wgrad(x, dy, mask, dh1, dh2, h,
                                              tiles=ctx.tiles)
        else:
            dx, dh1, dh2, h = ref.grouped_mlp_dgrad_ref(dy, mask, h1, h2, wi,
                                                        wg, wo, act=ctx.act)
            dwi, dwg, dwo = ref.grouped_mlp_wgrad_ref(x, dy, mask, dh1, dh2,
                                                      h)
        return (dx, dwi.to(wi.dtype), None if wg is None else
                dwg.to(wg.dtype), dwo.to(wo.dtype), None, None, None)
