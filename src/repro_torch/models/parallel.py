"""The dense layouts on a process grid: what a rank holds of each dense
parameter, of the batch and of the decode cache under the reference's
``tp`` or ``zero`` mode (``common.sharding``), and the explicit
collectives its step runs in place of what GSPMD inserts there.

A ``Layout`` rides on ``models.model.Runtime.layout`` (None: every dense
parameter whole on every rank, whole rows of the batch on each, the
port's first grid layout).  Under a layout:

* the batch's rows are split over ``row_axes`` (the ``batch`` rule,
  shape-aware on the global batch) and replicated over ``rep_axes``, the
  other axes; in ``tp`` that is ``model``, where the heads, the FFN's
  hidden units and the vocabulary run tensor-parallel;
* a dimension split over an axis the rows are replicated over stays split
  (tensor parallelism: column-parallel projections, then one sum over the
  axis, ``all_reduce``); every other split (d_model's FSDP split over
  ``data``, or ``(data, model)`` in ``zero``) is all-gathered just before
  its layer uses it (``gather``), and its gradient goes back to the shard
  through the gather's transpose: a reduce-scatter with
  ``grad_constraint``, else an all-reduce of the gathered gradient of
  which the rank keeps its slice (the reference's description of the
  option);
* every collective's backward is its exact transpose, and a rank's share
  of the loss is its rows' part divided by the number of ranks that hold
  the same rows, so the gradient of a leaf is the sum over every axis the
  leaf is replicated over (``train.step``).

The decode cache is sequence-sharded over ``data`` where the global batch
is smaller than the product of the non-``model`` axes (the reference's
``kv_cache_axes``: ``long_500k``'s one sequence); the rows are then
replicated over ``data`` and the partial softmaxes of the ranks combine
by log-sum-exp (``models.attention``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.common import sharding as shd


def _gather_dim(x, dim: int, group, n: int):
    """The concatenation of every rank's ``x`` along ``dim``, in the
    group's rank order."""
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(g, dim: int, group, n: int):
    gm = g.movedim(dim, 0).contiguous()
    out = gm.new_empty((gm.shape[0] // n,) + tuple(gm.shape[1:]))
    dist.reduce_scatter_tensor(out, gm, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _sum(x, group):
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward is its transpose: a
    reduce-scatter (``scatter``), or the sum over the group of which this
    rank keeps its block ``index``."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index, scatter):
        ctx.args = dim, group, n, index, scatter
        return _gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, index, scatter = ctx.args
        if scatter:
            gx = _reduce_scatter_dim(g, dim, group, n)
        else:
            gx = _sum(g, group).chunk(n, dim)[index]
        return gx, None, None, None, None, None


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the backward is the same sum (the transpose of
    a sum whose result every rank holds)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def _strip(tree):
    """A stacked subtree's layouts without the leading ``layers`` dim."""
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items()}
    return tree[1:]


class Layout:
    """One rank's view of a dense layout (see the module docstring).

    ``dims``: the parameter tree's layouts, each leaf a tuple of the grid
    axes each dimension is split over (``models.model.make_layout``
    builds it from the declarations).  ``global_batch``: the step's batch
    size, from which the rows' split and the cache's follow."""

    def __init__(self, grid, mode: str, dims, global_batch: int,
                 grad_constraint: bool = False):
        self.grid, self.mode, self.dims = grid, mode, dims
        self.grad_constraint = bool(grad_constraint)
        self.sizes = grid.sizes
        self.coord = grid.coord
        self.rules = shd.resolve_rules(list(self.sizes),
                                       shd.mode_rules(mode))
        self.global_batch = int(global_batch)
        self.row_axes = self.layout_of((global_batch,), ("batch",))[0]
        self.rep_axes = tuple(a for a in self.sizes
                              if a not in self.row_axes)
        # the reference's kv_cache_axes(batch, mesh_batch_size(mesh))
        mesh_batch = shd.axes_size([a for a in self.sizes if a != "model"],
                                   self.sizes)
        self.seq_axes = (self.layout_of((mesh_batch,), ("seq_shard",))[0]
                         if global_batch < mesh_batch else ())
        self.block_dims = _strip(dims["blocks"])
        self.enc_block_dims = (_strip(dims["encoder"]["blocks"])
                               if "encoder" in dims else None)

    # ------------------------------------------------------------ axes
    def layout_of(self, shape, logical_axes):
        return shd.layout_of(shape, logical_axes, self.rules, self.sizes)

    def size(self, axes: Sequence[str]) -> int:
        return shd.axes_size(axes, self.sizes)

    def index(self, axes: Sequence[str]) -> int:
        return shd.axes_index(axes, self.coord, self.sizes)

    def group(self, axes: Sequence[str]):
        """This rank's group over ``axes`` (``launch.mesh.axis_groups``,
        made at the first call on a grid of two pods: every rank reaches
        it at the same point of the same step)."""
        from repro_torch.launch.mesh import axis_groups
        return axis_groups(self.grid)[frozenset(axes)]

    def tp(self, axes: Sequence[str]) -> bool:
        """Whether a dimension split over ``axes`` runs tensor-parallel:
        the rows are replicated over every one of them."""
        return bool(axes) and self.size(axes) > 1 \
            and set(axes) <= set(self.rep_axes)

    @property
    def rows(self) -> int:
        """Ranks the batch's rows are split over."""
        return self.size(self.row_axes)

    @property
    def replicas(self) -> int:
        """Ranks that hold the same rows."""
        return self.size(self.rep_axes)

    def leaf_replicas(self, layout) -> Tuple[str, ...]:
        """The axes a leaf of ``layout`` is replicated over."""
        used = {a for axes in layout for a in axes}
        return tuple(a for a in self.sizes if a not in used)

    # ------------------------------------------------------------ data
    def shard(self, t, layout):
        """This rank's block of a global tensor ``t`` (a view)."""
        for i, axes in enumerate(layout):
            n = self.size(axes)
            if n > 1:
                t = t.chunk(n, i)[self.index(axes)]
        return t

    def local_rows(self, t):
        """This rank's rows (dim 0) of a global batch tensor."""
        return self.shard(t, (self.row_axes,))

    def gather(self, t, layout, keep: Sequence[str] = ()):
        """``t``, this rank's shard of a leaf of ``layout``, all-gathered
        over every split but those over ``keep`` (tensor-parallel)."""
        for i, axes in enumerate(layout):
            if not axes or set(axes) <= set(keep):
                continue
            assert not set(axes) & set(keep), (layout, keep)
            n = self.size(axes)
            if n > 1:
                t = _Gather.apply(t, i, self.group(axes), n,
                                  self.index(axes), self.grad_constraint)
        return t

    def gather_rows(self, t, axes, dim: int = 0):
        """All-gather of activations over ``axes`` along ``dim``; its
        backward reduce-scatters."""
        n = self.size(axes)
        if n == 1:
            return t
        return _Gather.apply(t, dim, self.group(axes), n, self.index(axes),
                             True)

    def all_reduce(self, t, axes):
        """Sum over ``axes`` (a tensor-parallel partial result)."""
        if self.size(axes) == 1:
            return t
        return _AllReduce.apply(t, self.group(axes))

    def all_reduce_max(self, t, axes):
        """Maximum over ``axes``, without a gradient."""
        t = t.detach().clone()
        if self.size(axes) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group(axes))
        return t

    def gather_nograd(self, t, axes, dim: int):
        """All-gather over ``axes`` along ``dim`` (inference)."""
        n = self.size(axes)
        return t if n == 1 else _gather_dim(t, dim, self.group(axes), n)

    # ------------------------------------------------------------ MoE
    def share(self, xt):
        """The MoE boundary: of this rank's (T, D) tokens, replicated over
        ``rep_axes``, its 1/replicas share, the tokens padded to a multiple
        of the replicas as the reference pads them.  Returns (tokens,
        valid mask)."""
        n, t = self.replicas, xt.shape[0]
        if n == 1:
            return xt, None
        c = -(-t // n)
        lo = self.index(self.rep_axes) * c
        mine = F.pad(xt, (0, 0, 0, n * c - t))[lo:lo + c]
        valid = torch.arange(lo, lo + c, device=xt.device) < t
        return mine, valid

    def unshare(self, y, t: int):
        """The inverse of ``share``: every replica's outputs, all-gathered
        back over ``rep_axes``, the padding cut off."""
        if self.replicas == 1:
            return y
        return self.gather_rows(y, self.rep_axes)[:t]

    # ------------------------------------------------------------ heads
    def heads(self, cfg, layout_q) -> Optional[Tuple[int, int, int, int]]:
        """Under tensor-parallel heads (``layout_q`` the query
        projection's layout), this rank's query heads ``[q0, q1)`` and the
        KV heads ``[k0, k1)`` they read (the reference groups query heads
        under their KV head contiguously); None when attention is whole
        on the rank."""
        axes = layout_q[1]
        if not self.tp(axes):
            return None
        nq, nkv = cfg.num_heads, cfg.num_kv_heads
        g = nq // nkv
        per = nq // self.size(axes)
        q0 = self.index(axes) * per
        return q0, q0 + per, q0 // g, (q0 + per - 1) // g + 1
