"""Sharding rules: map every parameter / cache tensor to a spec on the
production mesh (the port of ``repro.models.sharding``).

Axes semantics:
  dp   — batch data-parallel axes (("pod","data") multi-pod, ("data",) else)
  tp   — tensor-parallel axis ("model"): heads, d_ff, vocab, experts
  fsdp — ZeRO param/optimizer sharding axes (== dp for train, () for serve)
  seq  — axis used to shard long decode KV caches / activation seq dim

A spec is a tuple with one entry per tensor dim: None (replicated), an
axis name, or a tuple of axis names, as the reference's ``PartitionSpec``
holds them. ``_RULES``, ``param_specs``, ``cache_specs`` and the context
factories return the reference's specs exactly. The port keeps one module
per layer where the reference stacks layers over periods, so a layer
leaf's spec is the reference's without its leading period ``None``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(``launch/mesh.py``). ``named(*spec)`` gives a spec's DTensor placements
on it (``Shard(d)`` or ``Replicate()`` per mesh dim);
``param_shardings`` / ``cache_shardings`` give them per leaf. There is no
GSPMD to hand a constraint to: ``cs`` keeps this rank's block of a global
tensor (``torch.tensor_split`` order over the spec's axes, uneven blocks
allowed, as GSPMD pads), ``gather`` puts the blocks back together, and
``rows`` / ``sizes`` say where the blocks lie.

Training over a mesh holds every parameter as this rank's block of its
``param_specs`` entry (``shard_params``; a :class:`Layout` per leaf says
which dim lies over the fsdp axes, "F", and which over the tp axis, "T").
A sub-layer gathers its blocks as it computes (``use``): over F always,
over T where it computes with the whole leaf. Each gather's gradient is
reduced back into the block (``core.collectives.Gather``). ``tp_f`` /
``tp_g`` / ``dp_g`` are the activations' autograd pairs (see
``core.collectives``). Collectives over axes that hold one rank are
skipped: a one-rank mesh exchanges nothing.

Sequence parallelism (``seq_parallel``, ``make_train_ctx``'s default; live
where the tp axis holds more than one rank, ``seq_split``): a training
forward carries the hidden state (B, S, D) as this rank's block over dp
of the batch and over tp of the sequence (``cs_hidden``, the reference's
``(dp, tp, None)``; ``rows`` order, uneven blocks allowed) between
sub-layers, through the residual adds and the norms. A sub-layer gathers
the normed block over tp (``sp_gather``) and leaves its output as the
rank's block: a row-parallel product's partial sums reduce-scattered
(``sp_scatter``), in place of "f" and "g"; a sub-layer that runs whole on
every tp rank keeps its rows (``cs_hidden``). The gradient rule:

* each gradient is one rank's whole gradient of what the rank computes
  with. A gather's backward reduce-scatters where each rank's computation
  gives part of the gradient (column-parallel products, the vocab-split
  logits) and cuts the block where every rank computes it whole (a
  sub-layer whole on every tp rank, the routing, the logits whose vocab
  does not split); summing there would count it tp times;
* the cut of a whole result into the rank's rows all-gathers its gradient
  (``core.collectives.Split``), so what every tp rank computed whole
  before it gets the whole gradient: such a sub-layer's leaves need no
  sum over tp;
* a leaf every tp rank holds whole but applies to its own rows only (the
  decoder's norm scales and biases, ``final_norm``, the learned position
  table: ``seq_rows_leaf``) has a part of its gradient on each tp rank:
  ``reduce_replicated_grads`` sums them over tp in one flat all-reduce.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import collectives
from repro_torch.core.collectives import (CopyToTP, Gather, ReduceFromTP,
                                          ReduceScatter, Split)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Optional[Any] = None       # a DeviceMesh
    dp: Tuple[str, ...] = ()
    tp: Optional[str] = None
    fsdp: Tuple[str, ...] = ()
    seq: Optional[str] = None        # shard seq dim of caches/activations
    shard_cache_seq: bool = False    # long-context decode: KV seq over `seq`
    seq_parallel: bool = False       # train: carry activations seq-sharded

    def _shape(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def dp_spec(self):
        return self.dp if self.dp else None

    @property
    def dp_size(self) -> int:
        if self.mesh is None or not self.dp:
            return 1
        return self.axes_size(self.dp)

    @property
    def tp_size(self) -> int:
        if self.mesh is None or not self.tp:
            return 1
        return self._shape()[self.tp]

    def named(self, *spec) -> Optional[list]:
        """The DTensor placements of ``spec`` on the mesh, one per mesh
        dim; None without a mesh."""
        if self.mesh is None:
            return None
        from torch.distributed.tensor import Replicate, Shard
        where = {}
        for d, axes in enumerate(spec):
            for a in _axes(axes):
                where[a] = d
        return [Shard(where[a]) if a in where else Replicate()
                for a in self.mesh.mesh_dim_names]

    def axes_size(self, axes) -> int:
        if self.mesh is None or axes is None:
            return 1
        shape = self._shape()
        n = 1
        for a in _axes(axes):
            n *= shape[a]
        return n

    def if_div(self, dim: int, axes):
        """``axes`` if ``dim`` divides evenly across them, else None (the
        reference's pjit arguments require exact divisibility)."""
        if axes is None:
            return None
        n = self.axes_size(axes)
        return axes if (n > 0 and dim % n == 0) else None

    # -- where this rank's blocks lie ----------------------------------
    def coord(self, axes) -> int:
        """This rank's coordinate along ``axes`` (row-major over them)."""
        if self.mesh is None or axes is None:
            return 0
        names = list(self.mesh.mesh_dim_names)
        shape, pos = self.mesh.shape, self.mesh.get_coordinate()
        c = 0
        for a in _axes(axes):
            c = c * shape[names.index(a)] + pos[names.index(a)]
        return c

    def sizes(self, n: int, axes) -> list:
        """Block lengths of ``n`` rows split over ``axes``, in rank order
        (``torch.tensor_split``'s: the first ``n % k`` blocks one longer)."""
        k = self.axes_size(axes)
        return [n // k + (r < n % k) for r in range(k)]

    def rows(self, n: int, axes) -> Tuple[int, int]:
        """[lo, hi) of this rank's block of ``n`` rows over ``axes``."""
        sizes = self.sizes(n, axes)
        c = self.coord(axes)
        lo = sum(sizes[:c])
        return lo, lo + sizes[c]

    def group(self, axes):
        """The process group of this rank's peers along ``axes``."""
        axes = _axes(axes)
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        return _flat_group(self.mesh, axes)

    def gather(self, x: torch.Tensor, n, axes, dim: int = 0):
        """The whole ``n`` rows along ``dim`` from every rank's block over
        ``axes`` (this rank holds block ``rows(n, axes)``), or, with ``n``
        a list, from blocks of those lengths in rank order; ``x`` itself
        over no axes."""
        if self.mesh is None or not _axes(axes):
            return x
        sizes = n if isinstance(n, (list, tuple)) else self.sizes(n, axes)
        return collectives.all_gather(x, sizes, self.group(axes),
                                      "+".join(_axes(axes)), dim)

    def cs(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """This rank's block of the global tensor ``x`` along every dim
        that ``spec`` shards; ``x`` itself without a mesh."""
        if self.mesh is None:
            return x
        for d, axes in enumerate(spec):
            if axes is not None:
                lo, hi = self.rows(x.shape[d], axes)
                x = x.narrow(d, lo, hi - lo)
        return x

    # -- collectives over mesh axes (skipped where they hold one rank) ---
    def live(self, axes) -> tuple:
        """The axes of ``axes`` that spread over more than one rank."""
        if self.mesh is None:
            return ()
        shape = self._shape()
        return tuple(a for a in _axes(axes) if shape[a] > 1)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"):
        """``x`` summed (or max, min) over the ranks along ``axes``; no
        gradient flows through it."""
        axes = self.live(axes)
        if not axes:
            return x
        return collectives.all_reduce(x, self.group(axes), "+".join(axes),
                                      op)

    def _pair(self, fn, x, axes):
        axes = self.live(axes)
        if not axes:
            return x
        return fn.apply(x, self.group(axes), "+".join(axes))

    def tp_f(self, x: torch.Tensor) -> torch.Tensor:
        """The identity; its gradient is summed over tp ("f")."""
        return self._pair(CopyToTP, x, self.tp)

    def tp_g(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over tp; its gradient passes through ("g")."""
        return self._pair(ReduceFromTP, x, self.tp)

    def dp_g(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over dp; its gradient passes through (a global
        sum every data rank takes the gradient of for its own part)."""
        return self._pair(ReduceFromTP, x, self.dp)

    # -- sequence parallelism over tp (training) ------------------------
    @property
    def seq_split(self) -> bool:
        """Whether a training forward carries the hidden state as this
        rank's sequence block: ``seq_parallel`` with a tp axis of more than
        one rank."""
        return self.seq_parallel and bool(self.live(self.tp))

    def _seq_args(self, n, sizes):
        return (list(sizes) if sizes is not None else self.sizes(n, self.tp),
                self.group(self.tp), self.tp, 1)

    def cs_hidden(self, h: torch.Tensor, sizes=None) -> torch.Tensor:
        """The hidden state (B, S, D) as layer boundaries hold it: under
        ``seq_split`` this rank's block of the sequence over tp (of
        ``sizes`` in rank order where given), cut from the ``h`` every tp
        rank holds whole and alike, its gradient all-gathered
        (``core.collectives.Split``); else ``h``. ``h`` holds this rank's
        rows of the batch already (``data.pipeline.place``)."""
        if not self.seq_split:
            return h
        return Split.apply(h, *self._seq_args(h.shape[1], sizes))

    def sp_gather(self, x: torch.Tensor, n: int, grad: str = "scatter"
                  ) -> torch.Tensor:
        """The whole sequence (dim 1, ``n`` rows) from every tp rank's
        block ``x``; the gradient reduce-scattered into the block
        (``grad="scatter"``: each rank computes part of it) or cut to it
        (``"none"``: every rank computes it whole)."""
        return Gather.apply(x, *self._seq_args(n, None), grad)

    def sp_scatter(self, x: torch.Tensor, sizes=None) -> torch.Tensor:
        """This rank's sequence block (of ``sizes`` where given) of ``x``
        (B, S, ...) summed over tp (a row-parallel product's partial sums);
        the gradient all-gathered."""
        return ReduceScatter.apply(x, *self._seq_args(x.shape[1], sizes))


def _spec(entries) -> tuple:
    """A spec as the reference's ``PartitionSpec`` holds it: a one-axis
    tuple entry reads as the axis name, an empty one as None."""
    return tuple((e[0] if len(e) == 1 else e or None)
                 if isinstance(e, tuple) else e for e in entries)


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


_FLAT_GROUPS: dict = {}


def _flat_group(mesh, axes: tuple):
    """One group per slice of the mesh along several axes, made once per
    (mesh, axes) by every rank together (``new_subgroups_by_enumeration``
    is collective), in the axes' row-major order. The cache holds the
    mesh, so its id names no other mesh while the group is kept."""
    key = (id(mesh), axes)
    if key not in _FLAT_GROUPS:
        import torch.distributed as dist
        names = list(mesh.mesh_dim_names)
        idx = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in idx]
        n = 1
        for d in idx:
            n *= mesh.shape[d]
        ranks = mesh.mesh.permute(rest + idx).reshape(-1, n)
        _FLAT_GROUPS[key] = (mesh, dist.new_subgroups_by_enumeration(
            ranks.tolist())[0])
    return _FLAT_GROUPS[key][1]


def make_flat_groups(mesh) -> None:
    """Make the group of every set of two or more of ``mesh``'s axes (in
    the mesh's order) now, every rank together, rather than at a
    collective's first call. The dry run calls it before its
    ``FakeTensorMode``, under which the mesh's rank grid reads as a fake
    tensor."""
    import itertools
    names = tuple(mesh.mesh_dim_names)
    for n in range(2, len(names) + 1):
        for axes in itertools.combinations(names, n):
            _flat_group(mesh, axes)


REPLICATED = ()

# Leaf-name -> spec template. `F`=fsdp axes, `T`=tp axis, None=replicated dim.
_RULES: list[tuple[re.Pattern, tuple]] = [
    (re.compile(r"tokens$"),     ("T", "F")),       # embed (V, D)
    (re.compile(r"unembed$"),    ("F", "T")),       # (D, V)
    (re.compile(r"^(x?)[qkv]$"), ("F", "T")),       # (D, H*hd)
    (re.compile(r"^(x?)o$"),     ("T", "F")),       # (H*hd, D)
    (re.compile(r"^w[ig]$"),     ("F", "T")),       # dense ffn (D, F) / moe (E,D,F) handled below
    (re.compile(r"^wo$"),        ("T", "F")),
    (re.compile(r"^sw[ig]$"),    ("F", "T")),
    (re.compile(r"^swo$"),       ("T", "F")),
    (re.compile(r"^sgate$"),     ("F", None)),
    (re.compile(r"^router$"),    ("F", None)),
    (re.compile(r"^in_proj$"),   ("F", "T")),
    (re.compile(r"^out_proj$"),  ("T", "F")),
    (re.compile(r"^conv$"),      (None, "T")),
    (re.compile(r"^(conv_bias|A_log|D|dt_bias|norm_scale)$"), ("T",)),
    (re.compile(r"^(scale|bias)$"), (None,)),       # norms
    (re.compile(r"table$"),      (None, None)),     # learned pos
]

# the port's per-layer module lists (the reference's stacks)
_LAYER_LISTS = ("layers", "enc_layers")


def _leaf_spec(path_names: list[str], shape: tuple, ctx: ShardingCtx) -> tuple:
    """The spec of one leaf. A layer leaf (under ``layers.{i}`` or
    ``enc_layers.{i}``) has no period dim: its spec is the reference's
    stacked leaf's without the leading None."""
    name = path_names[-1]
    ndim = len(shape)
    is_moe = any(n == "moe" for n in path_names)
    body = shape

    def ax(sym):
        if sym == "F":
            return ctx.fsdp if ctx.fsdp else None
        if sym == "T":
            return ctx.tp
        return None

    spec: Optional[tuple] = None
    for pat, tmpl in _RULES:
        if pat.search(name):
            spec = tuple(ax(s) for s in tmpl)
            break
    if spec is None:
        spec = (None,) * ndim

    if is_moe and name in ("wi", "wg", "wo"):
        # (E, D, F) / (E, F, D). Expert-parallel over tp when E divides the
        # model axis (jamba 16e, granite-moe 32e); otherwise (qwen 60e)
        # fall back to tensor parallelism on the expert d_ff dim.
        e = body[0]
        ep = ctx.if_div(e, ctx.tp)
        if ep is not None:
            spec = ((ep, None, ax("F")) if name in ("wi", "wg")
                    else (ep, ax("F"), None))
        else:
            spec = ((None, ax("F"), ctx.tp) if name in ("wi", "wg")
                    else (None, ctx.tp, ax("F")))

    # exact divisibility, as the reference's pjit arguments need it
    spec = tuple(ctx.if_div(d, a) if a is not None else None
                 for d, a in zip(body, spec))
    return _spec(tuple(spec[:ndim]) + (None,) * max(0, ndim - len(spec)))


def _named_shapes(params) -> dict:
    """{dotted name: shape} of a module's parameters or a mapping of
    tensors / shapes."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def param_specs(params: Any, ctx: ShardingCtx) -> dict:
    """{name: spec} for a ``Model`` (any device, ``meta`` included) or a
    mapping of its parameter names to tensors or shapes."""
    return {name: _leaf_spec(name.split("."), shape, ctx)
            for name, shape in _named_shapes(params).items()}


def param_shardings(params: Any, ctx: ShardingCtx) -> Optional[dict]:
    """{name: DTensor placements} of ``param_specs``; None without a
    mesh."""
    if ctx.mesh is None:
        return None
    return {k: ctx.named(*s) for k, s in param_specs(params, ctx).items()}


# ---------------------------------------------------------------------------
# Parameter blocks (training over a mesh)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one parameter's blocks lie: its global ``shape``, its
    ``param_specs`` entry ``spec``, the dim ``fdim`` over the fsdp axes
    ("F") and the dim ``tdim`` over the tp axis ("T"), None where the leaf
    is whole along them or they hold one rank."""
    shape: tuple
    spec: tuple
    fdim: Optional[int]
    tdim: Optional[int]

    @property
    def axes(self) -> tuple:
        """The mesh axes the spec splits the leaf over."""
        return tuple(a for e in self.spec for a in _axes(e))

    def block_shape(self, ctx: ShardingCtx) -> tuple:
        return tuple(n if e is None else ctx.sizes(n, e)[ctx.coord(e)]
                     for n, e in zip(self.shape, self.spec))

    def block(self, x: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
        """This rank's block of the whole leaf ``x``."""
        return ctx.cs(x, *self.spec)

    def counted(self, ctx: ShardingCtx) -> bool:
        """Whether this rank counts the block once among the ranks that
        hold it whole: its coordinate is 0 along every axis the spec
        leaves replicated."""
        if ctx is None or ctx.mesh is None:
            return True
        rest = [a for a in ctx.mesh.mesh_dim_names if a not in self.axes]
        return all(ctx.coord(a) == 0 for a in rest)

    def gather(self, x: torch.Tensor, ctx: ShardingCtx, dim: int,
               grad: str) -> torch.Tensor:
        e = self.spec[dim]
        axes = _axes(e)
        return Gather.apply(x, ctx.sizes(self.shape[dim], e),
                            ctx.group(axes), "+".join(axes), dim, grad)


def layout(shape, spec, ctx: ShardingCtx) -> Layout:
    """The :class:`Layout` of a leaf of ``shape`` under ``spec``."""
    fdim = tdim = None
    for d, e in enumerate(spec):
        if e is None or not ctx.live(e):
            continue
        if e == ctx.tp:
            tdim = d
        else:
            fdim = d
    return Layout(tuple(shape), tuple(spec), fdim, tdim)


def shard_params(model: torch.nn.Module, ctx: ShardingCtx,
                 device=None) -> Dict[str, Layout]:
    """Replace every parameter of ``model`` by this rank's block under
    ``param_specs(model, ctx)``, on ``device`` (default: the parameter's):
    a parameter on ``meta`` becomes an empty block (filled with its
    ``_fill`` where it has one, as ``Model`` makes norms), any other is
    cut. Each new parameter carries its :class:`Layout` as ``_layout``;
    returns them by name."""
    specs = param_specs(model, ctx)
    layouts = {}
    for name, p in list(model.named_parameters()):
        lay = layout(p.shape, specs[name], ctx)
        dev = torch.device(device) if device is not None else p.device
        if p.is_meta:
            block = torch.empty(lay.block_shape(ctx), dtype=p.dtype,
                                device=dev)
            if getattr(p, "_fill", None) is not None:
                block.fill_(p._fill)
        else:
            block = lay.block(p.detach(), ctx).to(dev).clone()
        new = torch.nn.Parameter(block, requires_grad=p.requires_grad)
        new._layout = lay
        *path, leaf = name.split(".")
        model.get_submodule(".".join(path))._parameters[leaf] = new
        layouts[name] = lay
    return layouts


def take_blocks(tensors: Dict[str, torch.Tensor], layouts: Dict[str, Layout],
                ctx: ShardingCtx) -> Dict[str, torch.Tensor]:
    """This rank's block of every whole tensor of ``tensors`` (by name);
    the tensors themselves without layouts."""
    if not layouts:
        return dict(tensors)
    return {n: layouts[n].block(t, ctx) for n, t in tensors.items()}


def gather_params(tensors: Dict[str, torch.Tensor],
                  layouts: Dict[str, Layout], ctx: ShardingCtx,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """The whole tensors from every rank's blocks (``tensors`` by name,
    each a block under ``layouts``), one leaf at a time, on ``device``
    (each block is moved there first, so a gather to the CPU stages
    nothing). Every rank of the mesh must call it."""
    out = {}
    for name, t in tensors.items():
        t = t.detach().to(device)
        lay = layouts.get(name)
        if lay is not None:
            for d, e in enumerate(lay.spec):
                if e is not None and ctx.live(e):
                    t = ctx.gather(t, ctx.sizes(lay.shape[d], e), e, d)
        out[name] = t
    return out


def use(p: torch.Tensor, ctx: ShardingCtx, tp: str = "whole"
        ) -> torch.Tensor:
    """The tensor a sub-layer computes with, from the block ``p`` (a
    parameter carrying its ``_layout``; ``p`` itself without one): gathered
    over its F dim, its gradient reduce-scattered over the data ranks back
    into the block; and along T by ``tp``:

    * "local": the T block as it is (column- and row-parallel products);
    * "whole": gathered, for a computation every tp rank runs alike, so
      each has the whole gradient and keeps its block of it;
    * "partial": whole, for a computation each tp rank runs on its part
      (k / v read by the local query heads), so the gradient is summed
      over tp.
    """
    lay = getattr(p, "_layout", None)
    if lay is None:
        return p
    x = p
    if tp != "local" and lay.tdim is not None:
        x = lay.gather(x, ctx, lay.tdim,
                       "scatter" if tp == "partial" else "none")
    elif tp == "partial":
        x = ctx.tp_f(x)
    if lay.fdim is not None:
        x = lay.gather(x, ctx, lay.fdim, "scatter")
    return x


# the leaves every tp rank applies to its own sequence block only under
# sequence parallelism: the decoder's norms and the learned positions
_SEQ_ROWS = re.compile(r"^(layers\.\d+\..*\.|final_norm\.)(scale|bias)$"
                       r"|^pos\.table$")


def seq_rows_leaf(name: str) -> bool:
    """Whether leaf ``name`` acts on the hidden state's sequence block
    (a decoder norm, ``final_norm``, the learned position table), so that
    under ``seq_split`` each tp rank holds part of its gradient."""
    return bool(_SEQ_ROWS.match(name))


def _sum_buckets(grads: dict, buckets: dict, ctx: ShardingCtx) -> dict:
    """``grads`` with each bucket's leaves ({(axes, dtype): names}) summed
    over its axes, one flat all-reduce a bucket."""
    out = dict(grads)
    for (axes, _), names in buckets.items():
        flat = ctx.all_reduce(torch.cat([grads[n].reshape(-1)
                                         for n in names]), axes)
        for n, part in zip(names, flat.split(
                [grads[n].numel() for n in names])):
            out[n] = part.view_as(grads[n])
    return out


def reduce_replicated_grads(grads: Dict[str, torch.Tensor],
                            layouts: Dict[str, Layout], ctx: ShardingCtx
                            ) -> Dict[str, torch.Tensor]:
    """Sum each gradient over the dp axes its leaf's block is not split
    over (the data ranks' parts of a leaf they all hold whole, such as a
    norm scale), one flat all-reduce per set of axes and dtype; then under
    ``seq_split`` the gradients of ``seq_rows_leaf`` leaves over tp (the
    tp ranks' parts from their sequence blocks), one flat all-reduce per
    dtype."""
    dp = ctx.live(ctx.dp)
    buckets: dict = {}
    for name, g in grads.items():
        lay = layouts.get(name)
        rest = tuple(a for a in dp if lay is None or a not in lay.axes)
        if rest:
            buckets.setdefault((rest, g.dtype), []).append(name)
    out = _sum_buckets(grads, buckets, ctx)
    if ctx.seq_split:
        buckets = {}
        for name, g in out.items():
            if seq_rows_leaf(name):
                buckets.setdefault((ctx.tp, g.dtype), []).append(name)
        out = _sum_buckets(out, buckets, ctx)
    return out


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

def cache_seq_axes(t: int, ctx: ShardingCtx):
    """The axes a self-attention cache's sequence dim of length ``t`` lies
    over (None where it is replicated): tp, or for long-context serving
    (``shard_cache_seq``) data AND model (flash-decode both ways), falling
    back to data only where that does not divide."""
    if ctx.shard_cache_seq and ctx.seq and ctx.tp:
        return ctx.if_div(t, (ctx.seq, ctx.tp)) or ctx.if_div(t, ctx.seq)
    return ctx.if_div(t, ctx.tp)


def _cache_leaf_spec(name: str, shp: tuple, ctx: ShardingCtx) -> tuple:
    nd = len(shp)
    if name in ("k", "v"):
        spec = (ctx.if_div(shp[0], ctx.dp_spec), cache_seq_axes(shp[1], ctx),
                None, None)
    elif name in ("xk", "xv"):
        spec = (ctx.if_div(shp[0], ctx.dp_spec), None, None, None)
    elif name == "state":                        # (B, H, P, N)
        spec = (ctx.if_div(shp[0], ctx.dp_spec), ctx.if_div(shp[1], ctx.tp),
                None, None)
    elif name == "conv":                         # (B, W-1, C)
        spec = (ctx.if_div(shp[0], ctx.dp_spec), None,
                ctx.if_div(shp[2], ctx.tp))
    else:                                        # cache_pos
        spec = (None,) * nd
    return _spec(tuple(spec[:nd]) + (None,) * max(0, nd - len(spec)))


def _map_cache(cache, fn, name=""):
    """``fn(leaf name, leaf)`` over every leaf of a cache tree."""
    if isinstance(cache, dict):
        return {k: _map_cache(v, fn, k) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_map_cache(v, fn, name) for v in cache]
    return fn(name, cache)


def cache_specs(cache: Any, ctx: ShardingCtx):
    """KV/SSM cache specs, in the structure of the port's cache
    (``{"sub{s}": [one layer's dict per period]}``).

    Self-attention caches (B, T, KV, hd): batch over dp, the cache's
    sequence dim over tp (flash-decode-style partial softmax combined over
    the model axis). For long-context serving (batch below the data size)
    the sequence dim also shards over the data axis. Cross-attention
    caches (whisper, 1500 frames) shard batch only. Every rule is guarded
    by exact divisibility; non-divisible dims replicate.
    """
    return _map_cache(cache, lambda n, x: _cache_leaf_spec(
        n, tuple(x.shape), ctx))


def cache_blocks(cache: Any, ctx: ShardingCtx):
    """This rank's block of every leaf of a whole cache (the global batch)
    under ``cache_specs``; the cache itself without a mesh."""
    return _map_cache(cache, lambda n, x: ctx.cs(
        x, *_cache_leaf_spec(n, tuple(x.shape), ctx)))


def _inner_axes(name: str, shape: tuple, ctx: ShardingCtx) -> list:
    """(dim, live axes) of every dim but the batch that ``cache_specs``
    splits a cache leaf of the whole ``shape`` over."""
    live = [ctx.live(a) for a in _cache_leaf_spec(name, tuple(shape), ctx)]
    return [(d, axes) for d, axes in enumerate(live) if d and axes]


def cut_cache_leaf(name: str, x: torch.Tensor, ctx: ShardingCtx
                   ) -> torch.Tensor:
    """This rank's block of the cache leaf ``name`` along every dim but the
    batch (``x`` holds this rank's rows already, and is whole along the
    others), as a tensor of its own: a view would keep the whole leaf's
    memory."""
    inner = _inner_axes(name, x.shape, ctx)
    for d, axes in inner:
        lo, hi = ctx.rows(x.shape[d], axes)
        x = x.narrow(d, lo, hi - lo)
    return x.clone() if inner else x


def gather_cache_leaf(name: str, x: torch.Tensor, shape: tuple,
                      ctx: ShardingCtx) -> torch.Tensor:
    """``cut_cache_leaf``'s inverse: the leaf whole along every dim but the
    batch, whose whole extents ``shape`` gives, from every rank's block."""
    for d, axes in _inner_axes(name, shape, ctx):
        x = ctx.gather(x, shape[d], axes, d)
    return x


def cache_shardings(cache: Any, ctx: ShardingCtx):
    """``cache_specs`` as DTensor placements; None without a mesh."""
    if ctx.mesh is None:
        return None
    return _map_cache(cache, lambda n, x: ctx.named(
        *_cache_leaf_spec(n, tuple(x.shape), ctx)))


# ---------------------------------------------------------------------------
# Context factories
# ---------------------------------------------------------------------------

def make_train_ctx(mesh, *, seq_parallel: bool = True) -> ShardingCtx:
    if mesh is None:
        return ShardingCtx()
    axes = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None
    return ShardingCtx(mesh=mesh, dp=dp, tp=tp, fsdp=dp, seq="data",
                       seq_parallel=seq_parallel)


def make_serve_ctx(mesh, *, global_batch: int,
                   big_model: bool = False) -> ShardingCtx:
    """Serving: no optimizer, params TP (+2D over data for big models);
    batch over dp when divisible, else KV-seq over data."""
    if mesh is None:
        return ShardingCtx()
    axes = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None
    shape = dict(zip(axes, mesh.shape))
    dp_size = 1
    for a in dp:
        dp_size *= shape[a]
    shard_seq = global_batch < dp_size
    fsdp = dp if big_model else ()
    return ShardingCtx(mesh=mesh, dp=() if shard_seq else dp, tp=tp,
                       fsdp=fsdp, seq="data", shard_cache_seq=shard_seq)


def sharded(ctx: Optional[ShardingCtx]) -> bool:
    """Whether ``ctx`` carries a mesh (the callers' test for running on
    their blocks)."""
    return ctx is not None and ctx.mesh is not None
