"""The shard mesh and its collectives, for one controlling process or for
each process of a ``torch.distributed`` group.

The counterpart of ``primekg_rgcn_tpu/parallel/mesh.py``. The JAX package
is single-controller: one process drives every local device through
``shard_map``, and its tests run the sharded layouts as 8 host devices in
one process. The port keeps that model. A ``Mesh`` is n shards, along one
axis or, from ``make_mesh_2d``, an (n_dp, n_tp) grid numbered row-major;
every shard's tensors live on the mesh's one device (``cuda:0`` on the
card, ``cpu`` in the tests). A sharded function is a loop over the shards,
and a collective is a plain function over the per-shard tensors: a list,
or one tensor whose leading axis indexes the shards. Which shards a
collective spans (one axis of a 2-D mesh, or all) is the list the caller
hands it.

Across processes (``--distributed``: ``train/multichip.
maybe_initialize_distributed``) the mesh's n shards are split over the P
processes of the default process group: process p holds the contiguous
flat shards [p n/P, (p + 1) n/P), all on its own device, the JAX order in
which process p holds the global devices from p n/P. ``n_shards`` stays
the global count and P must divide it. A collective given ``mesh=`` a mesh
that spans processes reduces or gathers the caller's shards locally, then
across that mesh's processes (``Mesh.group``: the default group); without
it, or on one process, it is the local loop alone. A 2-D mesh takes any
P that divides n: a process may hold whole tp rows, a part of one row, or
parts of two or more rows (its k shards straddle a row boundary). The zero steps' row slices of the table (:class:`Slices`,
:func:`table_slices`) say which slices a process holds and which of them
it counts, so that a gather or a sum over the slices takes each once.

Every reduction and gather across processes is one ``dist.all_reduce``,
the one kind that NCCL and gloo share on CUDA and CPU tensors alike: an
all-gather is the sum of the processes' blocks, each zero-padded to the
whole and placed at its rank, and a psum_scatter is a sum of which each
process keeps its own block. Both move P times the bytes of a native
collective, and the sum is exact (one process contributes each element).
A sum over some of the processes (a tp row, or a column of slices, of a
2-D mesh whose rows they split) is the same: one all-reduce over every
process of a buffer stacked by row or by slice, each process writing
what it holds and zeros elsewhere. No sub-group is created, so no two
processes can meet in their groups in different orders; the cost is the
whole buffer's bytes on every process. The exchange between pairs of
processes is one ``dist.all_to_all_single`` (:func:`all_to_all`), which
both backends run on both kinds of tensor: a
halo exchange moves O(boundary) bytes a pair, and an all-reduce form would
send every process P times that. Each collective has an autograd form, for
a differentiable path whose loss each process takes over its own shards:
the backward of a psum is a psum, of an all-gather a psum_scatter and of a
psum_scatter an all-gather, as the transposes in ``shard_map``; an
all-to-all is its own transpose. Placing the shards on several cards in
one process waits for a machine with several (``ROADMAP.md``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from primekg_rgcn_tpu_torch.device import resolve_device

Shards = Union[Sequence[torch.Tensor], torch.Tensor]


def process_group_size() -> Tuple[int, int]:
    """(world size, rank) of the live default process group, else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True)
class Mesh:
    """``n_shards`` shards, all on ``device``: ``n_dp`` rows of ``n_tp``
    shards, shard ``d * n_tp + t`` at (d, t); a 1-D mesh has ``n_dp`` 1.
    Over ``world`` processes, this one (``rank``) holds the flat shards
    ``local``; its collectives run over ``group`` (None: the default
    group)."""

    n_shards: int
    device: torch.device
    n_dp: int = 1
    world: int = 1
    rank: int = 0
    group: Any = field(default=None, compare=False, repr=False)

    @property
    def n_tp(self) -> int:
        return self.n_shards // self.n_dp

    @property
    def local(self) -> range:
        """The flat indices of the shards this process holds."""
        k = self.n_shards // self.world
        return range(self.rank * k, (self.rank + 1) * k)

    @property
    def rows_split(self) -> bool:
        """True when some tp row spans two or more processes."""
        k = self.n_shards // self.world
        return self.world > 1 and k % self.n_tp > 0


def _mesh_device(n: int, device) -> torch.device:
    dev = resolve_device(device)
    if n < 2:
        raise ValueError(
            f"a sharded layout needs at least 2 shards, got {n}; "
            f"pass --n_devices N (every shard of a mesh lives on {dev})")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _processes(n: int) -> Tuple[int, int]:
    world, rank = process_group_size()
    if n % world:
        raise ValueError(f"{n} shards do not split over {world} processes: "
                         f"the process count must divide --n_devices")
    return world, rank


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh of ``num_devices`` shards on ``device``; ``None`` takes the
    number of visible devices of that type (the CPU counts one). Fewer than
    2 shards raise: a sharded layout on one shard is the dense path with
    extra copies. In a process group the shards are split over its
    processes."""
    if num_devices is None:
        num_devices = (torch.cuda.device_count()
                       if resolve_device(device).type == "cuda" else 1)
    n = int(num_devices)
    return Mesh(n, _mesh_device(n, device), 1, *_processes(n))


def make_mesh_2d(n_dp: int, n_tp: int, device="cuda") -> Mesh:
    """An (n_dp, n_tp) mesh on ``device``, row-major as the JAX
    ``make_mesh_2d``: the n_tp shards of a row form one tp group (the
    table's axis), the n_dp rows the data-parallel replicas. Fewer than 2
    shards raise. In a process group of P processes (P dividing n_dp n_tp)
    each process holds k = n_dp n_tp / P consecutive shards: whole rows,
    a part of one row, or parts of several (``Mesh.rows_split``), as the
    JAX function reshapes any device list."""
    n_dp, n_tp = int(n_dp), int(n_tp)
    if n_dp < 1 or n_tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({n_dp}, {n_tp})")
    n = n_dp * n_tp
    return Mesh(n, _mesh_device(n, device), n_dp, *_processes(n))


@dataclass(frozen=True)
class Slices:
    """The ``n`` row slices of a table over a mesh's processes, as a zero
    step holds them: this process holds the slices ``held`` (ascending),
    stacked [len(held), ...], and counts those of them that no lower rank
    holds (``counted``), so that a gather or a sum over the slices takes
    each slice once. ``shared``: some slice is held by two or more
    processes (the replicas of a 2-D mesh's rows), whose copies ``reduce``
    sums. ``mesh`` None: one process.

    Every method that crosses processes is one all-reduce over every
    process of an [n, ...] buffer, each process writing its slices and
    zeros elsewhere, and every process calls it."""

    n: int
    held: Tuple[int, ...]
    counted: Tuple[bool, ...]
    shared: bool = False
    mesh: Optional[Mesh] = field(default=None, compare=False, repr=False)

    @property
    def whole(self) -> bool:
        """True when this process holds every slice."""
        return len(self.held) == self.n

    def _counted(self) -> List[int]:
        return [i for i, c in enumerate(self.counted) if c]

    def _buffer(self, x: torch.Tensor, pos: Sequence[int]) -> torch.Tensor:
        """[n, ...] zeros with ``x``'s slices at positions ``pos`` of
        ``held`` written in, summed over every process."""
        buf = x.new_zeros(self.n, *x.shape[1:])
        buf[_index([self.held[i] for i in pos], x)] = \
            x.detach()[_index(pos, x)]
        dist.all_reduce(buf, group=self.mesh.group)
        return buf

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """This process's slices of a whole [n, ...] tensor: a view where
        they are consecutive."""
        lo, hi = self.held[0], self.held[-1] + 1
        if hi - lo == len(self.held):
            return x[lo:hi]
        return x[_index(self.held, x)]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every slice, [n, ...], from the processes' [len(held), ...]
        (``x`` itself where this process holds every slice)."""
        if self.whole:
            return x
        return self._buffer(x, self._counted())

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Each held slice summed over the processes that hold it (the dp
        sum of a 2-D mesh's replicas); ``x`` where no slice is shared."""
        if not self.shared:
            return x
        return self.own(self._buffer(x, range(len(self.held))))

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the n slices of ``x`` [len(held), ...], each slice
        once: the local sum in slice order where this process holds every
        slice, else the counted slices' sum summed across the processes."""
        if self.whole:
            return psum(x)
        if not all(self.counted):
            x = x[_index(self._counted(), x)]
        local = psum(x) if len(x) else x.new_zeros(x.shape[1:])
        return psum([local], self.mesh)

    def sq_norm(self, x: torch.Tensor) -> torch.Tensor:
        """The squared L2 norm of the whole sliced tensor, each slice
        once, as a 0-d tensor."""
        if not all(self.counted):
            x = x[_index(self._counted(), x)]
        sq = torch.linalg.vector_norm(x).square()
        return psum([sq], self.mesh) if spans(self.mesh) else sq


def _index(pos: Sequence[int], x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(list(pos), dtype=torch.long, device=x.device)


def table_slices(mesh: Mesh, by_tp: bool = False) -> Slices:
    """The row slices that a zero step over ``mesh`` holds in this
    process: one a shard (``by_tp`` False: zero1's n slices, each
    shard's own), or one a tp index (``by_tp`` True: zero3's n_tp
    slices, which every dp row replicates; a process holds the tp indices
    of its shards, in every row it touches, and counts those of them whose
    row-0 shard it holds)."""
    local = mesh.local
    if not by_tp:
        return Slices(mesh.n_shards, tuple(local), (True,) * len(local),
                      mesh=mesh if mesh.world > 1 else None)
    n_tp, k = mesh.n_tp, len(local)
    held = tuple(sorted({s % n_tp for s in local}))
    return Slices(n_tp, held, tuple(t // k == mesh.rank for t in held),
                  shared=mesh.world > 1 and mesh.n_dp > 1,
                  mesh=mesh if mesh.world > 1 else None)


# -- across processes: all-reduces, and one all-to-all ------------------------


def spans(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` splits its shards over processes."""
    return mesh is not None and mesh.world > 1


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.group)
    return out


def _gather_blocks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's [k, ...] block, rank-major: [P k, ...]."""
    buf = x.new_zeros(mesh.world, *x.shape)
    buf[mesh.rank] = x
    dist.all_reduce(buf, group=mesh.group)
    return buf.view(mesh.world * x.shape[0], *x.shape[1:])


def _keep_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over processes of [P c, ...], this process's block [c, ...]."""
    c = x.shape[0] // mesh.world
    return _all_reduce(x, mesh)[mesh.rank * c:(mesh.rank + 1) * c]


def _exchange_blocks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``dist.all_to_all_single`` of [P - 1, ...] blocks, one for each
    other process in rank order; this process's own split is empty."""
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    blk = x[0].numel()
    splits = [0 if q == mesh.rank else blk for q in range(mesh.world)]
    dist.all_to_all_single(out.view(-1), x.view(-1), splits, splits,
                           group=mesh.group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_blocks(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _keep_block(g, ctx.mesh), None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _keep_block(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather_blocks(g, ctx.mesh), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _exchange_blocks(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _exchange_blocks(g, ctx.mesh), None


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The exchange between every pair of ``mesh``'s processes: ``x`` [P -
    1, ...] holds a block for each other process, in rank order, and the
    result [P - 1, ...] the block each of them sent this one, in the same
    order. This process's own block never leaves it: the caller keeps it.
    One ``dist.all_to_all_single``, which every process calls with blocks
    of one shape. Its transpose is the same exchange, so the gradient runs
    it too."""
    if x.shape[0] != mesh.world - 1 or mesh.world < 2:
        raise ValueError(f"all_to_all over {mesh.world} processes takes "
                         f"{mesh.world - 1} blocks, got {x.shape[0]}")
    return _AllToAll.apply(x, mesh)


def psum(xs: Shards, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum over the shards: the one total every shard reads. The shards are
    added in order, one after the other; with a ``mesh`` that spans
    processes, ``xs`` are this process's shards and their sum is then
    summed across the processes."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return _PSum.apply(total, mesh) if spans(mesh) else total


def all_gather(xs: Shards, tiled: bool = False,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every shard's tensor, stacked along a new leading axis [n, ...], or,
    ``tiled``, concatenated along axis 0 [n * k, ...]. With a ``mesh`` that
    spans processes, ``xs`` are this process's shards and the result holds
    every process's, in shard order."""
    if isinstance(xs, torch.Tensor):
        out = xs.reshape(-1, *xs.shape[2:]) if tiled else xs
    else:
        out = torch.cat(list(xs)) if tiled else torch.stack(list(xs))
    return _AllGather.apply(out, mesh) if spans(mesh) else out


def psum_scatter(xs: Shards, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Tiled ``psum_scatter`` along axis 0: each shard's [n * k, ...]
    contribution summed over the shards, shard i keeping rows [i * k, (i +
    1) * k). Returns them stacked [n, k, ...]; with a ``mesh`` that spans
    processes, ``xs`` are this process's shards' contributions and the
    result its shards' rows."""
    if spans(mesh):
        local = psum(xs)
        n = len(xs) * mesh.world
        if local.shape[0] % n:
            raise ValueError(f"{local.shape[0]} rows do not split over {n} "
                             f"shards")
        return _PSumScatter.apply(local, mesh).view(
            len(xs), local.shape[0] // n, *local.shape[1:])
    stacked = all_gather(xs)
    n = stacked.shape[0]
    if stacked.shape[1] % n:
        raise ValueError(f"{stacked.shape[1]} rows do not split over {n} "
                         f"shards")
    return psum(stacked.view(n, n, stacked.shape[1] // n,
                             *stacked.shape[2:]))


def all_reduce_(tensors: Sequence[torch.Tensor],
                mesh: Optional[Mesh]) -> None:
    """Sum each tensor across the processes of ``mesh``, in place (no-op on
    one process): one all-reduce a dtype, over the tensors flattened in
    order. Every process passes the same tensors in the same order."""
    if not spans(mesh):
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.group)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


def check_same_across(value: float, device, what: str) -> None:
    """Raise unless ``value`` has the same bits in every process of the
    group (one all-reduce); no-op on one process."""
    if process_group_size()[0] == 1:
        return
    bits = torch.tensor([value], dtype=torch.float64).view(torch.int64)
    both = torch.cat([bits, -bits]).to(device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if both[0].item() != -both[1].item():
        raise RuntimeError(f"{what} differs across the processes "
                           f"({value!r} here): the replicas have diverged")
