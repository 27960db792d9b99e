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
across that mesh's processes (``Mesh.group``: the default group, or a
sub-group); without it, or on one process, it is the local loop alone. The
caller says which axis crosses processes (``Mesh.tp_axis``,
``Mesh.dp_axis``): a 2-D mesh whose processes hold whole tp rows crosses
them on its dp axis only; one whose tp rows are split over processes has a
sub-group for each row and for each column of processes, which every
process creates, in one order.

Every reduction and gather across processes is one ``dist.all_reduce``,
the one kind that NCCL and gloo share on CUDA and CPU tensors alike: an
all-gather is the sum of the processes' blocks, each zero-padded to the
whole and placed at its rank, and a psum_scatter is a sum of which each
process keeps its own block. Both move P times the bytes of a native
collective, and the sum is exact (one process contributes each element).
The exchange between pairs of processes is one ``dist.all_to_all_single``
(:func:`all_to_all`), which both backends run on both kinds of tensor: a
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
    group). ``row`` and ``column`` are set where the tp rows are split
    over processes: the meshes of this process's tp row (whose ``local``
    are the row's tp indices this process holds) and of its column of
    processes, each over a sub-group."""

    n_shards: int
    device: torch.device
    n_dp: int = 1
    world: int = 1
    rank: int = 0
    group: Any = field(default=None, compare=False, repr=False)
    row: Optional["Mesh"] = field(default=None, compare=False, repr=False)
    column: Optional["Mesh"] = field(default=None, compare=False,
                                     repr=False)

    @property
    def n_tp(self) -> int:
        return self.n_shards // self.n_dp

    @property
    def local(self) -> range:
        """The flat indices of the shards this process holds."""
        k = self.n_shards // self.world
        return range(self.rank * k, (self.rank + 1) * k)

    @property
    def tp_axis(self) -> Optional["Mesh"]:
        """The mesh that a collective over this process's tp row takes:
        None when the row lies inside the process, else the 1-D mesh
        itself or the split row's."""
        if self.n_tp <= len(self.local):
            return None
        return self.row or self

    @property
    def dp_axis(self) -> Optional["Mesh"]:
        """The mesh that a sum over the dp rows takes across processes:
        None on one process or one row, the whole mesh where processes
        hold whole rows, else this process's column of processes."""
        if self.world == 1 or self.n_dp == 1:
            return None
        return self.column or self


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
    or a part of one row. Where rows are split, every process creates one
    sub-group for each row and one for each column of processes (those
    that hold the same tp indices), in one order, and the mesh carries its
    own (``row``, ``column``); a k that would put parts of two rows in one
    process raises."""
    n_dp, n_tp = int(n_dp), int(n_tp)
    if n_dp < 1 or n_tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({n_dp}, {n_tp})")
    n = n_dp * n_tp
    world, rank = _processes(n)
    dev = _mesh_device(n, device)
    k = n // world
    if k % n_tp == 0:
        return Mesh(n, dev, n_dp, world, rank)
    if n_tp % k:
        raise ValueError(
            f"an ({n_dp}, {n_tp}) mesh over {world} processes gives each "
            f"{k} shards, parts of two tp rows; a process's shards must be "
            f"whole rows or lie in one row (k a multiple or a divisor of "
            f"n_tp)")
    m = n_tp // k                        # processes a row
    rows = [dist.new_group(list(range(d * m, (d + 1) * m)))
            for d in range(n_dp)]
    columns = [dist.new_group(list(range(c, world, m))) for c in range(m)]
    row = Mesh(n_tp, dev, 1, m, rank % m, rows[rank // m])
    column = Mesh(n_dp * k, dev, n_dp, n_dp, rank // m, columns[rank % m])
    return Mesh(n, dev, n_dp, world, rank, row=row, column=column)


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


def shard_groups(mesh: Mesh) -> List[range]:
    """The flat shard indices of each tp group (one row of the mesh) that
    this process holds: every row on one process; across processes its
    own rows, or its part of a row split over processes (a 1-D mesh's one
    row among them)."""
    local = mesh.local
    groups = [range(max(d * mesh.n_tp, local.start),
                    min((d + 1) * mesh.n_tp, local.stop))
              for d in range(mesh.n_dp)]
    return [g for g in groups if len(g)]
