"""The shard mesh and its collectives, for one controlling process.

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
hands it. Placing the shards on several cards waits for a machine with
several (``ROADMAP.md``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch

from primekg_rgcn_tpu_torch.device import resolve_device

Shards = Union[Sequence[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class Mesh:
    """``n_shards`` shards, all on ``device``: ``n_dp`` rows of ``n_tp``
    shards, shard ``d * n_tp + t`` at (d, t); a 1-D mesh has ``n_dp`` 1."""

    n_shards: int
    device: torch.device
    n_dp: int = 1

    @property
    def n_tp(self) -> int:
        return self.n_shards // self.n_dp


def _mesh_device(n: int, device) -> torch.device:
    dev = resolve_device(device)
    if n < 2:
        raise ValueError(
            f"a sharded layout needs at least 2 shards, got {n}; "
            f"pass --n_devices N (every shard of a mesh lives on {dev})")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh of ``num_devices`` shards on ``device``; ``None`` takes the
    number of visible devices of that type (the CPU counts one). Fewer than
    2 shards raise: a sharded layout on one shard is the dense path with
    extra copies."""
    if num_devices is None:
        num_devices = (torch.cuda.device_count()
                       if resolve_device(device).type == "cuda" else 1)
    return Mesh(int(num_devices), _mesh_device(int(num_devices), device))


def make_mesh_2d(n_dp: int, n_tp: int, device="cuda") -> Mesh:
    """An (n_dp, n_tp) mesh on ``device``, row-major as the JAX
    ``make_mesh_2d``: the n_tp shards of a row form one tp group (the
    table's axis), the n_dp rows the data-parallel replicas. Fewer than 2
    shards raise."""
    n_dp, n_tp = int(n_dp), int(n_tp)
    if n_dp < 1 or n_tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({n_dp}, {n_tp})")
    return Mesh(n_dp * n_tp, _mesh_device(n_dp * n_tp, device), n_dp)


def psum(xs: Shards) -> torch.Tensor:
    """Sum over the shards: the one total every shard reads. The shards are
    added in order, one after the other."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def all_gather(xs: Shards, tiled: bool = False) -> torch.Tensor:
    """Every shard's tensor, stacked along a new leading axis [n, ...], or,
    ``tiled``, concatenated along axis 0 [n * k, ...]."""
    if isinstance(xs, torch.Tensor):
        return xs.reshape(-1, *xs.shape[2:]) if tiled else xs
    return torch.cat(list(xs)) if tiled else torch.stack(list(xs))


def psum_scatter(xs: Shards) -> torch.Tensor:
    """Tiled ``psum_scatter`` along axis 0: each shard's [n * k, ...]
    contribution summed over the shards, shard i keeping rows [i * k, (i +
    1) * k). Returns them stacked [n, k, ...]."""
    stacked = all_gather(xs)
    n = stacked.shape[0]
    if stacked.shape[1] % n:
        raise ValueError(f"{stacked.shape[1]} rows do not split over {n} "
                         f"shards")
    return psum(stacked.view(n, n, stacked.shape[1] // n,
                             *stacked.shape[2:]))


def shard_groups(mesh: Mesh) -> List[range]:
    """The flat shard indices of each tp group (one row of the mesh)."""
    return [range(d * mesh.n_tp, (d + 1) * mesh.n_tp)
            for d in range(mesh.n_dp)]
