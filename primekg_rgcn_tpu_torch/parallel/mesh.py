"""The shard mesh and its collectives, for one controlling process.

The counterpart of ``primekg_rgcn_tpu/parallel/mesh.py``. The JAX package
is single-controller: one process drives every local device through
``shard_map``, and its tests run the sharded layouts as 8 host devices in
one process. The port keeps that model. A ``Mesh`` is n shards along one
axis, and every shard's tensors live on the mesh's one device (``cuda:0``
on the card, ``cpu`` in the tests); a sharded function is a loop over the
shards, and a collective is a plain function over the per-shard list.
Placing the shards on several cards waits for a machine with several
(``ROADMAP.md``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from primekg_rgcn_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """``n_shards`` shards along one axis, all on ``device``."""

    n_shards: int
    device: torch.device


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh of ``num_devices`` shards on ``device``; ``None`` takes the
    number of visible devices of that type (the CPU counts one). Fewer than
    2 shards raise: a sharded layout on one shard is the dense path with
    extra copies."""
    dev = resolve_device(device)
    if num_devices is None:
        num_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    if num_devices < 2:
        raise ValueError(
            f"a sharded layout needs at least 2 shards, got {num_devices}; "
            f"pass --n_devices N (every shard of a mesh lives on {dev})")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(int(num_devices), dev)


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over the shards: the one total every shard reads."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack the shards' tensors along a new leading axis [n, ...]."""
    return torch.stack(list(xs))
