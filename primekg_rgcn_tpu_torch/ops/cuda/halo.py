"""Halo exchange of the node-sharded layer: the CUDA kernel, its plain
PyTorch version and the wrapper that picks between them by device.

    recv[o][d] = send[d][o]   for every pair of shards (d, o)

``send[d]`` is shard d's [n, P, D] (block o: the P rows d serves to peer
o); ``recv[o]`` is shard o's [n, P, D] (block d: what d sent it), float32
or, under bf16 compute, bfloat16 (the C entries ``halo_exchange_f32`` and
``_bf16``; ``halo_exchange.launches`` counts every launch and
``.launches_bf16`` the bf16 ones). This
is the counterpart of ``pallas_halo_exchange`` in
``primekg_rgcn_tpu/ops/pallas/halo.py``: it replaces the TPU kernel
``_halo_kernel``, with the semantics of a tiled ``lax.all_to_all`` over the
mesh axis. One process drives every shard and the shards' tensors all lie
on the mesh's one device, so the exchange is one launch over the n * n
pairs (``csrc/halo_exchange.cu``; its header comment gives the design, the
redesigns measured against it, and what bounds it on the H100: memory
bytes). It is built with ``nvcc`` for
``sm_90a`` at first use into ``primekg_rgcn_tpu_torch/_build/`` and bound
through ``ctypes`` (``ops/cuda/build.py``).

Across processes (a ``parallel/mesh.Mesh`` whose shards are split over the
processes of a ``torch.distributed`` group) each process passes its k
shards' sends, each [n, P, D] over all n shards, and gets its k shards'
recvs. The pairs whose two shards this process holds go through one launch
of the kernel over the k x k pairs: the sends' and recvs' k-block slices of
this process's shards are contiguous [k, P, D] views, which the kernel
takes as it takes whole tensors, 16-byte path included. The other pairs go
through one ``parallel/mesh.all_to_all`` over a packed [P_w - 1, k, k, P,
D] buffer (P_w processes), packed and unpacked by plain copies: the
communication's staging, as XLA's ``all_to_all`` stages the JAX default
``--halo_impl xla``. Every process joins the exchange, even when its sends
are all padding.

``HaloExchange`` is the differentiable form, the counterpart of the
``jax.custom_vjp`` around the TPU kernel: the exchange permutes blocks, so
its transpose is the same exchange applied to the gradients, and the
backward launches the kernel too (and, across processes, the
all-to-all).
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from primekg_rgcn_tpu_torch.ops.cuda.build import (CudaLibrary, call_on_stream,
                                                   check_rc)
from primekg_rgcn_tpu_torch.parallel.mesh import Mesh, all_to_all, spans

# The kernel's parameter block holds this many send and recv pointers.
MAX_SHARDS = 64

_p, _i = ctypes.c_void_p, ctypes.c_int
_ARGS = (_p, _p, _p, _i, ctypes.c_longlong, _i, _i, _p)
LIBRARY = CudaLibrary("halo_exchange.cu", {
    "halo_exchange_f32": _ARGS, "halo_exchange_bf16": _ARGS})
PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)


def halo_schedule(n: int) -> List[Tuple[str, int]]:
    """The TPU kernel's event order for an ``n``-shard exchange:
    ``[("start", 0), ..., ("start", n-2), ("local_copy", -1), ("wait", 0),
    ..., ("wait", n-2)]``. Transfer i of shard s goes to peer
    ``(s + 1 + i) % n``; the CUDA kernel's work list follows this order
    (:func:`step_offsets`)."""
    events: List[Tuple[str, int]] = [("start", i) for i in range(n - 1)]
    events.append(("local_copy", -1))
    events.extend(("wait", i) for i in range(n - 1))
    return events


def step_offsets(n: int) -> List[int]:
    """The kernel's copy steps from ``halo_schedule(n)``'s copy events: at
    step i shard s copies its block for peer ``(s + offsets[i]) % n``:
    ``1 + i`` for ("start", i), 0 for the local copy. Pair k of the
    kernel's work list is step ``k // n`` of shard ``k % n``. Waits have no
    step: the kernel's end completes every pair."""
    return [1 + i if kind == "start" else 0
            for kind, i in halo_schedule(n) if kind != "wait"]


def _check(sends: Sequence[torch.Tensor], n: int) -> None:
    if not 1 <= len(sends) <= n <= MAX_SHARDS:
        raise ValueError(f"need 1 to {MAX_SHARDS} shards, got {len(sends)} "
                         f"of {n}")
    shape, dtype, device = sends[0].shape, sends[0].dtype, sends[0].device
    for s in sends:
        if s.dtype not in PAYLOAD_DTYPES or s.dim() != 3 or s.shape[0] != n:
            raise ValueError(f"each send must be float32 or bfloat16 "
                             f"[{n}, P, D], got {s.dtype} {tuple(s.shape)}")
        if s.dtype != dtype:
            raise ValueError(f"sends differ in dtype: {s.dtype} vs {dtype}")
        if s.shape != shape:
            raise ValueError(f"sends differ in shape: {tuple(s.shape)} vs "
                             f"{tuple(shape)}")
        if s.device != device:
            raise ValueError("every send must lie on the mesh's one device")
        if not s.is_contiguous():
            raise ValueError("sends must be contiguous")


def _pairs_plain(sends: Sequence[torch.Tensor],
                 recvs: Sequence[torch.Tensor]) -> None:
    """The plain exchange written into ``recvs``: ``recv[o][d] =
    send[d][o]`` over the len(sends) shards given."""
    for o, r in enumerate(recvs):
        torch.stack([s[o] for s in sends], out=r)


def _across(sends: Sequence[torch.Tensor], mesh: Mesh,
            pairs: Callable) -> List[torch.Tensor]:
    """The exchange of this process's k shards over a ``mesh`` that spans
    processes: ``pairs(send_views, recv_views)`` writes the k x k pairs
    inside the process, the all-to-all brings the others."""
    k, lo, world = len(sends), mesh.local.start, mesh.world
    recvs = [torch.empty_like(sends[0]) for _ in range(k)]
    pairs([s[lo:lo + k] for s in sends], [r[lo:lo + k] for r in recvs])
    others = [q for q in range(world) if q != mesh.rank]
    # Block b (to process q = others[b]) holds send[i][q k + j] at [i, j].
    packed = torch.stack([s[q * k:(q + 1) * k] for q in others
                          for s in sends])
    got = all_to_all(packed.view(world - 1, k, *packed.shape[1:]), mesh)
    for b, q in enumerate(others):
        for j, r in enumerate(recvs):
            r[q * k:(q + 1) * k].copy_(got[b, :, j])
    return recvs


def halo_exchange_plain(sends: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain PyTorch version: ``recv[o] = stack([send[d][o] for d])``
    (autograd differentiates it)."""
    n = len(sends)
    return [torch.stack([sends[d][o] for d in range(n)]) for o in range(n)]


def halo_exchange(sends: Sequence[torch.Tensor],
                  mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Exchange the shards' halo rows: ``recv[o][d] = sends[d][o]``.

    Args:
        sends: one [n, P, D] contiguous tensor per shard, float32 or
            bfloat16, all of one shape and dtype and on one device.
        mesh: where its shards are split over processes, ``sends`` are
            this process's (``mesh.local``), still [n, P, D] over the n
            shards, and so are the recvs returned; every process calls.

    Returns the recv tensors, each of its own allocation. On CPU tensors
    this runs the plain version; on CUDA tensors it launches the kernel or
    raises (across processes: over the pairs inside this process, and the
    all-to-all for the rest). It records no gradient: differentiate
    through ``HaloExchange.apply``.
    """
    _check(sends, mesh.n_shards if spans(mesh) else len(sends))
    if spans(mesh) and len(sends) != len(mesh.local):
        raise ValueError(f"this process holds {len(mesh.local)} shards, got "
                         f"{len(sends)} sends")
    if torch.is_grad_enabled() and any(s.requires_grad for s in sends):
        raise ValueError("halo_exchange records no gradient; differentiate "
                         "through HaloExchange.apply")
    dev = sends[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if spans(mesh):
        return _across(sends, mesh,
                       _pairs_plain if dev.type == "cpu" else launch)
    if dev.type == "cpu":
        return halo_exchange_plain(sends)
    return launch(sends)


def vec_width(p: int, d: int, element_size: int, ptrs: Sequence[int]) -> int:
    """The kernel's vector for a [n, P, D] exchange, in elements:
    ``16 // element_size`` (16-byte vectors) when a pair's P * D elements
    are whole 16-byte units and every pointer is 16-byte aligned, else 1
    (one element a thread). Decided by shape and alignment before the
    launch."""
    wide = 16 // element_size
    return wide if (p * d) % wide == 0 and not functools.reduce(
        operator.or_, ptrs) & 15 else 1


@functools.lru_cache(maxsize=None)
def _offsets(n: int):
    """``step_offsets(n)`` as the C array the entry reads, built once per
    n (the entry never writes it)."""
    return (ctypes.c_int * n)(*step_offsets(n))


def launch(sends: Sequence[torch.Tensor],
           recvs: Optional[Sequence[torch.Tensor]] = None
           ) -> List[torch.Tensor]:
    """Launch the kernel on CUDA tensors that ``halo_exchange`` has
    checked, the entry of their dtype; counts the launch (and a bf16 one).
    Writes into ``recvs`` (contiguous, the sends' shape and dtype: views
    of larger tensors are welcome) or new tensors. 16-byte vectors where
    ``vec_width`` allows them, else one element a thread."""
    s0 = sends[0]
    n, p, d = s0.shape
    if recvs is None:
        recvs = [torch.empty_like(s0) for _ in range(n)]
    elif any(r.shape != s0.shape or r.dtype != s0.dtype or
             not r.is_contiguous() for r in recvs):
        raise ValueError("recvs must be contiguous, of the sends' shape and "
                         "dtype")
    if p * d == 0:
        return recvs
    ptrs = [s.data_ptr() for s in sends] + [r.data_ptr() for r in recvs]
    table = ctypes.c_uint64 * n
    bf16 = s0.dtype == torch.bfloat16
    lib = LIBRARY.load()
    entry = lib.halo_exchange_bf16 if bf16 else lib.halo_exchange_f32
    rc = call_on_stream(
        entry, s0.get_device(), table(*ptrs[:n]), table(*ptrs[n:]),
        _offsets(n), n, p, d, vec_width(p, d, s0.element_size(), ptrs))
    check_rc(rc, "halo_exchange")
    halo_exchange.launches += 1
    halo_exchange.launches_bf16 += bf16
    return recvs


halo_exchange.launches = 0
halo_exchange.launches_bf16 = 0


class HaloExchange(torch.autograd.Function):
    """``halo_exchange`` with its gradient: ``HaloExchange.apply(*sends)``,
    or ``HaloExchange.apply(mesh, *sends)`` across processes, returns the
    recv tensors. The gradient of ``send[d][o]`` is that of ``recv[o][d]``,
    so the backward is the same exchange over the recv gradients (an
    output without a gradient contributes zeros). On the CPU both
    directions run the plain version, on the card both launch the kernel
    (and count)."""

    @staticmethod
    def forward(ctx, *args) -> Tuple[torch.Tensor, ...]:
        mesh = args[0] if isinstance(args[0], Mesh) else None
        sends = args if mesh is None else args[1:]
        ctx.mesh = mesh
        ctx.set_materialize_grads(True)
        return tuple(halo_exchange(sends, mesh))

    @staticmethod
    def backward(ctx, *grads: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = tuple(halo_exchange([g.contiguous() for g in grads], ctx.mesh))
        return out if ctx.mesh is None else (None, *out)
