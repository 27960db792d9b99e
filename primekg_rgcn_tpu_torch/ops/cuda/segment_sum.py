"""Fused gather + sorted segment-sum: the CUDA kernel, its plain PyTorch
version and the wrapper that picks between them by device.

    out[d, :] = sum_{e in [rowptr[d], rowptr[d+1])} x[src[e], :] * scale[e]

x is a float32 or a bfloat16 table; the sum and the output are float32 for
either, as the TPU kernel summed bf16 rows in float32 under bf16 compute
(``mxu_dtype=bfloat16``). With a bf16 table and a scale, each product is
rounded to bf16 before it is added, as the JAX layer rounds its float32
messages to bf16 on the way into that kernel.

This is the counterpart of ``primekg_rgcn_tpu/ops/pallas/segment_sum.py``:
it replaces the TPU kernel ``_segment_kernel`` (reached through
``sorted_segment_sum_pallas``) together with the row gather in front of it.
The kernel source is ``primekg_rgcn_tpu_torch/csrc/gather_segment_sum.cu``;
its header comment gives the design (an edge-balanced merge-path partition,
one warp per piece, and a fix-up launch that adds the carries of rows that
cross pieces in piece order) and what bounds it on the H100 (memory bytes).
``piece_plan`` sizes the partition and its scratch, ``b1_width`` the row
loads. A float32 table launches the entry ``gather_segment_sum_f32`` of
``LIBRARY``, a bf16 one ``gather_segment_sum_bf16`` of ``LIBRARY_BF16``:
the same source built twice, one table type each, so that the two compile
in parallel. ``gather_segment_sum.launches`` counts every launch and
``gather_segment_sum.launches_bf16`` the bf16 ones. It is built with
``nvcc`` for ``sm_90a`` at first use into ``primekg_rgcn_tpu_torch/_build/``
and bound through ``ctypes`` (``ops/cuda/build.py``).

``GatherSegmentSum`` is the differentiable form, the counterpart of the
``jax.custom_vjp`` in ``primekg_rgcn_tpu/ops/rgcn_segment.py``
(``make_gather_segment_sum``): its backward is the same kernel over the
transpose CSR, so the gradient is a sorted gather + segment-sum too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from primekg_rgcn_tpu_torch.ops.cuda.build import (CudaLibrary, call_on_stream,
                                                   check_rc)

_p, _i = ctypes.c_void_p, ctypes.c_int
_ARGS = (_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p)
LIBRARY = CudaLibrary("gather_segment_sum.cu",
                      {"gather_segment_sum_f32": _ARGS})
LIBRARY_BF16 = CudaLibrary("gather_segment_sum.cu",
                           {"gather_segment_sum_bf16": _ARGS},
                           defines=("-DB1_TABLE_BF16",))
TABLE_DTYPES = (torch.float32, torch.bfloat16)


WAVE_WARPS_PER_SM = 32     # pieces a launch aims to keep resident per SM
MIN_ITEMS_PER_PIECE = 32


def piece_plan(num_segments: int, num_edges: int,
               num_sms: int) -> Tuple[int, int]:
    """``(items_per_piece, num_pieces)`` of the kernel's merge-path
    partition.

    The kernel walks the sequence of ``num_segments`` row ends merged with
    ``num_edges`` edges, one warp per piece of equal length, so a launch's
    time follows its edge and row counts, not its longest row. The pieces
    are sized to fill one wave of ``WAVE_WARPS_PER_SM`` warps on each SM,
    but never shorter than ``MIN_ITEMS_PER_PIECE`` items, so the partition
    search at a piece's start stays a small share of its work.
    """
    items = num_segments + num_edges
    per_piece = max(MIN_ITEMS_PER_PIECE,
                    -(-items // (num_sms * WAVE_WARPS_PER_SM)))
    return per_piece, -(-items // per_piece)


def carry_scratch(num_pieces: int, d: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch, one allocation: float32 [num_pieces, D], the
    partial sum each piece leaves for the row it ends in, and int32
    [num_pieces], that row's id (-1 for none). The kernel writes both
    before its fix-up reads them, so they start uninitialised."""
    flat = torch.empty(num_pieces * (d + 1), dtype=torch.float32,
                       device=device)
    return (flat[:num_pieces * d].view(num_pieces, d),
            flat[num_pieces * d:].view(torch.int32))


def b1_width(d: int, *tensors: torch.Tensor) -> Tuple[int, int]:
    """``(vec, lanes)`` of the kernel's row loads: ``vec`` elements per
    lane, 4 where D % 4 == 0 and every tensor is aligned to its own vector
    of 4 elements (16 bytes of float32, 8 of bf16), else 2 or 1; ``lanes``
    the lanes that share one gathered row, the least power of two that
    covers D / vec, at most the warp's 32. A warp then loads 32 / lanes
    rows in one instruction: one row at D = 128, two at D = 64 (a half-warp
    each); a row wider than 32 vectors is walked in column chunks. A bf16
    table takes the same widths: its 16-byte loads of 8 elements spilled in
    the kernel and ran slower on the H100 (``csrc/gather_segment_sum.cu``)."""
    vec = 1
    for v in (4, 2):
        if d % v == 0 and all(t.data_ptr() % (t.element_size() * v) == 0
                              for t in tensors):
            vec = v
            break
    lanes = 1
    while lanes < min(d // vec, 32):
        lanes *= 2
    return vec, lanes


def _check(x, src, rowptr, scale) -> None:
    if x.dim() != 2 or x.shape[1] < 1 or x.dtype not in TABLE_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16 [rows, D>=1], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if src.dim() != 1 or src.dtype != torch.int32:
        raise ValueError(f"src must be int32 [E], got {src.dtype} "
                         f"{tuple(src.shape)}")
    if rowptr.dim() != 1 or rowptr.shape[0] < 1 or rowptr.dtype != torch.int32:
        raise ValueError(f"rowptr must be int32 [S+1], got {rowptr.dtype} "
                         f"{tuple(rowptr.shape)}")
    tensors = [x, src, rowptr]
    if scale is not None:
        if scale.dtype != torch.float32 or scale.shape != src.shape:
            raise ValueError(f"scale must be float32 {tuple(src.shape)}, got "
                             f"{scale.dtype} {tuple(scale.shape)}")
        tensors.append(scale)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, src, rowptr and scale must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, src, rowptr and scale must be contiguous")
    # The partition indexes the merged rows and edges with int32.
    if x.numel() >= 2 ** 31 or rowptr.shape[0] + src.shape[0] >= 2 ** 30:
        raise ValueError("sizes beyond int32 indexing are not supported")


def _check_csr_ends(src, rowptr) -> None:
    """The CSR must cover src exactly. Checked on the host for CPU tensors;
    on the card the kernel asserts it (and every src id) on the device, so
    that a launch needs no synchronise."""
    first, last = rowptr[[0, -1]].tolist()
    if first != 0 or last != src.shape[0]:
        raise ValueError(f"rowptr must run from 0 to len(src) = "
                         f"{src.shape[0]}, got {first} .. {last}")


def gather_segment_sum_plain(x: torch.Tensor, src: torch.Tensor,
                             rowptr: torch.Tensor,
                             scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version: index_add_ of the gathered (scaled) rows in
    float32; a bf16 table is converted to float32, and its scaled products
    rounded to bf16 and back. The table is converted before the gather, so
    that autograd's backward of this version (``rgcn_segment.
    aggregate_plain``) sums a bf16 table's gradient in float32, as the
    kernel's backward does.

    The CSR covers src: ``rowptr[0] == 0`` and ``rowptr[-1] == len(src)``.
    """
    s = rowptr.shape[0] - 1
    counts = (rowptr[1:] - rowptr[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(s, device=x.device), counts,
                                  output_size=src.shape[0])
    msg = x.float()[src]
    if scale is not None:
        msg = (msg * scale[:, None]).to(x.dtype).float()
    return torch.zeros(s, x.shape[1], dtype=torch.float32,
                       device=x.device).index_add_(0, dst, msg)


def gather_segment_sum(x: torch.Tensor, src: torch.Tensor,
                       rowptr: torch.Tensor,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[d] = sum_{e in [rowptr[d], rowptr[d+1])} x[src[e]] * scale[e]``.

    Args:
        x: float32 or bfloat16 [rows, D] table; every ``src`` id must index
            a row.
        src: int32 [E] gather ids in destination order.
        rowptr: int32 [S+1] CSR row pointers over src (``rowptr[0] == 0``,
            ``rowptr[-1] == E``, non-decreasing).
        scale: optional float32 [E] per-edge weights.

    Returns float32 [S, D]. On a CPU tensor this runs the plain version; on
    a CUDA tensor it launches the kernel or raises. A CSR that breaks the
    contract above raises ``ValueError`` on the CPU; on the card the kernel
    stops on a device-side assert, reported at the next synchronise.
    """
    _check(x, src, rowptr, scale)
    if scale is not None and scale.requires_grad:
        raise ValueError("scale is a constant of the graph and must not "
                         "require a gradient")
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(
            "gather_segment_sum records no gradient; differentiate through "
            "GatherSegmentSum.apply with the transpose CSR")
    if x.device.type == "cpu":
        _check_csr_ends(src, rowptr)
        return gather_segment_sum_plain(x, src, rowptr, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return launch(x, src, rowptr, scale)


def launch(x: torch.Tensor, src: torch.Tensor, rowptr: torch.Tensor,
           scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel and its fix-up on CUDA tensors that
    ``gather_segment_sum`` has checked, the entry of x's dtype; counts one
    launch per call (and one bf16 launch for a bf16 table)."""
    s, d = rowptr.shape[0] - 1, x.shape[1]
    out = torch.empty(s, d, dtype=torch.float32, device=x.device)
    if s == 0:
        return out
    vec, lanes = b1_width(d, x, out)
    per_piece, pieces = piece_plan(s, src.shape[0], _num_sms(x.device))
    carry, carry_row = carry_scratch(pieces, d, x.device)
    bf16 = x.dtype == torch.bfloat16
    entry = (LIBRARY_BF16.load().gather_segment_sum_bf16 if bf16
             else LIBRARY.load().gather_segment_sum_f32)
    rc = call_on_stream(
        entry, x.get_device(), x.data_ptr(), src.data_ptr(),
        rowptr.data_ptr(), None if scale is None else scale.data_ptr(),
        out.data_ptr(), carry.data_ptr(), carry_row.data_ptr(),
        s, d, x.shape[0], src.shape[0], vec, lanes, per_piece, pieces)
    check_rc(rc, "gather_segment_sum")
    gather_segment_sum.launches += 1
    gather_segment_sum.launches_bf16 += bf16
    return out


gather_segment_sum.launches = 0
gather_segment_sum.launches_bf16 = 0


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


Csr = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


class GatherSegmentSum(torch.autograd.Function):
    """``gather_segment_sum`` with its transpose-graph gradient.

    ``forward(x, fwd, bwd)`` with ``fwd = (src, rowptr, scale)`` over the
    destination-sorted edges and ``bwd = (t_ids, t_rowptr, t_scale)`` the
    same edges sorted by source: ``t_ids`` are their destinations (the rows
    of the gradient to gather), ``t_rowptr`` the CSR over the source rows
    and ``t_scale`` their per-edge scales in that order. The gradient of x
    is ``gather_segment_sum(g, t_ids, t_rowptr, t_scale)``: each edge carries
    its output row's gradient back to its source row, as
    ``make_gather_segment_sum``'s VJP does in the JAX package. The index
    arrays and scales are constants; only x gets a gradient. On the CPU
    both directions run the plain version, on the card both launch the
    kernel (and count).

    A bf16 x gets a bf16 gradient, as the JAX VJP casts its float32 sum to
    the input's dtype: the float32 cotangent is rounded to bf16 first and
    summed by the bf16 kernel in float32. In edge mode that rounds each
    scaled product a second time, where the JAX path rounds once, after the
    scale (``ROADMAP.md``, queue C).
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, fwd: Csr, bwd: Csr) -> torch.Tensor:
        # gather_segment_sum checks the forward scale; the backward's is
        # checked here, before it is needed.
        if bwd[2] is not None and bwd[2].requires_grad:
            raise ValueError("scale is a constant of the graph and must not "
                             "require a gradient")
        ctx.bwd = bwd
        ctx.dtype = x.dtype
        return gather_segment_sum(x, *fwd)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.to(ctx.dtype).contiguous()
        return gather_segment_sum(g, *ctx.bwd).to(ctx.dtype), None, None
