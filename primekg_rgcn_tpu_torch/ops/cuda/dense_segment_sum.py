"""Dense-output sorted segment-sum over batch-dynamic ids: the CUDA kernel,
its plain PyTorch version and the wrapper that picks between them by device.

    out[s, :] = sum_{i : srt[i] == s} msg[i, :]   for s in [0, num_segments)

This is the counterpart of ``dense_sorted_segment_sum`` in
``primekg_rgcn_tpu/ops/pallas/segment_sum.py``: it replaces the TPU kernel
``_dense_seg_kernel`` and its device-built pair schedule (``_dense_pairs``).
The kernel source is ``primekg_rgcn_tpu_torch/csrc/dense_segment_sum.cu``;
its header comment gives the design (the output zeroed, the real rows
split into pieces of equal length, one warp each, and a fix-up launch that
adds the carries of runs that cross pieces in piece order) and what bounds
it on the H100 (memory bytes). ``piece_plan`` sizes the split and ``scratch`` its carries;
``b2_width`` picks the row loads. It is built with ``nvcc`` for ``sm_90a`` at
first use into ``primekg_rgcn_tpu_torch/_build/`` and bound through
``ctypes`` (``ops/cuda/build.py``): the same source twice, float32 rows
(``LIBRARY``, entry ``dense_sorted_segment_sum_f32``) and bf16 rows
(``LIBRARY_BF16``, ``dense_sorted_segment_sum_bf16``), so that the two
compile in parallel. The sum and the output are float32 for either.

Its callers, all deterministic on the card (no float atomics): the identity
block's backward of the sampled step (``data/sampling.IdentPickGather``),
the dedup and table-gather backwards (``data/sampling._sorted_accumulate``,
also zero3's row fetch, ``train/sampled.ShardedRowFetch``) and, through
``SortedSegmentSum``, the batch-restricted final layer's forward
segment-sum (``ops/rgcn_final_layer``).

``dense_sorted_segment_sum.launches`` counts one per call that launches,
whatever the number of kernels inside (the zeros, the row split and its
fix-up), and ``.launches_bf16`` the calls on bf16 rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from primekg_rgcn_tpu_torch.ops.cuda.build import (CudaLibrary, call_on_stream,
                                                   check_rc)
from primekg_rgcn_tpu_torch.ops.cuda.segment_sum import _num_sms

_p, _i = ctypes.c_void_p, ctypes.c_int
_ARGS = (_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _p)
LIBRARY = CudaLibrary("dense_segment_sum.cu",
                      {"dense_sorted_segment_sum_f32": _ARGS})
LIBRARY_BF16 = CudaLibrary("dense_segment_sum.cu",
                           {"dense_sorted_segment_sum_bf16": _ARGS},
                           defines=("-DB2_ROWS_BF16",))

WAVE_WARPS_PER_SM = 24    # pieces a launch gives each SM
MIN_ROWS_PER_PIECE = 64


@functools.lru_cache(maxsize=4096)
def piece_plan(num_rows: int, num_sms: int) -> Tuple[int, int]:
    """``(min_rows, num_pieces)`` of the kernel's split, from L and the SM
    count alone.

    The kernel cuts the real rows ``[0, L_real)`` (those whose id is below
    N; it finds L_real on the device) into ``num_pieces`` pieces of
    ``max(min_rows, ceil(L_real / num_pieces))`` rows, one warp each, so a
    launch's time follows its real row count, not its longest run. There
    are ``WAVE_WARPS_PER_SM`` pieces for each SM, more than the 16 warps
    an SM holds at once (16, 32 and 48 ran slower on the H100's identity
    streams, ``scripts/port_time_b2.py``), never shorter than
    ``MIN_ROWS_PER_PIECE`` rows, so that a warp's fixed costs stay a small
    share of its work; pieces past L_real do nothing.
    """
    pieces = min(-(-num_rows // MIN_ROWS_PER_PIECE),
                 num_sms * WAVE_WARPS_PER_SM)
    return MIN_ROWS_PER_PIECE, max(1, pieces)


def scratch(num_pieces: int, d: int, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch, one allocation: float32 [num_pieces, D], the
    partial sum each piece leaves for the run it ends in, and int32
    [2 + num_pieces]: L_real and the piece length, which the first launch
    writes for the others, and the id of the run each piece carries (-1
    for none), the fix-up's index. The launches write all of it before
    they read it, so it starts uninitialised."""
    flat = torch.empty(num_pieces * (d + 1) + 2, dtype=torch.float32,
                       device=device)
    return (flat[:num_pieces * d].view(num_pieces, d),
            flat[num_pieces * d:].view(torch.int32))


def b2_width(d: int, *tensors: torch.Tensor) -> Tuple[int, int]:
    """``(vec, lanes)`` of the kernel's row loads: ``vec`` elements per
    lane, 16 bytes where D and every tensor's alignment allow it (4 float32
    or 8 bf16 elements), else 8, 4 or 2 bytes; ``lanes`` the lanes that
    share one row, the least power of two that covers D / vec, at most 32.
    A warp then reads 32 / lanes rows in one instruction: at D = 64 two
    float32 rows or four bf16 rows; a row wider than 32 vectors is walked
    in column chunks."""
    vecs = (8, 4, 2) if tensors[0].dtype == torch.bfloat16 else (4, 2)
    vec = 1
    for v in vecs:
        if d % v == 0 and all(t.data_ptr() % (t.element_size() * v) == 0
                              for t in tensors):
            vec = v
            break
    lanes = 1
    while lanes < min(d // vec, 32):
        lanes *= 2
    return vec, lanes


def _check(msg: torch.Tensor, srt: torch.Tensor, num_segments: int) -> None:
    if msg.dim() != 2 or msg.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"msg must be float32 or bfloat16 [L, D], got "
                         f"{msg.dtype} {tuple(msg.shape)}")
    if srt.dim() != 1 or srt.dtype != torch.int32 or \
            srt.shape[0] != msg.shape[0]:
        raise ValueError(f"srt must be int32 [{msg.shape[0]}], got "
                         f"{srt.dtype} {tuple(srt.shape)}")
    if srt.device != msg.device:
        raise ValueError("msg and srt must share one device")
    if not (msg.is_contiguous() and srt.is_contiguous()):
        raise ValueError("msg and srt must be contiguous")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if msg.numel() >= 2 ** 31 or num_segments * msg.shape[1] >= 2 ** 31:
        raise ValueError("sizes beyond int32 indexing are not supported")


def dense_sorted_segment_sum_plain(msg: torch.Tensor, srt: torch.Tensor,
                                   num_segments: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the rows in float32 into
    one spare row that takes every id >= ``num_segments`` and is then
    dropped (no host sync)."""
    out = torch.zeros(num_segments + 1, msg.shape[1], dtype=torch.float32,
                      device=msg.device)
    out.index_add_(0, srt.clamp(max=num_segments).long(), msg.float())
    return out[:num_segments]


def dense_sorted_segment_sum(msg: torch.Tensor, srt: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """float32 [num_segments, D] segment-sum of ``msg`` by sorted ids.

    Args:
        msg: float32 or bfloat16 [L, D] rows, any D >= 1.
        srt: int32 [L] non-decreasing ids >= 0; ids >= ``num_segments``
            drop.
        num_segments: output rows N.

    On a CPU tensor this runs the plain version, after checking on the host
    that the ids are sorted and not negative (``ValueError`` otherwise); on
    a CUDA tensor it launches the kernel or raises, and the kernel asserts
    the order on the device. An empty ``msg`` gives zeros.
    """
    _check(msg, srt, num_segments)
    if msg.device.type == "cpu":
        if srt.shape[0] and (int(srt[0]) < 0
                             or bool((srt[1:] < srt[:-1]).any())):
            raise ValueError("srt must be non-decreasing and >= 0")
        return dense_sorted_segment_sum_plain(msg, srt, num_segments)
    if msg.device.type != "cuda":
        raise ValueError(f"unsupported device {msg.device}")
    return launch(msg, srt, num_segments)


def launch(msg: torch.Tensor, srt: torch.Tensor,
           num_segments: int) -> torch.Tensor:
    """Launch the kernel's three launches on CUDA tensors that
    ``dense_sorted_segment_sum`` has checked, the entry of msg's dtype;
    counts one launch per call (and a bf16 one). Nothing to sum (L or N
    zero) gives zeros without a launch."""
    ln, d = msg.shape
    if ln == 0 or num_segments == 0:
        return torch.zeros(num_segments, d, dtype=torch.float32,
                           device=msg.device)
    out = torch.empty(num_segments, d, dtype=torch.float32,
                      device=msg.device)
    vec, lanes = b2_width(d, msg, out)
    min_rows, pieces = piece_plan(ln, _num_sms(msg.device))
    carry, meta = scratch(pieces, d, msg.device)
    bf16 = msg.dtype == torch.bfloat16
    entry = (LIBRARY_BF16.load().dense_sorted_segment_sum_bf16 if bf16
             else LIBRARY.load().dense_sorted_segment_sum_f32)
    rc = call_on_stream(
        entry, msg.get_device(), msg.data_ptr(), srt.data_ptr(),
        out.data_ptr(), carry.data_ptr(), meta.data_ptr(), ln, d,
        num_segments, vec, lanes, min_rows, pieces)
    check_rc(rc, "dense_sorted_segment_sum")
    dense_sorted_segment_sum.launches += 1
    dense_sorted_segment_sum.launches_bf16 += bf16
    return out


dense_sorted_segment_sum.launches = 0
dense_sorted_segment_sum.launches_bf16 = 0


class SortedSegmentSum(torch.autograd.Function):
    """``dense_sorted_segment_sum`` with its gradient, for ids inside
    ``[0, num_segments)``: ``apply(msg, ids, num_segments)``.

    The forward is kernel B2 on the card and its plain version on the CPU
    (float32 out); the backward is the gather ``grad.index_select(0, ids)``
    in float32, cast to msg's dtype: plain torch, no kernel. ``ids`` are
    int64 or int32, sorted, and converted to int32 once; ``num_segments``
    must fit int32, so every id inside it does (checked on the host, with
    no read of the ids). They are a constant of the call.
    """

    @staticmethod
    def forward(ctx, msg: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
        if ids.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"ids must be int32 or int64, got {ids.dtype}")
        if num_segments >= 2 ** 31:
            raise ValueError(f"num_segments {num_segments} does not fit "
                             f"int32")
        ids = ids.to(torch.int32).contiguous()
        ctx.save_for_backward(ids)
        ctx.dtype = msg.dtype
        return dense_sorted_segment_sum(msg.contiguous(), ids, num_segments)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        return grad.float().index_select(0, ids).to(ctx.dtype), None, None
