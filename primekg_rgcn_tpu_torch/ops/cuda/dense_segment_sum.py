"""Dense-output sorted segment-sum over batch-dynamic ids: the CUDA kernel,
its plain PyTorch version and the wrapper that picks between them by device.

    out[s, :] = sum_{i : srt[i] == s} msg[i, :]   for s in [0, num_segments)

This is the counterpart of ``dense_sorted_segment_sum`` in
``primekg_rgcn_tpu/ops/pallas/segment_sum.py``: it replaces the TPU kernel
``_dense_seg_kernel`` and its device-built pair schedule (``_dense_pairs``).
The kernel source is ``primekg_rgcn_tpu_torch/csrc/dense_segment_sum.cu``;
its header comment gives the design and what bounds it on the H100 (memory
bytes). It is built with ``nvcc`` for ``sm_90a`` at first use into
``primekg_rgcn_tpu_torch/_build/`` and bound through ``ctypes``
(``ops/cuda/build.py``). The sampled training step calls it in the identity
block's backward (``data/sampling.IdentPickGather``).

msg is float32 or, under bf16 compute, bfloat16 (entries
``dense_sorted_segment_sum_f32`` and ``_bf16``); the sum and the output are
float32 for either. ``dense_sorted_segment_sum.launches`` counts every
launch and ``.launches_bf16`` the bf16 ones.
"""

from __future__ import annotations

import ctypes

import torch

from primekg_rgcn_tpu_torch.ops.cuda.build import (CudaLibrary, check_rc,
                                                  vec_width)

_p, _i = ctypes.c_void_p, ctypes.c_int
_ARGS = (_p, _p, _p, _i, _i, _i, _i, _p)
LIBRARY = CudaLibrary("dense_segment_sum.cu", {
    "dense_sorted_segment_sum_f32": _ARGS,
    "dense_sorted_segment_sum_bf16": _ARGS})


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
    """Launch the kernel on CUDA tensors that ``dense_sorted_segment_sum``
    has checked, the entry of msg's dtype; counts the launch (and a bf16
    one). Nothing to sum (L or N zero) gives zeros without a launch."""
    ln, d = msg.shape
    if ln == 0 or num_segments == 0:
        return torch.zeros(num_segments, d, dtype=torch.float32,
                           device=msg.device)
    out = torch.empty(num_segments, d, dtype=torch.float32,
                      device=msg.device)
    vec = vec_width(d, msg, out)
    bf16 = msg.dtype == torch.bfloat16
    lib = LIBRARY.load()
    entry = (lib.dense_sorted_segment_sum_bf16 if bf16
             else lib.dense_sorted_segment_sum_f32)
    with torch.cuda.device(msg.device):
        rc = entry(
            msg.data_ptr(), srt.data_ptr(), out.data_ptr(), ln, d,
            num_segments, vec, torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "dense_sorted_segment_sum")
    dense_sorted_segment_sum.launches += 1
    dense_sorted_segment_sum.launches_bf16 += bf16
    return out


dense_sorted_segment_sum.launches = 0
dense_sorted_segment_sum.launches_bf16 = 0
