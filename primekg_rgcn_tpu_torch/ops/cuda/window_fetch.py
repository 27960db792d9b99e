"""Contiguous-window record fetch for block sampling: the CUDA kernel, its
plain PyTorch version and the wrapper that picks between them by device.

    out[i, j, :] = packed[starts[i] + j, :]   for j in [0, width)

This is the counterpart of ``window_rows_fetch`` in
``primekg_rgcn_tpu/ops/pallas/window_fetch.py``: it replaces the TPU kernel
``_roll_kernel`` (through ``_pallas_window_fetch``). The kernel source is
``primekg_rgcn_tpu_torch/csrc/window_fetch.cu``; its header comment gives
the design (threads over the flat output, one 16-byte chunk of two
records a thread) and what bounds it on the H100 (memory bytes; at the
bench.py graph's outer layers launch latency). It is built with ``nvcc``
for ``sm_90a`` at first use into ``primekg_rgcn_tpu_torch/_build/`` and
bound through ``ctypes`` (``ops/cuda/build.py``). Block-mode sampling over
a slim packed CSR calls it once per layer
(``data/sampling._sample_layer_combined``).
"""

from __future__ import annotations

import ctypes

import torch

from primekg_rgcn_tpu_torch.ops.cuda.build import (CudaLibrary, call_on_stream,
                                                   check_rc)

# Records per granule row of the pairs form: [G, 128] int32 is the same
# bytes as [G * 64, 2].
GRANULE = 64
MAX_WIDTH = 64

_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("window_fetch.cu", {
    "window_rows_fetch_i32": (_p, _p, _p, _i, _i, _i, _p)})


def _rows(packed: torch.Tensor) -> torch.Tensor:
    """The record table as int32 [rows, 2], from the row form [Ep, 2] or the
    granule-pairs form [G, 128] (a view either way)."""
    if packed.dim() != 2 or packed.dtype != torch.int32 or \
            packed.shape[1] not in (2, 2 * GRANULE):
        raise ValueError(f"packed must be int32 [Ep, 2] or [G, "
                         f"{2 * GRANULE}], got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    return packed.view(-1, 2)


def _check(rows: torch.Tensor, starts: torch.Tensor, width: int) -> None:
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"window width {width} outside [1, {MAX_WIDTH}] "
                         f"(the packed table's tail padding is sized for "
                         f"the 48-slot budget cap)")
    if starts.dim() != 1 or starts.dtype != torch.int32:
        raise ValueError(f"starts must be int32 [M], got {starts.dtype} "
                         f"{tuple(starts.shape)}")
    if starts.device != rows.device:
        raise ValueError("packed and starts must share one device")
    if not starts.is_contiguous():
        raise ValueError("starts must be contiguous")
    if rows.shape[0] >= 2 ** 31 or starts.shape[0] * width >= 2 ** 31:
        raise ValueError("sizes beyond int32 indexing are not supported")


def window_rows_fetch_plain(packed: torch.Tensor, starts: torch.Tensor,
                            width: int) -> torch.Tensor:
    """Plain PyTorch version: one row gather of every window's records
    (a window past the table raises ``IndexError``)."""
    rows = _rows(packed)
    pos = starts.long()[:, None] + torch.arange(width, device=rows.device)
    return rows[pos]


def window_rows_fetch(packed: torch.Tensor, starts: torch.Tensor,
                      width: int) -> torch.Tensor:
    """``packed[starts[i] : starts[i] + width]`` for every i, as int32
    [M, width, 2].

    Args:
        packed: the slim combined CSR's record table, int32 [Ep, 2] or its
            granule-pairs view [G, 128], with tail padding so that every
            window lies inside it (``data/sampling.build_combined_csr``).
        starts: int32 [M] record indices; ``0 <= start <= Ep - width``.
        width: window length F, 1 <= F <= 64.

    On a CPU tensor this runs the plain version, after checking the starts
    on the host (``ValueError``); on a CUDA tensor it launches the kernel or
    raises, and the kernel asserts each window's bounds on the device.
    """
    rows = _rows(packed)
    _check(rows, starts, width)
    if rows.device.type == "cpu":
        if starts.shape[0] and (int(starts.min()) < 0 or
                                int(starts.max()) > rows.shape[0] - width):
            raise ValueError(f"window starts must lie in [0, "
                             f"{rows.shape[0] - width}]")
        return window_rows_fetch_plain(rows, starts, width)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    return launch(rows, starts, width)


def launch(rows: torch.Tensor, starts: torch.Tensor,
           width: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors that ``window_rows_fetch`` has
    checked; counts the launch."""
    m = starts.shape[0]
    out = rows.new_empty((m, width, 2))
    if m == 0:
        return out
    if rows.data_ptr() % 8:
        raise ValueError("packed must be 8-byte aligned (one record per "
                         "int2 load)")
    rc = call_on_stream(LIBRARY.load().window_rows_fetch_i32,
                        rows.get_device(), rows.data_ptr(), starts.data_ptr(),
                        out.data_ptr(), m, width, rows.shape[0])
    check_rc(rc, "window_rows_fetch")
    window_rows_fetch.launches += 1
    return out


window_rows_fetch.launches = 0
