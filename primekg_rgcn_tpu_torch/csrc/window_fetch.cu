// Contiguous-window record fetch for block sampling, for Hopper (sm_90a).
//
//   out[i, j, :] = packed[starts[i] + j, :]   for j in [0, width), width <= 64
//
// packed is the slim combined CSR's record table, int32 [rows, 2] (src id,
// rel << 16 | float16 bits of the (dst, rel) in-degree), with at least 128
// sentinel records of tail padding (data/sampling.build_combined_csr), so a
// window that starts at or near the last real record reads padding, never
// past the table. starts are int32 [M] record indices, out int32 [M, width, 2].
//
// Replaces the TPU kernel primekg_rgcn_tpu/ops/pallas/window_fetch.py:
// _roll_kernel (reached through _pallas_window_fetch / window_rows_fetch).
// That kernel DMAs the two aligned 64-record granules a window straddles and
// rolls the window out across the 128 lanes, because Mosaic can only slice
// 128-lane granules at aligned offsets, and it chunks the starts to fit SMEM.
// None of that carries over: a window is at most 64 records of 8 bytes, so one
// warp copies it with one or two coalesced 8-byte loads per lane straight to
// the output, and each block loads its own starts.
//
// Design: one warp per window, lane l copies records l and l + 32. The start
// is one word that every lane of the warp reads (one transaction, broadcast).
//
// Bound on the H100: memory. The function must read each window's records and
// the starts once and write the windows once: at the sampled training step's
// shapes (4,096 windows of 32 records and 30,976 of 24) about 14 MB in both
// directions, a few microseconds at 3.35 TB/s, so launch latency dominates.
//
// Checks: a device-side assert stops a start outside [0, rows - width], as
// the gather + segment-sum kernel asserts its CSR; it costs no synchronise
// with the host and surfaces as "device-side assert triggered" at the caller's
// next synchronise.

#undef NDEBUG  // the checks stay in whatever the build flags say
#include <cassert>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
window_rows_fetch_kernel(const int2* __restrict__ packed, const int32_t* __restrict__ starts,
                         int2* __restrict__ out, int num_windows, int width, int num_records) {
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= num_windows) return;  // whole warp leaves together
  const int start = __ldg(starts + w);
  assert(start >= 0 && start <= num_records - width);
  const int2* src = packed + start;
  int2* dst = out + static_cast<int64_t>(w) * width;
  if (lane < width) dst[lane] = __ldg(src + lane);
  if (lane + 32 < width) dst[lane + 32] = __ldg(src + lane + 32);
}

}  // namespace

// C entry for ctypes. packed has num_records records of two int32 (8-byte
// aligned, which the wrapper checks), starts num_windows entries, out
// num_windows * width records. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int window_rows_fetch_i32(const int32_t* packed, const int32_t* starts, int32_t* out,
                                     int num_windows, int width, int num_records, void* stream) {
  if (num_windows <= 0) return 0;
  if (width < 1 || width > 64) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((num_windows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  window_rows_fetch_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int2*>(packed), starts, reinterpret_cast<int2*>(out), num_windows,
      width, num_records);
  return static_cast<int>(cudaGetLastError());
}
