// Contiguous-window record fetch for block sampling, for Hopper (sm_90a).
//
//   out[i, j, :] = packed[starts[i] + j, :]   for j in [0, width), 1 <= width <= 64
//
// packed is the slim combined CSR's record table, int32 [rows, 2] (src id,
// rel << 16 | float16 bits of the (dst, rel) in-degree), with at least 128
// sentinel records of tail padding (data/sampling.build_combined_csr), so a
// window that starts at or near the last real record reads padding, never
// past the table. starts are int32 [M] record indices, out int32 [M, width, 2].
//
// Replaces the TPU kernel primekg_rgcn_tpu/ops/pallas/window_fetch.py:92,
// _roll_kernel (launched at :146 by _pallas_window_fetch, reached through
// window_rows_fetch). That kernel DMAs the two aligned 64-record granules a
// window straddles and rolls the window out across the 128 lanes, because
// Mosaic can only slice 128-lane granules at aligned offsets. None of that
// carries over: a window starts at any 8-byte record, so there is no aligned
// tile for a bulk copy (or TMA) to fetch either.
//
// Bound on the H100: bytes. The records that the windows cover are read once
// (windows overlap: a block4 node's windows, a short row's window running
// into the next row), each window's records written once and each start
// read once, at 3.35 TB/s; there is no arithmetic to speak of. At the
// step's shapes that is under 4 us on the bench.py graph and about 30 us at
// config 5's inner layers (chip_smoke.b3_bound).
//
// Why the first design lost at short windows. It gave one warp to each
// window: lane l copied records l and l + 32. At widths of 6 to 12 records
// 20 to 26 of the 32 lanes did nothing, and a warp had only width * 8 bytes
// in flight, 48 to 96 bytes; 64 resident warps an SM then held 3-6 KB in
// flight. Covering HBM's latency at its rate needs about 3.35 TB/s * 0.7 us
// / 132 SMs = 18 KB in flight an SM. At width 40 (320 bytes a warp, about
// 20 KB an SM) the design ran at 89 % of its bound; at width 10 at 41 % and
// at width 6 at 33 %, slower than PyTorch's row gather. The limit was bytes
// in flight, not bandwidth and not instructions.
//
// The mapping now: threads run over the flat output, not over windows. The
// output is M * width consecutive 8-byte records; torch.empty gives a base
// aligned to 16 bytes (checked), so it is (M * width) / 2 chunks of 16 bytes
// (two records) and, when M * width is odd, one trailing record written
// alone. Thread c of the grid owns chunk c, so each store instruction of a
// warp writes 512 contiguous bytes. It finds the window of its first record
// r = 2c, i = r / width, and the offset j = r - i * width, reads starts[i]
// (neighbouring threads share it: an L1 hit), issues both record loads
// before any branch that stores, and stores the chunk as one 16-byte int4.
// The two records of a chunk may lie in two windows (odd widths, window
// ends): the second then opens window i + 1 at offset 0, with no other
// special case. Every lane works at every width, and an SM's 2,048
// resident threads hold 16 bytes of records in flight each, 32 KB, above
// the 18 KB needed.
//
// What was measured on the H100 (PERF.md section 6). One chunk a thread:
// with K chunks a thread (all 2K loads before the first store) K = 2, 4
// and 8 hold more bytes a thread but, at 36, 50 and 70 registers, fewer
// threads an SM, and K = 1 was the fastest or within 2.2 % at every
// main-path shape. The window by a division in the kernel: a multiplier
// computed on the host (umulhi) was at most 0.07 us or 2.5 % faster, for
// two more arguments. Both loads before any branch: written with an early
// exit for the odd trailing record between the two loads, the kernel was
// 0.2 us slower at the launch-bound shapes. A 16-byte load of a pair that
// lies in one window at an aligned address was not tried: without it the
// large shapes run at 70-98 % of their byte bound.
//
// Checks: a device-side assert stops a start outside [0, rows - width] (the
// windows of both records are checked, one assert a thread), as the gather
// + segment-sum kernel asserts its CSR; it costs no synchronise with the
// host and surfaces as "device-side assert triggered" at the caller's next
// synchronise. Offsets into packed are 64-bit; the wrapper keeps M * width
// below 2^31, so record and chunk indices fit 32 bits.

#undef NDEBUG  // the checks stay in whatever the build flags say
#include <cassert>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_rows_fetch_kernel(const int2* __restrict__ packed, const int32_t* __restrict__ starts,
                         int4* __restrict__ out, unsigned total, unsigned width,
                         unsigned max_start) {
  const unsigned c = blockIdx.x * kThreads + threadIdx.x;  // this thread's chunk
  const unsigned r = 2u * c;                                // its first record
  const bool first = r < total, second = r + 1 < total;    // the records it has
  int s0 = 0, s1 = 0;
  unsigned j0 = 0, j1 = 0;
  if (first) {
    const unsigned i = r / width;
    j0 = r - i * width;
    const unsigned next = j0 + 1 == width;  // the second record opens window i + 1
    j1 = next ? 0u : j0 + 1;
    s0 = __ldg(starts + i);
    if (second) s1 = __ldg(starts + i + next);
  }
  // Unsigned: a negative start compares above max_start.
  bool in_table = true;
  if (first) in_table &= static_cast<unsigned>(s0) <= max_start;
  if (second) in_table &= static_cast<unsigned>(s1) <= max_start;
  assert(in_table);
  int2 a = {}, b = {};
  if (first) a = __ldg(packed + (static_cast<int64_t>(s0) + j0));
  if (second) b = __ldg(packed + (static_cast<int64_t>(s1) + j1));
  if (second) {
    out[c] = make_int4(a.x, a.y, b.x, b.y);
  } else if (first) {
    reinterpret_cast<int2*>(out)[r] = a;  // the odd trailing record
  }
}

}  // namespace

// C entry for ctypes. packed has num_records records of two int32 (8-byte
// aligned), starts num_windows entries, out num_windows * width records
// (16-byte aligned); num_windows * width < 2^31. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int window_rows_fetch_i32(const int32_t* packed, const int32_t* starts, int32_t* out,
                                     int num_windows, int width, int num_records,
                                     void* stream) {
  if (num_windows <= 0) return 0;
  if (width < 1 || width > 64 || num_records < width ||
      static_cast<int64_t>(num_windows) * width >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(packed) % 8 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned total = static_cast<unsigned>(num_windows) * width;
  const unsigned chunks = (total + 1) / 2;
  window_rows_fetch_kernel<<<(chunks + kThreads - 1) / kThreads, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int2*>(packed), starts, reinterpret_cast<int4*>(out), total,
      static_cast<unsigned>(width), static_cast<unsigned>(num_records - width));
  return static_cast<int>(cudaGetLastError());
}
