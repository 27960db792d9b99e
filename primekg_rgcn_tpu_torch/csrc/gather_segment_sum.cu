// Fused row gather + sorted segment-sum over a CSR, for Hopper (sm_90a).
//
//   out[d, :] = sum_{e in [rowptr[d], rowptr[d+1])} x[src[e], :] * (scale ? scale[e] : 1)
//
// for every row d in [0, num_segments). x is the float32 [N+1, D] node table
// (its last row the zero sentinel), src the int32 source ids of one relation
// bucket in destination order, rowptr the bucket's int32 CSR row pointers,
// scale an optional float32 per-edge weight (edge-mode mean normalisation).
//
// Replaces the TPU kernel primekg_rgcn_tpu/ops/pallas/segment_sum.py:
// _segment_kernel together with the XLA row gather in front of it. That
// kernel compacted runs of equal destination ids with a one-hot matmul per
// 512-edge chunk, because the TPU has no cheap per-row scatter; its host
// schedule (_build_schedule) has no counterpart here: the CSR is the whole
// schedule, and any edge count and any D >= 1 are accepted.
//
// The same kernel serves the backward (GatherSegmentSum in
// ops/cuda/segment_sum.py, the counterpart of make_gather_segment_sum's
// custom VJP): over the bucket's transpose CSR, x is the gradient of the
// forward's output, src the edges' destinations in source order, rowptr the
// CSR over the source rows and scale the per-edge scales in that order, so
// each edge carries its output row's gradient back to its source row.
//
// Design: one warp per destination row, lanes across D (VEC floats per
// lane: float4 at D = 128, float2 at D = 64), float32 register accumulator.
// The warp loads 32 edges' (src, scale) at a time with one coalesced load
// and broadcasts them lane to lane with shuffles. Each output row is written
// exactly once (empty rows write zeros): no atomics, no pre-zeroed output,
// and the result is deterministic.
//
// Bound on the H100: memory. The function must move the node table, src,
// rowptr (and scale) once and write the output once; at the serving path's
// shapes that is 16-37 MB per launch, 4.9-11 us at 3.35 TB/s, while its
// 2*E*D float32 operations take at most 4.9 us at 67 TFLOP/s. The kernel reads
// each gathered row once per edge (E*D*4 bytes, up to 658 MB per launch,
// much of it from L2), and a hub row with 12,105 in-edges is walked by one
// warp alone; splitting long rows and asynchronous gathers are later work.
//
// Checks: device-side asserts, as PyTorch's own index kernels make them,
// stop a CSR that does not cover src (rowptr[0] != 0, rowptr[S] != E, a
// decreasing pair) or a src id outside x before any read goes astray. They
// cost no synchronise with the host; a failed one surfaces as "device-side
// assert triggered" at the caller's next synchronise.

#undef NDEBUG  // the checks stay in whatever the build flags say
#include <cassert>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void fma(T& acc, float w, const T& v) { acc += w * v; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void fma(T& acc, float w, const T& v) {
    acc.x += w * v.x;
    acc.y += w * v.y;
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void fma(T& acc, float w, const T& v) {
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
};

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

template <int VEC, bool SCALED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_segment_sum_kernel(const float* __restrict__ x,
                          const int32_t* __restrict__ src,
                          const int32_t* __restrict__ rowptr,
                          const float* __restrict__ scale,
                          float* __restrict__ out,
                          int num_segments, int d, int num_rows, int num_edges) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= num_segments) return;  // whole warp leaves together
  const int beg = rowptr[row];
  const int end = rowptr[row + 1];
  assert(0 <= beg && beg <= end && end <= num_edges);
  assert(row != 0 || beg == 0);
  assert(row != num_segments - 1 || end == num_edges);
  const int dv = d / VEC;  // row length in vectors
  const T* xv = reinterpret_cast<const T*>(x);
  T* outv = reinterpret_cast<T*>(out) + static_cast<int64_t>(row) * dv;

  for (int c0 = 0; c0 < dv; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < dv;
    T acc = V::zero();
    for (int base = beg; base < end; base += 32) {
      const int n = min(32, end - base);
      const int my_src = lane < n ? src[base + lane] : 0;
      assert(lane >= n || static_cast<unsigned>(my_src) < static_cast<unsigned>(num_rows));
      float my_w = 1.f;
      if (SCALED) my_w = lane < n ? scale[base + lane] : 0.f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int s = __shfl_sync(kFullMask, my_src, j);
        const float w = SCALED ? __shfl_sync(kFullMask, my_w, j) : 1.f;
        if (active) V::fma(acc, w, __ldg(xv + static_cast<int64_t>(s) * dv + c));
      }
    }
    if (active) outv[c] = acc;
  }
}

template <int VEC>
void launch(const float* x, const int32_t* src, const int32_t* rowptr, const float* scale,
            float* out, int num_segments, int d, int num_rows, int num_edges,
            cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (scale != nullptr) {
    gather_segment_sum_kernel<VEC, true><<<grid, block, 0, stream>>>(
        x, src, rowptr, scale, out, num_segments, d, num_rows, num_edges);
  } else {
    gather_segment_sum_kernel<VEC, false><<<grid, block, 0, stream>>>(
        x, src, rowptr, nullptr, out, num_segments, d, num_rows, num_edges);
  }
}

}  // namespace

// C entry for ctypes. x has num_rows rows, src and scale num_edges entries.
// vec must divide d (the wrapper picks it and checks the alignment of x and
// out). Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int gather_segment_sum_f32(const float* x, const int32_t* src, const int32_t* rowptr,
                                      const float* scale, float* out, int num_segments, int d,
                                      int num_rows, int num_edges, int vec, void* stream) {
  if (num_segments <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: launch<4>(x, src, rowptr, scale, out, num_segments, d, num_rows, num_edges, s); break;
    case 2: launch<2>(x, src, rowptr, scale, out, num_segments, d, num_rows, num_edges, s); break;
    case 1: launch<1>(x, src, rowptr, scale, out, num_segments, d, num_rows, num_edges, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
