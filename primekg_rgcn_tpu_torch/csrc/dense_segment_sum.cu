// Dense-output sorted segment-sum over batch-dynamic ids, for Hopper (sm_90a).
//
//   out[s, :] = sum_{i : ids[i] == s} msg[i, :]   for every s in [0, N)
//
// msg is float32 or bfloat16 [L, D], ids int32 [L] non-decreasing; ids >= N
// drop; out is float32 either way. In the sampled training step, msg is the
// identity block's cotangent rows gathered into id order and ids the sorted
// raw id stream, whose tail is one long run of the sentinel id N (29 % of the
// main path's 774,400 rows). Under bf16 compute the cotangents are bf16
// (entry dense_sorted_segment_sum_bf16): each row is widened to float32 in
// registers and every run is summed in float32, as the TPU kernel summed
// bf16 rows by a one-hot matmul with float32 accumulation.
//
// Replaces the TPU kernel primekg_rgcn_tpu/ops/pallas/segment_sum.py:
// _dense_seg_kernel (reached through dense_sorted_segment_sum). That kernel
// walked a device-built (tile, chunk) pair schedule (_dense_pairs) in grid
// order, compacting each 512-row chunk into its 512-row output tile with a
// one-hot matmul and carrying the tile in VMEM from one grid step to the
// next. Blocks on Hopper run in no order and carry nothing, so here no
// schedule exists: each block finds run boundaries in its own rows.
//
// Design: a block of 8 warps takes a chunk of 256 rows and owns the runs that
// start in it (one id per thread; ballots compact the run starts). It reads on
// past the chunk's end only for its last run, whose end it finds by a binary
// search over the sorted ids, so no block ever walks the sentinel run: a run
// of ids >= N is summed by nobody. Each owned run is written once, and the
// rows of ids that no run carries (the gap before each run, and the tail
// after the last real run) are written as zeros by the run's owner: no
// atomics, no pre-zeroed output, and a deterministic order. Runs of up to 64
// rows go to one warp each, lanes across D (VEC floats per lane: float4 at
// D = 128, float2 at D = 64), float32 accumulator in registers; a longer run
// (the main path's longest is 2,170 rows) is split across the block's 8
// warps, whose partial sums meet in shared memory in a fixed order.
//
// Bound on the H100: memory. The function must read the rows of real ids and
// all ids once and write the output once: at the main path's shape
// (L = 774,400, D = 64, N = 30,926) about 141.5 MB + 3.1 MB + 7.9 MB, about
// 45 us at 3.35 TB/s; its L*D float32 additions take under 1 us at 67 TFLOP/s.
// bf16 rows halve the first term: about 24 us.
//
// Checks: device-side asserts stop ids that decrease between neighbours or
// start below 0. They cost no synchronise with the host; a failed one
// surfaces as "device-side assert triggered" at the caller's next
// synchronise.

#undef NDEBUG  // the checks stay in whatever the build flags say
#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& acc, const T& v) { acc += v; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void add(T& acc, const T& v) {
    acc.x += v.x;
    acc.y += v.y;
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void add(T& acc, const T& v) {
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
};

// What a lane loads from a table of Tin rows: VEC elements as one Raw value,
// widened to the float32 accumulator Vec<VEC>::T.
template <typename Tin, int VEC>
struct Row {  // float32 rows load as the accumulator's type
  using Raw = typename Vec<VEC>::T;
  static __device__ __forceinline__ Raw widen(Raw v) { return v; }
};
// A bf16 is the high half of the float32 with the same value; of two bf16
// in one 32-bit word the first is in the low half.
template <>
struct Row<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float widen(Raw v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
};
template <>
struct Row<__nv_bfloat16, 2> {
  using Raw = uint32_t;
  static __device__ __forceinline__ float2 widen(Raw v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  }
};
template <>
struct Row<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ float4 widen(Raw v) {
    const float2 a = Row<__nv_bfloat16, 2>::widen(v.x);
    const float2 b = Row<__nv_bfloat16, 2>::widen(v.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = kThreads;  // rows per block: one id per thread
constexpr int kLongRun = 64;      // longer runs are split across the block's warps
constexpr unsigned kFullMask = 0xffffffffu;

// First index in [lo, hi) whose id exceeds key (hi when none does).
__device__ __forceinline__ int first_above(const int32_t* __restrict__ ids, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(ids + mid) > key) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// One warp writes zeros into output rows [lo, hi).
template <int VEC>
__device__ __forceinline__ void zero_rows(typename Vec<VEC>::T* outv, int64_t lo, int64_t hi,
                                          int dv, int lane) {
  const int64_t n = (hi - lo) * dv;
  typename Vec<VEC>::T* p = outv + lo * dv;
  for (int64_t c = lane; c < n; c += 32) p[c] = Vec<VEC>::zero();
}

template <typename Tin, int VEC>
__global__ void __launch_bounds__(kThreads)
dense_segment_sum_kernel(const Tin* __restrict__ msg, const int32_t* __restrict__ ids,
                         float* __restrict__ out, int num_rows, int d, int num_segments) {
  using V = Vec<VEC>;
  using T = typename V::T;
  using R = Row<Tin, VEC>;
  __shared__ int s_start[kChunk];  // owned run starts, ascending
  __shared__ int s_end[kChunk];    // their ends (== start for the sentinel run)
  __shared__ int s_warp_count[kWarps];
  __shared__ T s_part[kWarps][32];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int c0 = blockIdx.x * kChunk;
  const int c1 = min(c0 + kChunk, num_rows);
  const int dv = d / VEC;
  const typename R::Raw* msgv = reinterpret_cast<const typename R::Raw*>(msg);
  T* outv = reinterpret_cast<T*>(out);

  // 1. Owned run starts: a row whose id differs from its predecessor's, when
  //    that predecessor is a real id (after the first id >= N every run is a
  //    sentinel run, which nobody sums; the first one zeros the tail).
  const int i = c0 + t;
  bool owned = false;
  if (i < c1) {
    const int id = __ldg(ids + i);
    if (i == 0) {
      assert(id >= 0);
      owned = true;
    } else {
      const int prev = __ldg(ids + i - 1);
      assert(prev <= id);
      owned = prev != id && prev < num_segments;
    }
  }
  const unsigned ballot = __ballot_sync(kFullMask, owned);
  if (lane == 0) s_warp_count[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, count = 0;
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? s_warp_count[w] : 0;
    count += s_warp_count[w];
  }
  if (owned) s_start[base + __popc(ballot & ((1u << lane) - 1u))] = i;
  __syncthreads();

  // 2. Run ends. Every row of the last owned run up to the chunk's end has
  //    its id, so only that run searches past the chunk.
  if (t < count) {
    const int start = s_start[t];
    const int key = __ldg(ids + start);
    int end = start;
    if (key < num_segments) {
      end = t + 1 < count ? s_start[t + 1] : first_above(ids, c1, num_rows, key);
    }
    s_end[t] = end;
  }
  __syncthreads();

  // 3. One warp per run: zeros for the ids no run carries, then the sum of a
  //    short run.
  for (int j = warp; j < count; j += kWarps) {
    const int start = s_start[j];
    const int end = s_end[j];
    const int key = __ldg(ids + start);
    const int prev = start > 0 ? __ldg(ids + start - 1) : -1;
    zero_rows<VEC>(outv, prev + 1, min(key, num_segments), dv, lane);
    if (key >= num_segments) continue;
    if (end == num_rows) zero_rows<VEC>(outv, key + 1, num_segments, dv, lane);
    if (end - start > kLongRun) continue;  // step 4
    for (int cb = 0; cb < dv; cb += 32) {
      const int c = cb + lane;
      if (c >= dv) break;
      T acc = V::zero();
#pragma unroll 8
      for (int r = start; r < end; ++r) {
        V::add(acc, R::widen(__ldg(msgv + static_cast<int64_t>(r) * dv + c)));
      }
      outv[static_cast<int64_t>(key) * dv + c] = acc;
    }
  }

  // 4. Long runs: all warps take every 8th row, then add the 8 partial sums
  //    in warp order. The loop condition is the same for every thread.
  for (int j = 0; j < count; ++j) {
    const int start = s_start[j];
    const int end = s_end[j];
    if (end - start <= kLongRun) continue;
    const int key = __ldg(ids + start);
    for (int cb = 0; cb < dv; cb += 32) {
      const int c = cb + lane;
      T acc = V::zero();
      if (c < dv) {
#pragma unroll 8
        for (int r = start + warp; r < end; r += kWarps) {
          V::add(acc, R::widen(__ldg(msgv + static_cast<int64_t>(r) * dv + c)));
        }
      }
      s_part[warp][lane] = acc;
      __syncthreads();
      if (warp == 0 && c < dv) {
        T sum = s_part[0][lane];
        for (int w = 1; w < kWarps; ++w) V::add(sum, s_part[w][lane]);
        outv[static_cast<int64_t>(key) * dv + c] = sum;
      }
      __syncthreads();
    }
  }
}

template <typename Tin>
int launch(const Tin* msg, const int32_t* ids, float* out, int num_rows, int d,
           int num_segments, int vec, void* stream) {
  if (num_rows <= 0 || num_segments <= 0) return 0;
  const dim3 grid((num_rows + kChunk - 1) / kChunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4:
      dense_segment_sum_kernel<Tin, 4><<<grid, kThreads, 0, s>>>(msg, ids, out, num_rows, d,
                                                                 num_segments);
      break;
    case 2:
      dense_segment_sum_kernel<Tin, 2><<<grid, kThreads, 0, s>>>(msg, ids, out, num_rows, d,
                                                                 num_segments);
      break;
    case 1:
      dense_segment_sum_kernel<Tin, 1><<<grid, kThreads, 0, s>>>(msg, ids, out, num_rows, d,
                                                                 num_segments);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries for ctypes, one per row type. msg has num_rows rows of d
// elements, ids num_rows entries, out num_segments rows of d floats. vec
// (elements per lane: 1, 2 or 4) must divide d (the wrapper picks it and
// checks the alignment of msg and out). Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int dense_sorted_segment_sum_f32(const float* msg, const int32_t* ids, float* out,
                                            int num_rows, int d, int num_segments, int vec,
                                            void* stream) {
  return launch(msg, ids, out, num_rows, d, num_segments, vec, stream);
}

extern "C" int dense_sorted_segment_sum_bf16(const __nv_bfloat16* msg, const int32_t* ids,
                                             float* out, int num_rows, int d, int num_segments,
                                             int vec, void* stream) {
  return launch(msg, ids, out, num_rows, d, num_segments, vec, stream);
}
