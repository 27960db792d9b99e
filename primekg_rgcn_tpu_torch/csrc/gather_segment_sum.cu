// Fused row gather + sorted segment-sum over a CSR, for Hopper (sm_90a).
//
//   out[d, :] = sum_{e in [rowptr[d], rowptr[d+1])} x[src[e], :] * (scale ? scale[e] : 1)
//
// for every row d in [0, num_segments). x is the [N+1, D] node table (its
// last row the zero sentinel), float32 or bfloat16; src the int32 source ids
// of one relation bucket in destination order, rowptr the bucket's int32 CSR
// row pointers, scale an optional float32 per-edge weight (edge-mode mean
// normalisation). The sum and the output are float32 for either table.
//
// The bfloat16 table (entry gather_segment_sum_bf16) is the bf16 compute
// mode's: the TPU kernel with mxu_dtype bfloat16 took bf16 rows and summed
// them in float32 (segment_sum.py:326-329), so here each gathered row is
// widened to float32 in registers and the carries, fix-up and output stay
// float32. With a scale, each product w * v is rounded to bf16 before it is
// added, as the TPU path rounded its float32 messages to bf16 on the way into
// the one-hot matmul (rgcn_segment.py:163, segment_sum.py:328).
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
// Options, for the stacked relation transform (ops/rgcn_segment.py), whose
// buckets write column blocks of one [N+1, R*D] buffer and read them back:
// - x_stride and out_stride: the row strides of the table and the output
//   (elements), so that either may be a column block of a wider buffer;
// - row_scale: a float32 weight per table row, w = row_scale[src[e]], used
//   as a per-edge scale is (the dense-mode backward's 1/in-degree of each
//   gathered destination); at most one of scale and row_scale is given;
// - seg_scale: a float32 factor per output row, applied to the row's whole
//   float32 sum, rounded once (the dense-mode forward's mean, the same
//   product as the sum followed by a multiply).
// They are a template parameter (OPTS) of both kernels: a call that sets
// none runs instances compiled without them, the kernels as they were
// before the options, whose registers the options would spill.
//
// Design: the work is split by edges, not by rows. The S row ends merged
// with the E edges form one sequence of S + E items (a row's end comes
// after its edges); a merge-path partition cuts it into pieces of equal
// length, one warp each (ops/cuda/segment_sum.piece_plan sizes them to fill
// one wave). A warp finds its piece's first (row, edge) itself, by a search
// of rowptr in rounds of 32 probes, one per lane, so no host schedule is
// needed, and a hub row of 12,105 edges is walked by dozens of warps at
// once: a launch's time follows its item count, not its longest row.
//
// In its piece a warp walks the edges in batches of 32: one coalesced load
// of their src (and scale), then the rows they gather, kUnroll loads per
// lane group issued before any add. `lanes` lanes share a row (16 bytes
// each where D % 4 == 0 and the tables are aligned), so a warp gathers
// 32 / lanes rows per instruction: one at D = 128, two at D = 64 (a
// half-warp each, their partial sums combined by shuffles when the row
// closes). A bf16 table is read 4 elements (8 bytes) a lane, so its lanes
// and groups are the float32 table's: 16-byte loads of 8 bf16 spilled at
// the 64-register cap of __launch_bounds__(256, 4) and ran 1.44x slower
// than the float32 kernel at the main path's shapes (PERF.md, PR 8). Rows
// wider than 32 vectors are walked in column chunks.
// After each edge the warp closes every row whose end it has reached
// (empty rows too, written as zeros); the row pointers come 31 at a time
// from one coalesced load into a lane window. The rows come straight into
// registers: a cp.async ring through shared memory measured up to 1.4x
// slower at the gene-gene bucket (PERF.md §6).
//
// Deterministic, without float atomics: a row that lies wholly in one piece
// is written once, directly. A piece that ends inside a row writes its
// partial sum to a scratch carry buffer (the wrapper's, one [D] slot per
// piece); the piece that reaches the row's end writes its own part, and a
// second launch, gather_segment_sum_fixup_kernel, adds the row's carries
// into it in piece order (and applies seg_scale to the whole sum), one warp
// per row that has carries. The partition depends only on S, E and the
// card's SM count, so two launches on the same inputs add in the same order
// and give the same bits.
//
// Bound on the H100: memory. The function must move the node table, src,
// rowptr (and scale) once and write the output once; at the serving path's
// shapes that is 16-37 MB per launch, 4.9-11 us at 3.35 TB/s, while its
// 2*E*D float32 operations take at most 4.9 us at 67 TFLOP/s
// (chip_smoke.bound counts both). The gather itself reads each source row
// once per edge, E*D*4 bytes (up to 658 MB per launch at the gene-gene
// bucket, D = 128): the 8-16 MB table stays in the 50 MB L2, so in practice
// the kernel is bound by the rate at which the SMs can pull rows from L2,
// and the design keeps every SM's warps busy with equal shares of them. A
// bf16 table halves both the table and those pulls (E*D*2 bytes).
//
// Checks: device-side asserts, as PyTorch's own index kernels make them,
// stop a CSR that does not cover src (rowptr[0] != 0, rowptr[S] != E, a
// value outside [0, E], a decreasing pair) or a src id outside x before any
// read goes astray. They cost no synchronise with the host; a failed one
// surfaces as "device-side assert triggered" at the caller's next
// synchronise.

#undef NDEBUG  // the checks stay in whatever the build flags say
#include <cassert>
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;         // row loads a lane group issues before it adds
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void fma_to(float& a, float w, float v) { a += w * v; }
__device__ __forceinline__ void fma_to(float2& a, float w, float2 v) {
  a.x += w * v.x;
  a.y += w * v.y;
}
__device__ __forceinline__ void fma_to(float4& a, float w, float4 v) {
  a.x += w * v.x;
  a.y += w * v.y;
  a.z += w * v.z;
  a.w += w * v.w;
}
__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(kFullMask, v, m);
}
__device__ __forceinline__ float2 shfl_xor(float2 v, int m) {
  return make_float2(shfl_xor(v.x, m), shfl_xor(v.y, m));
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int m) {
  return make_float4(shfl_xor(v.x, m), shfl_xor(v.y, m), shfl_xor(v.z, m), shfl_xor(v.w, m));
}
// v * s, each product rounded on its own (never fused into a later add).
__device__ __forceinline__ float scaled(float v, float s) { return __fmul_rn(v, s); }
__device__ __forceinline__ float2 scaled(float2 v, float s) {
  return make_float2(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
}
__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s), __fmul_rn(v.w, s));
}

// The float32 accumulator of VEC elements.
template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

// What a lane loads from a table of Tin rows: VEC elements as one Raw value,
// and how they join the float32 accumulator.
template <typename Tin, int VEC>
struct Row;
// float32 rows load straight into the accumulator's type.
template <int VEC>
struct FloatRow {
  using Raw = typename Vec<VEC>::T;
  static __device__ __forceinline__ Raw zero() { return Vec<VEC>::zero(); }
  template <bool SCALED>
  static __device__ __forceinline__ void accumulate(Raw& acc, float w, Raw v) {
    fma_to(acc, w, v);
  }
};
template <>
struct Row<float, 1> : FloatRow<1> {};
template <>
struct Row<float, 2> : FloatRow<2> {};
template <>
struct Row<float, 4> : FloatRow<4> {};

// bf16 rows: widened to float32 in registers; a scaled product is rounded to
// bf16 (round to nearest even) before the float32 add.
__device__ __forceinline__ float bf16_term(float w, float v, bool scaled) {
  return scaled ? __bfloat162float(__float2bfloat16_rn(__fmul_rn(w, v))) : v;
}
// Two bf16 in one 32-bit word (the first in the low half) as float32: a bf16
// is the high half of the float32 with the same value.
__device__ __forceinline__ float2 widen2(uint32_t bits) {
  return make_float2(__uint_as_float(bits << 16), __uint_as_float(bits & 0xffff0000u));
}
template <>
struct Row<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw zero() { return 0; }
  template <bool SCALED>
  static __device__ __forceinline__ void accumulate(float& acc, float w, Raw v) {
    acc += bf16_term(w, __uint_as_float(static_cast<uint32_t>(v) << 16), SCALED);
  }
};
template <>
struct Row<__nv_bfloat16, 2> {
  using Raw = uint32_t;
  static __device__ __forceinline__ Raw zero() { return 0; }
  template <bool SCALED>
  static __device__ __forceinline__ void accumulate(float2& acc, float w, Raw v) {
    const float2 f = widen2(v);
    acc.x += bf16_term(w, f.x, SCALED);
    acc.y += bf16_term(w, f.y, SCALED);
  }
};
template <>
struct Row<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw zero() { return make_uint2(0, 0); }
  template <bool SCALED>
  static __device__ __forceinline__ void accumulate(float4& acc, float w, Raw v) {
    float2 a = make_float2(acc.x, acc.y), b = make_float2(acc.z, acc.w);
    Row<__nv_bfloat16, 2>::accumulate<SCALED>(a, w, v.x);
    Row<__nv_bfloat16, 2>::accumulate<SCALED>(b, w, v.y);
    acc = make_float4(a.x, a.y, b.x, b.y);
  }
};

// The sum of v over the lane groups: lanes that differ only in the bits at
// and above LANES hold partial sums of one row's columns.
template <int LANES, typename T>
__device__ __forceinline__ T sum_groups(T v) {
#pragma unroll
  for (int m = LANES; m < 32; m <<= 1) add_to(v, shfl_xor(v, m));
  return v;
}

// The merge-path search: how many row ends come before item `diag` of the
// merged sequence, i.e. the least i in [max(0, diag - E), min(diag, S)]
// with rowptr[i + 1] + i >= diag (that sum rises with i). The whole warp
// probes 32 points a round, so 31k rows take three rounds of loads.
__device__ __forceinline__ int merge_path_rows(const int32_t* __restrict__ rowptr, int diag,
                                               int num_segments, int num_edges, int lane) {
  int lo = max(0, diag - num_edges);
  int hi = min(diag, num_segments);
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const bool valid = p < hi;
    const unsigned after = __ballot_sync(kFullMask, valid && rowptr[p + 1] + p >= diag);
    if (after & 1u) break;  // the answer is lo
    const int k = after ? __ffs(after) - 1 : __popc(__ballot_sync(kFullMask, valid));
    // Probe k - 1 is before the diagonal, probe k (when there is one) not.
    hi = after ? lo + k * step : hi;
    lo += (k - 1) * step + 1;
  }
  return lo;
}

// Lane l's rowptr[base + l] (INT_MAX past rowptr's end), with the CSR's
// range and order checked over the window.
__device__ __forceinline__ int load_window(const int32_t* __restrict__ rowptr, int base,
                                           int num_segments, int num_edges, int lane) {
  const int i = base + lane;
  const int v = i <= num_segments ? rowptr[i] : INT_MAX;
  const int prev = __shfl_up_sync(kFullMask, v, 1);
  assert(i > num_segments || (0 <= v && v <= num_edges));
  assert(lane == 0 || i > num_segments || prev <= v);
  return v;
}

template <typename Tin, int VEC, int LANES, bool SCALED, bool OPTS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
gather_segment_sum_kernel(const Tin* __restrict__ x, const int32_t* __restrict__ src,
                          const int32_t* __restrict__ rowptr, const float* __restrict__ scale,
                          const float* __restrict__ row_scale,
                          const float* __restrict__ seg_scale, float* __restrict__ out,
                          float* __restrict__ carry, int32_t* __restrict__ carry_row,
                          int num_segments, int d, int num_rows, int num_edges,
                          int x_stride, int out_stride, int items_per_piece,
                          int num_pieces) {
  using T = typename Vec<VEC>::T;
  using R = Row<Tin, VEC>;
  constexpr int kGroups = 32 / LANES;  // rows one load instruction gathers
  constexpr int kSteps = LANES;        // load steps per batch of 32 edges
  constexpr int kBatch = kSteps < kUnroll ? kSteps : kUnroll;
  const int piece = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (piece >= num_pieces) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int group = lane / LANES;
  const int diag0 = piece * items_per_piece;
  const int diag1 = min(diag0 + items_per_piece, num_segments + num_edges);
  const int r0 = merge_path_rows(rowptr, diag0, num_segments, num_edges, lane);
  const int r1 = merge_path_rows(rowptr, diag1, num_segments, num_edges, lane);
  const int e0 = diag0 - r0;
  const int e1 = diag1 - r1;
  assert(r0 <= r1 && e0 <= e1);
  assert(piece != 0 || rowptr[0] == 0);
  assert(piece != num_pieces - 1 || rowptr[num_segments] == num_edges);
  const int dv = d / VEC;  // row length in vectors
  // Row strides in vectors: without options the rows are contiguous.
  const int xs = OPTS ? x_stride / VEC : dv;
  const int os = OPTS ? out_stride / VEC : dv;
  const typename R::Raw* xv = reinterpret_cast<const typename R::Raw*>(x);
  T* outv = reinterpret_cast<T*>(out);

  for (int c0 = 0; c0 < dv; c0 += LANES) {
    const int c = c0 + lane % LANES;
    const bool active = c < dv;
    int wbase = r0;  // lane l of wnd holds rowptr[wbase + l]
    int wnd = load_window(rowptr, wbase, num_segments, num_edges, lane);
    // Row r0 began in an earlier piece when its first edge lies before e0:
    // its part here is stored unscaled, and the fix-up scales the whole sum.
    const bool r0_carried = OPTS && __shfl_sync(kFullMask, wnd, 0) < e0;
    int row = r0;
    int row_end = __shfl_sync(kFullMask, wnd, 1);
    int open_from = e0;  // first edge of the open row's part in this piece
    T acc = Vec<VEC>::zero();

    // Close every row of this piece whose end lies at `consumed` edges.
    auto close_rows = [&](int consumed) {
      while (row < r1 && row_end == consumed) {
        const T sum = sum_groups<LANES>(acc);
        if (group == 0 && active)
          outv[static_cast<int64_t>(row) * os + c] =
              OPTS && seg_scale != nullptr && !(row == r0 && r0_carried)
                  ? scaled(sum, seg_scale[row])
                  : sum;
        acc = Vec<VEC>::zero();
        open_from = consumed;
        if (++row - wbase == 31) {
          wbase = row;
          wnd = load_window(rowptr, wbase, num_segments, num_edges, lane);
        }
        row_end = __shfl_sync(kFullMask, wnd, row - wbase + 1);
      }
    };

    close_rows(e0);
    for (int base = e0; base < e1; base += 32) {
      const int nb = min(32, e1 - base);
      int my_src = 0;
      float my_w = 1.f;
      if (lane < nb) {
        my_src = src[base + lane];
        assert(static_cast<unsigned>(my_src) < static_cast<unsigned>(num_rows));
        if (SCALED) my_w = OPTS && row_scale != nullptr ? row_scale[my_src] : scale[base + lane];
      }
      const int used = (nb + kGroups - 1) / kGroups;  // load steps the batch needs
      for (int s0 = 0; s0 < used; s0 += kBatch) {
        typename R::Raw v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int j = (s0 + k) * kGroups + group;
          const int s = __shfl_sync(kFullMask, my_src, j);
          v[k] = (active && j < nb) ? __ldg(xv + static_cast<int64_t>(s) * xs + c) : R::zero();
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const int j = (s0 + k) * kGroups + g;
            if (j < nb) {
              const float w = SCALED ? __shfl_sync(kFullMask, my_w, j) : 1.f;
              if (group == g) R::template accumulate<SCALED>(acc, w, v[k]);
              close_rows(base + j + 1);
            }
          }
        }
      }
    }

    // The row the piece ends in, if it holds edges of it: its carry.
    const bool has_carry = r1 < num_segments && e1 > open_from;
    if (c0 == 0 && lane == 0) carry_row[piece] = has_carry ? r1 : -1;
    if (has_carry) {
      const T sum = sum_groups<LANES>(acc);
      if (group == 0 && active)
        reinterpret_cast<T*>(carry)[static_cast<int64_t>(piece) * dv + c] = sum;
    }
  }
}

// Adds the carries of every row that crosses pieces into the part that the
// row's last piece wrote, in piece order, then applies seg_scale to the
// row's whole sum: one warp per run of pieces that carry into the same row
// (the run's first piece leads).
template <int VEC, bool OPTS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_segment_sum_fixup_kernel(float* __restrict__ out, const float* __restrict__ carry,
                                const int32_t* __restrict__ carry_row,
                                const float* __restrict__ seg_scale, int d, int out_stride,
                                int num_pieces) {
  using T = typename Vec<VEC>::T;
  const int piece = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (piece >= num_pieces) return;
  const int row = carry_row[piece];
  if (row < 0 || (piece > 0 && carry_row[piece - 1] == row)) return;
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (;;) {
    const int p = piece + count + lane;
    const unsigned other = __ballot_sync(kFullMask, p >= num_pieces || carry_row[p] != row);
    if (other) {
      count += __ffs(other) - 1;
      break;
    }
    count += 32;
  }
  const int dv = d / VEC;
  const T* cv = reinterpret_cast<const T*>(carry) + static_cast<int64_t>(piece) * dv;
  T* ov = reinterpret_cast<T*>(out) + static_cast<int64_t>(row) * (OPTS ? out_stride / VEC : dv);
  for (int c = lane; c < dv; c += 32) {
    T sum = Vec<VEC>::zero();
    int i = 0;
    for (; i + kUnroll <= count; i += kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) v[k] = cv[static_cast<int64_t>(i + k) * dv + c];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) add_to(sum, v[k]);
    }
    for (; i < count; ++i) add_to(sum, cv[static_cast<int64_t>(i) * dv + c]);
    T o = ov[c];
    add_to(o, sum);
    ov[c] = OPTS && seg_scale != nullptr ? scaled(o, seg_scale[row]) : o;
  }
}

template <typename Tin>
struct Args {
  const Tin* x;
  const int32_t* src;
  const int32_t* rowptr;
  const float* scale;
  const float* row_scale;
  const float* seg_scale;
  float* out;
  float* carry;
  int32_t* carry_row;
  int num_segments, d, num_rows, num_edges, x_stride, out_stride, items_per_piece, num_pieces;
  cudaStream_t stream;
};

template <typename Tin, int VEC, int LANES, bool OPTS>
int launch_instances(const Args<Tin>& a) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((a.num_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (a.scale != nullptr || a.row_scale != nullptr) {
    gather_segment_sum_kernel<Tin, VEC, LANES, true, OPTS><<<grid, block, 0, a.stream>>>(
        a.x, a.src, a.rowptr, a.scale, a.row_scale, a.seg_scale, a.out, a.carry, a.carry_row,
        a.num_segments, a.d, a.num_rows, a.num_edges, a.x_stride, a.out_stride,
        a.items_per_piece, a.num_pieces);
  } else {
    gather_segment_sum_kernel<Tin, VEC, LANES, false, OPTS><<<grid, block, 0, a.stream>>>(
        a.x, a.src, a.rowptr, nullptr, nullptr, a.seg_scale, a.out, a.carry, a.carry_row,
        a.num_segments, a.d, a.num_rows, a.num_edges, a.x_stride, a.out_stride,
        a.items_per_piece, a.num_pieces);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gather_segment_sum_fixup_kernel<VEC, OPTS><<<grid, block, 0, a.stream>>>(
      a.out, a.carry, a.carry_row, a.seg_scale, a.d, a.out_stride, a.num_pieces);
  return cudaGetLastError();
}

// The instances with the options only where the call sets one.
template <typename Tin, int VEC, int LANES>
int launch(const Args<Tin>& a) {
  const bool opts = a.row_scale != nullptr || a.seg_scale != nullptr || a.x_stride != a.d ||
                    a.out_stride != a.d;
  return opts ? launch_instances<Tin, VEC, LANES, true>(a)
              : launch_instances<Tin, VEC, LANES, false>(a);
}

template <typename Tin, int VEC>
int launch_lanes(int lanes, const Args<Tin>& a) {
  switch (lanes) {
    case 32: return launch<Tin, VEC, 32>(a);
    case 16: return launch<Tin, VEC, 16>(a);
    case 8: return launch<Tin, VEC, 8>(a);
    case 4: return launch<Tin, VEC, 4>(a);
    case 2: return launch<Tin, VEC, 2>(a);
    case 1: return launch<Tin, VEC, 1>(a);
    default: return -1;
  }
}

}  // namespace

// C entries for ctypes, one per table type, each in a build of its own:
// with -DB1_TABLE_BF16 this file exports gather_segment_sum_bf16, else
// gather_segment_sum_f32 (ops/cuda/segment_sum.LIBRARY and LIBRARY_BF16),
// so that the two sets of kernel instances compile in parallel. x has
// num_rows rows of x_stride elements, out num_segments rows of out_stride
// floats; src, and scale, num_edges entries; row_scale num_rows and
// seg_scale num_segments floats; each of scale, row_scale and seg_scale may
// be null (scale and row_scale not both). vec (elements per lane: 1, 2 or
// 4) must divide d and both strides, and lanes be a power of two up to 32
// (the wrapper picks both, ops/cuda/segment_sum.b1_width, and checks the
// alignment of x and out); carry holds num_pieces * d floats and carry_row
// num_pieces ints of scratch (ops/cuda/segment_sum.piece_plan).
// Launches the kernel and its fix-up on `stream` and allocates nothing.
// Returns cudaGetLastError() after each launch (0 when both were accepted),
// or -1 for a vec or lanes it does not take.
#ifndef B1_TABLE_BF16
using Table = float;
#define B1_ENTRY gather_segment_sum_f32
#else
using Table = __nv_bfloat16;
#define B1_ENTRY gather_segment_sum_bf16
#endif
extern "C" int B1_ENTRY(const Table* x, const int32_t* src, const int32_t* rowptr,
                        const float* scale, const float* row_scale, const float* seg_scale,
                        float* out, float* carry, int32_t* carry_row, int num_segments,
                        int d, int num_rows, int num_edges, int x_stride, int out_stride,
                        int vec, int lanes, int items_per_piece, int num_pieces,
                        void* stream) {
  if (num_segments <= 0) return 0;
  const Args<Table> a{x, src, rowptr, scale, row_scale, seg_scale, out, carry, carry_row,
                      num_segments, d, num_rows, num_edges, x_stride, out_stride,
                      items_per_piece, num_pieces, static_cast<cudaStream_t>(stream)};
  switch (vec) {
    case 4: return launch_lanes<Table, 4>(lanes, a);
    case 2: return launch_lanes<Table, 2>(lanes, a);
    case 1: return launch_lanes<Table, 1>(lanes, a);
    default: return -1;
  }
}
