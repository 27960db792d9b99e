// Dense-output sorted segment-sum over batch-dynamic ids, for Hopper (sm_90a).
//
//   out[s, :] = sum_{i : ids[i] == s} msg[i, :]   for every s in [0, N)
//
// msg is float32 or bfloat16 [L, D], ids int32 [L] non-decreasing; ids >= N
// drop; out is float32 either way. A bf16 row is widened to float32 in
// registers and every run is summed in float32, as the TPU kernel summed
// bf16 rows by a one-hot matmul with float32 accumulation. The source is
// built twice, one row type each (ops/cuda/dense_segment_sum.LIBRARY and
// LIBRARY_BF16: with -DB2_ROWS_BF16 it exports dense_sorted_segment_sum_bf16,
// else dense_sorted_segment_sum_f32), so that the two compile in parallel.
//
// Callers: the identity block's backward of the sampled step (the sorted raw
// id stream, whose tail is one long run of the sentinel id N: 29 % of the
// main path's 774,400 rows), the dedup and table-gather backwards
// (data/sampling._sorted_accumulate: a fill run of up to 64,441 rows), and
// the batch-restricted final layer's forward segment-sum
// (ops/rgcn_final_layer, SortedSegmentSum: a relation's padding slots make
// runs of up to 9,758 rows).
//
// Replaces the TPU kernel primekg_rgcn_tpu/ops/pallas/segment_sum.py:
// _dense_seg_kernel (reached through dense_sorted_segment_sum). That kernel
// walked a device-built (tile, chunk) pair schedule (_dense_pairs) in grid
// order, compacting each 512-row chunk into its 512-row output tile with a
// one-hot matmul and carrying the tile in VMEM from one grid step to the
// next. Blocks on Hopper run in no order and carry nothing, so here no
// schedule exists.
//
// Bound on the H100: memory. The function must read the rows of real ids
// and all ids once and write the output once (chip_smoke.b2_bound): at the
// main path's shape (L = 774,400, D = 64, N = 30,926) about 141.5 MB + 3.1 MB
// + 7.9 MB, about 45 us at 3.35 TB/s; its L*D float32 additions take under
// 1 us at 67 TFLOP/s. bf16 rows halve the first term: about 24 us.
//
// Design: the work is split by rows, not by runs, so that a launch's time
// follows its real row count and not its longest run. A one-warp pre-pass
// finds L_real, the first row whose id is >= N, by a search of the sorted
// ids in rounds of 128 probes (4 a lane); nothing is read back to the
// host. The rows [0, L_real) are cut into pieces of equal length,
// ceil(L_real / P) rows and at least min_rows, one warp each; P comes from
// the host (ops/cuda/dense_segment_sum.piece_plan), from L and the SM count:
// 24 pieces a SM. No warp reads a row of the sentinel tail, and a run of
// 64,441 rows is walked by as many warps as it spans pieces, at once.
//
// In its piece a warp walks the rows in batches of 32: one coalesced load of
// their ids and of the ids one row on, whose ballot marks the rows where a
// run ends (the next batch's ids are loaded meanwhile); then the rows
// themselves, kUnroll loads a lane issued before any add, and where two
// batches' loads fit in registers (bf16 rows at D = 64) the next batch's
// rows are loaded before this batch's are added. `lanes` lanes share a row, 16 bytes each where D and the alignment
// allow it (4 float32 or 8 bf16), so a warp reads 32 / lanes rows per
// instruction: at D = 64 two float32 rows (a half-warp each) or four bf16
// rows. Lane groups hold partial sums of their own rows; where a run ends,
// shuffles add them in a fixed order and group 0 writes the sum. Rows wider
// than 32 vectors are walked in column chunks.
//
// Deterministic, without float atomics. Three launches, all named
// dense_segment_sum_*: the first writes zeros over the whole output (16
// bytes a thread, at the write rate), so that segments no run carries read 0;
// the row split then writes each run that ends in a piece once, directly, by
// that piece, with the rows it holds, and a piece that ends inside a run
// writes its partial sum to a [P, D] carry buffer (the wrapper's scratch);
// the fix-up, dense_segment_sum_fixup_kernel, adds each cut run's carries in
// piece order into the row that the run's last piece wrote (a warp a run,
// the block of 8 warps for a run of more than kWarpChain carries: 1,007 for
// the dedup stream's fill run). The partition depends only on L_real, L and
// the SM count, so two launches on the same inputs give the same bits.
//
// Why zeros by a launch of their own: written by the warp that sees an id
// jump, as the design first had it, the empty segments of the restricted
// layer's stream (89 % of its 63 MB output; a relation's empty (relation,
// node) rows make gaps of up to 4,095 rows, 2 MB) fell to a few warps and
// held the launch: 0.111-0.136 ms against index_add_'s 0.119-0.125 on the
// H100; with its big gaps split evenly across the fix-up's blocks, 0.085;
// with this zero launch, 0.053 (scripts/port_time_b2.py, PERF.md §6). On the
// streams whose segments are nearly all carried (the identity and dedup
// backwards) the zero launch costs 4.5-6 us, the output's bytes a second
// time.
//
// Checks: device-side asserts stop ids that decrease between neighbours
// (the sentinel tail's ids are read for that, its rows never) or start below
// 0. They cost no synchronise with the host; a failed one surfaces as
// "device-side assert triggered" at the caller's next synchronise.

#undef NDEBUG  // the checks stay in whatever the build flags say
#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 16;       // row loads a lane issues before it adds
constexpr int kFixupUnroll = 16;  // carry loads a lane of the fix-up issues at once
constexpr unsigned kFullMask = 0xffffffffu;

// VEC float32 values that a lane holds, kept in registers.
template <int VEC>
struct Acc {
  float v[VEC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.f;
  }
  __device__ __forceinline__ void add(const Acc& o) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] += o.v[i];
  }
  __device__ __forceinline__ void add_xor(int m) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] += __shfl_xor_sync(kFullMask, v[i], m);
  }
  // Loads and stores VEC floats at p, aligned to min(VEC, 4) floats.
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        const float4 f = *reinterpret_cast<const float4*>(p + i);
        v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
      }
    } else if constexpr (VEC == 2) {
      const float2 f = *reinterpret_cast<const float2*>(p);
      v[0] = f.x, v[1] = f.y;
    } else {
      v[0] = *p;
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *p = v[0];
    }
  }
};

// What a lane loads from a row of Tin: VEC elements as one Raw value (one
// load instruction), and how they join the float32 accumulator.
template <typename Tin, int VEC>
struct Row;
template <>
struct Row<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(Acc<4>& a, Raw r) {
    a.v[0] += r.x, a.v[1] += r.y, a.v[2] += r.z, a.v[3] += r.w;
  }
};
template <>
struct Row<float, 2> {
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ void add(Acc<2>& a, Raw r) { a.v[0] += r.x, a.v[1] += r.y; }
};
template <>
struct Row<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(Acc<1>& a, Raw r) { a.v[0] += r; }
};
// A bf16 is the high half of the float32 with the same value; of two bf16 in
// one 32-bit word the first is in the low half.
__device__ __forceinline__ void add_bf16x2(float* a, uint32_t bits) {
  a[0] += __uint_as_float(bits << 16);
  a[1] += __uint_as_float(bits & 0xffff0000u);
}
template <>
struct Row<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void add(Acc<8>& a, Raw r) {
    add_bf16x2(a.v, r.x), add_bf16x2(a.v + 2, r.y), add_bf16x2(a.v + 4, r.z),
        add_bf16x2(a.v + 6, r.w);
  }
};
template <>
struct Row<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void add(Acc<4>& a, Raw r) {
    add_bf16x2(a.v, r.x), add_bf16x2(a.v + 2, r.y);
  }
};
template <>
struct Row<__nv_bfloat16, 2> {
  using Raw = uint32_t;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  static __device__ __forceinline__ void add(Acc<2>& a, Raw r) { add_bf16x2(a.v, r); }
};
template <>
struct Row<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void add(Acc<1>& a, Raw r) {
    a.v[0] += __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
};

// The least i in [lo, hi] with ids[i] >= key (hi when none), for sorted ids.
// The whole warp probes 32 * PROBES points a round, PROBES loads a lane
// issued together: with 4, 774,400 rows take three rounds of loads.
template <int PROBES>
__device__ __forceinline__ int first_at_least(const int32_t* __restrict__ ids, int lo, int hi,
                                              int key, int lane) {
  constexpr int kProbes = 32 * PROBES;
  while (lo < hi) {
    const int step = (hi - lo + kProbes - 1) / kProbes;
    int v[PROBES];
#pragma unroll
    for (int k = 0; k < PROBES; ++k) {
      const int p = lo + (lane * PROBES + k) * step;
      v[k] = p < hi ? __ldg(ids + p) : key;  // past hi counts as a hit
    }
    int mine = PROBES;  // this lane's first probe at or above key
#pragma unroll
    for (int k = PROBES - 1; k >= 0; --k) mine = v[k] >= key ? k : mine;
    const unsigned hits = __ballot_sync(kFullMask, mine < PROBES);
    // Probes in order: lane by lane, a lane's PROBES in turn. The first at
    // or above key is probe g (one past the last probe when none is).
    const int first = hits ? __ffs(hits) - 1 : 31;
    const int g = first * PROBES + __shfl_sync(kFullMask, mine, first);
    if (g == 0) break;  // the answer is lo
    // Probe g - 1 is below key, probe g (or hi) not.
    hi = min(hi, lo + g * step);
    lo += (g - 1) * step + 1;
  }
  return lo;
}

// The rows [r0, r1) of piece `piece`: pieces of `per` rows over [0, l_real).
__device__ __forceinline__ void piece_rows(int piece, int per, int l_real, int& r0, int& r1) {
  const int64_t a = static_cast<int64_t>(piece) * per;
  r0 = static_cast<int>(a < l_real ? a : l_real);
  r1 = static_cast<int>(a + per < l_real ? a + per : l_real);
}

// The first launch: zeros over the whole output, 16 bytes a thread where
// they fit, so that the segments no run carries read 0 without a memset of
// the caller's; the row split then writes each carried segment's sum over
// its zero. Its first warp also finds L_real, the first row whose id is
// >= N, and the piece length, and leaves both in meta for the other two
// launches: a one-block pre-pass, in place of a search in every warp.
__global__ void __launch_bounds__(256)
dense_segment_sum_zero_kernel(const int32_t* __restrict__ ids, float* __restrict__ out,
                              int64_t n, int32_t* __restrict__ meta, int num_rows,
                              int num_segments, int min_rows, int num_pieces) {
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    assert(__ldg(ids) >= 0);
    const int l_real = first_at_least<4>(ids, 0, num_rows, num_segments, threadIdx.x);
    if (threadIdx.x == 0)
      meta[0] = l_real, meta[1] = max(min_rows, (l_real + num_pieces - 1) / num_pieces);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int64_t i = t; i < n / 4; i += stride) out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t i = n / 4 * 4 + t; i < n; i += stride) out[i] = 0.f;
}

constexpr int kZeroBlocks = 1024;  // the zero launch's grid, at most
constexpr int kWarpChain = 32;  // carries one fix-up warp adds alone; more go to its block

template <typename Tin, int VEC, int LANES>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 2)
dense_segment_sum_kernel(const Tin* __restrict__ msg, const int32_t* __restrict__ ids,
                         float* __restrict__ out, float* __restrict__ carry,
                         int32_t* __restrict__ meta, int num_rows, int d,
                         int num_segments, int num_pieces) {
  using R = Row<Tin, VEC>;
  constexpr int kGroups = 32 / LANES;  // rows one load instruction reads
  constexpr int kSteps = LANES;        // load steps per batch of 32 rows
  constexpr int kBatch = kSteps < kUnroll ? kSteps : kUnroll;
  constexpr unsigned kStepMask = kGroups == 32 ? kFullMask : (1u << (kGroups & 31)) - 1u;
  // A batch's loads in one round, small enough to hold a second batch's
  // beside them (bf16 rows of D = 64: 8 loads of 16 bytes a lane).
  constexpr bool kPipelined = kSteps <= kUnroll && kSteps * sizeof(typename R::Raw) <= 128;
  const int piece = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (piece >= num_pieces) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int group = lane / LANES;
  const int dv = d / VEC;  // row length in vectors

  const int l_real = meta[0], per = meta[1];
  int r0, r1;
  piece_rows(piece, per, l_real, r0, r1);

  // Row base + lane's id and the next row's (N past the last row); a run
  // ends at a row whose next id differs.
  auto load_ids = [&](int base, int& cur, int& nxt) {
    cur = 0, nxt = 0;
    if (base + lane < r1) {
      cur = __ldg(ids + base + lane);
      nxt = base + lane + 1 < num_rows ? __ldg(ids + base + lane + 1) : num_segments;
      assert(cur <= nxt);
    }
  };
  for (int c0 = 0; c0 < dv && r0 < r1; c0 += LANES) {
    const int c = c0 + lane % LANES;
    const bool active = c < dv;
    Acc<VEC> acc;
    acc.zero();
    int cur, nxt;
    load_ids(r0, cur, nxt);

    // The run that ends at row j of the batch: its sum to out.
    auto close = [&](int j) {
      Acc<VEC> sum = acc;
#pragma unroll
      for (int m = LANES; m < 32; m <<= 1) sum.add_xor(m);
      const int id = __shfl_sync(kFullMask, cur, j);
      // The bound only guards ids that break the order, which the asserts stop.
      if (group == 0 && active && static_cast<unsigned>(id) < static_cast<unsigned>(num_segments))
        sum.store(out + static_cast<int64_t>(id) * d + c * VEC);
      acc.zero();
    };
    // Load steps [s0, s0 + kBatch) of the batch of nb rows at base.
    auto load_round = [&](typename R::Raw (&v)[kBatch], int s0, int base, int nb) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = (s0 + k) * kGroups + group;
        if (active && j < nb) v[k] = R::load(msg + static_cast<int64_t>(base + j) * d + c * VEC);
      }
    };
    // Their adds, and the runs that end among their rows.
    auto add_round = [&](const typename R::Raw (&v)[kBatch], int s0, int nb, unsigned ends) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int jlo = (s0 + k) * kGroups;
        if (jlo >= nb) break;  // the same for every lane
        const int mine = jlo + group;
        bool pending = active && mine < nb;
        // Runs that end among this step's rows, in row order: a group adds
        // its row before the end it belongs to.
        unsigned step_ends = (ends >> jlo) & kStepMask;
        while (step_ends) {
          const int j = jlo + __ffs(step_ends) - 1;
          step_ends &= step_ends - 1;
          if (pending && mine <= j) {
            R::add(acc, v[k]);
            pending = false;
          }
          close(j);
        }
        if (pending) R::add(acc, v[k]);
      }
    };

    if constexpr (kPipelined) {
      // One round a batch: the next batch's rows are loaded before this
      // batch's are added.
      typename R::Raw v[kBatch];
      load_round(v, 0, r0, min(32, r1 - r0));
      for (int base = r0; base < r1; base += 32) {
        const int nb = min(32, r1 - base);
        const unsigned ends = __ballot_sync(kFullMask, lane < nb && cur != nxt);
        int cur_next, nxt_next;
        load_ids(base + 32, cur_next, nxt_next);
        typename R::Raw v_next[kBatch];
        if (base + 32 < r1) load_round(v_next, 0, base + 32, min(32, r1 - base - 32));
        add_round(v, 0, nb, ends);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) v[k] = v_next[k];
        cur = cur_next, nxt = nxt_next;
      }
    } else {
      for (int base = r0; base < r1; base += 32) {
        const int nb = min(32, r1 - base);
        const unsigned ends = __ballot_sync(kFullMask, lane < nb && cur != nxt);
        int cur_next, nxt_next;  // the next batch's ids, in flight meanwhile
        load_ids(base + 32, cur_next, nxt_next);
        const int used = (nb + kGroups - 1) / kGroups;  // load steps the batch needs
        for (int s0 = 0; s0 < used; s0 += kBatch) {
          typename R::Raw v[kBatch];
          load_round(v, s0, base, nb);
          add_round(v, s0, nb, ends);
        }
        cur = cur_next, nxt = nxt_next;
      }
    }
    // The piece ends inside a run: its part of that run is a carry.
    if (r1 < l_real && __ldg(ids + r1 - 1) == __ldg(ids + r1)) {
#pragma unroll
      for (int m = LANES; m < 32; m <<= 1) acc.add_xor(m);
      if (group == 0 && active) acc.store(carry + static_cast<int64_t>(piece) * d + c * VEC);
    }
  }
  // The id of the run this piece carries, or -1: the fix-up's index.
  if (lane == 0)
    meta[2 + piece] =
        r0 < r1 && r1 < l_real && __ldg(ids + r1 - 1) == __ldg(ids + r1) ? __ldg(ids + r1) : -1;

  // After the rows, so that their loads start at once: this warp's share of
  // the sentinel tail's order check (its ids, never its rows).
  const int64_t tail = num_rows - l_real;
  const int t0 = l_real + static_cast<int>(tail * piece / num_pieces);
  const int t1 = l_real + static_cast<int>(tail * (piece + 1) / num_pieces);
  for (int i0 = t0; i0 < t1; i0 += 32 * kUnroll) {
    int v[kUnroll], w[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = i0 + k * 32 + lane;
      v[k] = i < t1 && i + 1 < num_rows ? __ldg(ids + i) : 0;
      w[k] = i < t1 && i + 1 < num_rows ? __ldg(ids + i + 1) : 0;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) assert(v[k] <= w[k]);
  }
}

// The sum of `count` carries from piece `p0` on into out[id], in piece order,
// by one warp (lanes across the row's vectors).
template <int VEC>
__device__ __forceinline__ Acc<VEC> sum_carries(const float* __restrict__ carry, int p0,
                                                int count, int d, int c) {
  Acc<VEC> sum;
  sum.zero();
  const float* cp = carry + static_cast<int64_t>(p0) * d + c * VEC;
  int k = 0;
  for (; k + kFixupUnroll <= count; k += kFixupUnroll) {
    Acc<VEC> v[kFixupUnroll];
#pragma unroll
    for (int u = 0; u < kFixupUnroll; ++u) v[u].load(cp + static_cast<int64_t>(k + u) * d);
#pragma unroll
    for (int u = 0; u < kFixupUnroll; ++u) sum.add(v[u]);
  }
  for (; k < count; ++k) {
    Acc<VEC> v;
    v.load(cp + static_cast<int64_t>(k) * d);
    sum.add(v);
  }
  return sum;
}

// The third launch: the carries, 8 pieces a block, warp w taking piece
// 8b + w. When the piece is the first that carries a run, it counts the
// pieces that carry it (one load of the next 31 pieces' carried ids; a
// search for the run's end past that) and adds their carries, in piece
// order, into the row that the run's last piece wrote; more than kWarpChain
// carries go to the whole block, each warp adding a fixed share, combined in
// warp order.
template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dense_segment_sum_fixup_kernel(const int32_t* __restrict__ ids, float* __restrict__ out,
                               const float* __restrict__ carry, const int32_t* __restrict__ meta,
                               int d, int num_pieces) {
  __shared__ Acc<VEC> part[kWarpsPerBlock][32];
  __shared__ int3 chains[kWarpsPerBlock];  // (first piece, id, carries) of long chains
  const int l_real = meta[0], per = meta[1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dv = d / VEC;

  const int piece = blockIdx.x * kWarpsPerBlock + warp;
  int count = 0, id = -1;
  if (piece < num_pieces) {
    // Lane l holds the id that piece - 1 + l carries (-1 for none): the
    // pieces that carry this piece's run follow it, one lane each.
    const int q = piece - 1 + lane;
    const int cid = q >= 0 && q < num_pieces ? meta[2 + q] : -1;
    id = __shfl_sync(kFullMask, cid, 1);
    if (id >= 0 && __shfl_sync(kFullMask, cid, 0) != id) {  // the run's first carrier
      const unsigned other = ~__ballot_sync(kFullMask, cid == id) & ~1u;
      if (other != 0) {
        count = __ffs(other) - 2;
      } else {  // 31 or more: the run ends in piece (e - 1) / per, which writes it
        int r0, r1;
        piece_rows(piece, per, l_real, r0, r1);
        count = (first_at_least<4>(ids, r1, l_real, id + 1, lane) - 1) / per - piece;
      }
    }
  }
  if (lane == 0) chains[warp] = make_int3(piece, id, count > kWarpChain ? count : 0);
  if (count > 0 && count <= kWarpChain) {
    float* op = out + static_cast<int64_t>(id) * d;
    for (int c = lane; c < dv; c += 32) {
      Acc<VEC> o;
      o.load(op + c * VEC);
      o.add(sum_carries<VEC>(carry, piece, count, d, c));
      o.store(op + c * VEC);
    }
  }
  __syncthreads();
  for (int w = 0; w < kWarpsPerBlock; ++w) {  // long chains, one at a time
    const int3 ch = chains[w];
    if (ch.z == 0) continue;  // the same for every thread
    const int k0 = ch.z * warp / kWarpsPerBlock, k1 = ch.z * (warp + 1) / kWarpsPerBlock;
    float* op = out + static_cast<int64_t>(ch.y) * d;
    for (int c0 = 0; c0 < dv; c0 += 32) {
      const int c = c0 + lane;
      if (c < dv) part[warp][lane] = sum_carries<VEC>(carry, ch.x + k0, k1 - k0, d, c);
      __syncthreads();
      if (warp == 0 && c < dv) {
        Acc<VEC> o;
        o.load(op + c * VEC);
        Acc<VEC> total = part[0][lane];
        for (int u = 1; u < kWarpsPerBlock; ++u) total.add(part[u][lane]);
        o.add(total);
        o.store(op + c * VEC);
      }
      __syncthreads();
    }
  }
}

template <typename Tin>
struct Args {
  const Tin* msg;
  const int32_t* ids;
  float* out;
  float* carry;
  int32_t* meta;
  int num_rows, d, num_segments, min_rows, num_pieces;
  cudaStream_t stream;
};

template <typename Tin, int VEC, int LANES>
int launch(const Args<Tin>& a) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((a.num_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int64_t n = static_cast<int64_t>(a.num_segments) * a.d;
  const int64_t zero_blocks = (n / 4 + 255) / 256 + 1;
  const unsigned zero_grid =
      static_cast<unsigned>(zero_blocks < kZeroBlocks ? zero_blocks : kZeroBlocks);
  dense_segment_sum_zero_kernel<<<zero_grid, 256, 0, a.stream>>>(
      a.ids, a.out, n, a.meta, a.num_rows, a.num_segments, a.min_rows, a.num_pieces);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_segment_sum_kernel<Tin, VEC, LANES><<<grid, block, 0, a.stream>>>(
      a.msg, a.ids, a.out, a.carry, a.meta, a.num_rows, a.d, a.num_segments, a.num_pieces);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_segment_sum_fixup_kernel<VEC><<<grid, block, 0, a.stream>>>(a.ids, a.out, a.carry,
                                                                   a.meta, a.d, a.num_pieces);
  return cudaGetLastError();
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

// C entries for ctypes, one per row type, each in a build of its own. msg
// has num_rows rows of d elements, ids num_rows entries, out num_segments
// rows of d floats. vec (elements per lane: 1, 2 or 4, and 8 for bf16 rows)
// must divide d, and lanes be a power of two up to 32 (the wrapper picks
// both, ops/cuda/dense_segment_sum.b2_width, and checks the alignment of msg
// and out; out must be 16-byte aligned). carry holds num_pieces * d floats
// and meta 2 + num_pieces ints of scratch (ops/cuda/dense_segment_sum.piece_plan and
// .scratch); num_pieces >= 1. Launches the zeros, the row split and the
// fix-up on `stream` and allocates nothing. Returns cudaGetLastError() after
// each launch (0 when all were accepted), or -1 for a vec or lanes it does
// not take.
#ifndef B2_ROWS_BF16
extern "C" int dense_sorted_segment_sum_f32(const float* msg, const int32_t* ids, float* out,
                                            float* carry, int32_t* meta, int num_rows, int d,
                                            int num_segments, int vec, int lanes, int min_rows,
                                            int num_pieces, void* stream) {
  if (num_rows <= 0 || num_segments <= 0) return 0;
  const Args<float> a{msg,      ids, out, carry, meta, num_rows, d, num_segments, min_rows,
                      num_pieces, static_cast<cudaStream_t>(stream)};
  switch (vec) {
    case 4: return launch_lanes<float, 4>(lanes, a);
    case 2: return launch_lanes<float, 2>(lanes, a);
    case 1: return launch_lanes<float, 1>(lanes, a);
    default: return -1;
  }
}
#else
extern "C" int dense_sorted_segment_sum_bf16(const __nv_bfloat16* msg, const int32_t* ids,
                                             float* out, float* carry, int32_t* meta,
                                             int num_rows, int d, int num_segments, int vec,
                                             int lanes, int min_rows, int num_pieces,
                                             void* stream) {
  if (num_rows <= 0 || num_segments <= 0) return 0;
  const Args<__nv_bfloat16> a{msg,      ids, out, carry, meta, num_rows, d, num_segments,
                              min_rows, num_pieces, static_cast<cudaStream_t>(stream)};
  switch (vec) {
    case 8: return launch_lanes<__nv_bfloat16, 8>(lanes, a);
    case 4: return launch_lanes<__nv_bfloat16, 4>(lanes, a);
    case 2: return launch_lanes<__nv_bfloat16, 2>(lanes, a);
    case 1: return launch_lanes<__nv_bfloat16, 1>(lanes, a);
    default: return -1;
  }
}
#endif
