// Halo exchange of a node-sharded layer for Hopper (sm_90a): an all-to-all of
// per-shard blocks, every shard's tensors in allocations of their own.
//
//   recv[o][d, :, :] = send[d][o, :, :]   for every pair of shards (d, o)
//
// send[d] is shard d's [n, P, D]: row block o holds the P rows that d serves
// to peer o. recv[o] is o's freshly allocated [n, P, D]: row block d receives
// them. Both blocks are contiguous [P, D] runs of P * D elements, so a pair's
// copy is one flat copy. The payload is float32 (entry halo_exchange_f32) or,
// under bf16 compute, bfloat16 (halo_exchange_bf16), as the TPU kernel moved
// the payload in its own dtype; the copy moves bits and never converts.
//
// Replaces the TPU kernel primekg_rgcn_tpu/ops/pallas/halo.py: _halo_kernel
// (reached through pallas_halo_exchange). There, each device starts one
// remote DMA per peer, walking the ring from (my + 1) % n, then copies its
// own slot while they fly, then waits on each transfer (halo_schedule). Here
// one process drives every shard and all shards of a mesh live on one card,
// so the whole exchange is one launch: n * n pairs of [P, D] blocks. The
// schedule's order survives as the grid's order: blockIdx.z is the step i of
// the schedule's copy events, blockIdx.y the sending shard s, and step i
// copies s's block for peer (s + offset[i]) % n. The wrapper derives the
// offsets from halo_schedule: start i is offset 1 + i, the local copy offset
// 0 (s itself), last. Blocks are dispatched roughly in linear order, so every
// ring-staggered pair is issued before any local slot, and at every step each
// shard sends to a distinct peer and receives from a distinct one. There are
// no waits to place: the end of the kernel on the stream completes every
// pair at once.
//
// The n send and n recv pointers and the n step offsets reach the kernel in
// its parameter block (the launch's constant bank in device memory), one
// pointer per shard, so a launch needs no host-to-device copy of a table and
// nothing assumes that the shards share an allocation.
//
// Bound on the H100: memory bytes. The function must read each send byte
// once and write each recv byte once, and does no arithmetic: at the
// node-sharded step's shapes on the bench.py graph (n = 4, P = 7,736)
// 2 * 31.7 MB for D = 64 in float32, 18.9 us at 3.35 TB/s, twice that for
// D = 128, half of each in bf16; on full PrimeKG (P = 31,856) 2 * 130 MB
// for D = 64 in float32, 77.9 us, twice that for D = 128.
//
// Design: blockIdx.x is a tile of kThreads * kUnroll vectors of the pair's
// flat [P * D] run, 16 KB a block; each thread loads its kUnroll vectors
// before it stores any, so 8 blocks an SM keep 128 KB in flight. Vectors are
// 16 bytes (4 floats, 8 bf16) when a pair's P * D elements are whole 16-byte
// units and every pointer is 16-byte aligned, else one element (the
// wrapper's choice, by shape and alignment, before the launch).
//
// Against copy_ of the same bytes (scripts/port_time_b4.py, PERF.md section 6)
// these tiles are within 1.5 % of it at three of the four exchanges whose
// sends fit in the L2 (bf16 D = 64: 5-6 % behind warm, 5-7 % ahead cold) and
// 1-3 % behind past it, at 86-89 % of the bound. The cause is not bytes in
// flight (the HBM rate needs about 18 KB an SM): likely it is the blocks'
// lockstep bursts of loads, then stores, and the launch and retire costs
// between them. The redesigns measured and left out: a persistent grid, one or
// more blocks an SM, copying equal shares of the pair list through a ring of
// TMA bulk copies (cp.async.bulk into shared memory and out again, mbarrier
// completion), with each block's share contiguous or dealt round-robin in
// chunks, 5-25 % behind copy_; a persistent LDG/STG grid over the same shares,
// 17-22 % behind; one TMA chunk a block without persistence, 1-4 % behind. In
// a persistent grid each block's place in the list drifts from its
// neighbours', and the memory rows in use drift apart with it; the hardware's
// dispatch of short-lived blocks in linear order keeps them together. 512
// threads * 1 vector (8 KB a block) past the L2 was 1.0-2.4 % faster in
// isolation but not in a node step, whose gather has just written the sends,
// so one tile serves every size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct ShardPointers {
  const void* send[kMaxShards];
  void* recv[kMaxShards];
  int offset[kMaxShards];  // step i's peer is (s + offset[i]) % n
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
halo_exchange_kernel(const ShardPointers ptrs, int n, int64_t pair_vecs) {
  const int step = blockIdx.z;
  const int s = blockIdx.y;
  const int peer = (s + ptrs.offset[step]) % n;
  const V* src = reinterpret_cast<const V*>(ptrs.send[s]) + peer * pair_vecs;
  V* dst = reinterpret_cast<V*>(ptrs.recv[peer]) + s * pair_vecs;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  V v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t j = base + u * kThreads;
    if (j < pair_vecs) v[u] = __ldg(src + j);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t j = base + u * kThreads;
    if (j < pair_vecs) dst[j] = v[u];
  }
}

// Checks the arguments, fills the parameter block and launches with 16-byte
// vectors Wide (kWide elements each) when vec == kWide, else one element
// Narrow at a time.
template <typename Wide, typename Narrow, int kWide>
int exchange(const uint64_t* send_ptrs, const uint64_t* recv_ptrs, const int* offsets, int n,
             long long rows, int d, int vec, void* stream) {
  if (n < 1 || n > kMaxShards || rows < 0 || d < 1 || (vec != 1 && vec != kWide))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pair_elems = static_cast<int64_t>(rows) * d;
  if (pair_elems % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  ShardPointers ptrs;
  bool seen[kMaxShards] = {};
  for (int i = 0; i < n; ++i) {
    if (offsets[i] < 0 || offsets[i] >= n || seen[offsets[i]])
      return static_cast<int>(cudaErrorInvalidValue);
    if (vec == kWide && ((send_ptrs[i] | recv_ptrs[i]) & 15) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    seen[offsets[i]] = true;
    ptrs.send[i] = reinterpret_cast<const void*>(send_ptrs[i]);
    ptrs.recv[i] = reinterpret_cast<void*>(recv_ptrs[i]);
    ptrs.offset[i] = offsets[i];
  }
  const int64_t pair_vecs = pair_elems / vec;
  if (pair_vecs == 0) return 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t tiles = (pair_vecs + per_block - 1) / per_block;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), n, n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == kWide)
    halo_exchange_kernel<Wide><<<grid, kThreads, 0, st>>>(ptrs, n, pair_vecs);
  else
    halo_exchange_kernel<Narrow><<<grid, kThreads, 0, st>>>(ptrs, n, pair_vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries for ctypes, one per element size. send_ptrs and recv_ptrs are
// host arrays of n device addresses (each an [n, rows, d] tensor of the
// entry's type, contiguous); offsets is a host array of n step offsets, a
// permutation of 0 .. n - 1 (so each step pairs every shard with a distinct
// peer); vec is 4 for float32 or 8 for bf16 (16-byte vectors: the wrapper
// has checked that vec divides rows * d and that every pointer is 16-byte
// aligned), or 1. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int halo_exchange_f32(const uint64_t* send_ptrs, const uint64_t* recv_ptrs,
                                 const int* offsets, int n, long long rows, int d, int vec,
                                 void* stream) {
  return exchange<float4, float, 4>(send_ptrs, recv_ptrs, offsets, n, rows, d, vec, stream);
}

extern "C" int halo_exchange_bf16(const uint64_t* send_ptrs, const uint64_t* recv_ptrs,
                                  const int* offsets, int n, long long rows, int d, int vec,
                                  void* stream) {
  return exchange<uint4, unsigned short, 8>(send_ptrs, recv_ptrs, offsets, n, rows, d, vec,
                                            stream);
}
