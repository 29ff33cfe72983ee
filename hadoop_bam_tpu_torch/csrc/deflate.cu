// Greedy LZ77 + fixed-Huffman DEFLATE of BGZF member payloads for Hopper
// (sm_90a): one CTA per member, one warp walks it.
//
// Replaces the TPU kernel hadoop_bam_tpu/ops/pallas/deflate_lanes.py
// (_kernel_factory and _launch, pl.pallas_call at :328) together with the
// XLA programs that finish its work there: the ragged token compaction
// (_compact_tokens, :373) and the fixed-Huffman bit pack
// (_emit_tokens_fixed, :412).  The TPU kernel walks 128 members in
// lockstep, one per vector lane, reads "4 bytes at my cursor" as one-hot
// row selects over a transposed word layout, streams int32 tokens to HBM
// chunk by chunk and packs the bits afterwards.  None of that carries
// over: no token array exists here, and the bits of each window of
// decisions go out as soon as they are known.
//
// Bound on this card: bytes (payload in, compressed bytes out) over
// 3.35 TB/s.  The kernel is far from it, because a member is one chain of
// decisions: where the next token starts depends on the last one, and
// every scan step reads the hash heads the steps before it wrote.  What
// the design does about it (the walk is deflate_core.cuh; a host build of
// it is held to the plain version by the CPU tests):
//
//   1. A window of 32 positions a step.  Lane L of the member's warp takes
//      position cur + L: its word, its hash, its two candidates (earlier
//      lanes of its hash group, else the heads as they stood) and its match
//      test run at once, and one ballot finds the first lane F that
//      matches.  The lanes before F are literals and are exact; F starts
//      the copy; the rest are dropped.  A run of literals advances 32 bytes
//      for one chain of dependent loads, where the earlier design (one
//      thread a member) paid that chain for every byte.
//   2. Hash groups through shared memory: each lane ORs its bit into its
//      hash's slot of a second 2^hb-word table and reads it back.
//      __match_any_sync computes the same and was the largest single cost
//      of the first version on an H100; eleven ballots (one a hash bit)
//      cost more than the table too.
//   3. The extension compares 32 words at a time: a copy of 258 bytes is
//      at most three steps of one ballot each.
//   4. Bits.  Literal codes are 8 or 9 bits, so a popcount of a ballot
//      places them; two shuffles gather four codes on one lane, and at most
//      nine lanes OR them (and the copy's code) into a 256-byte ring in
//      shared memory with predicated reductions.  A window's bits go into
//      the ring while the next window's loads are in flight.  Each 128-byte
//      stretch behind them goes to the row, four bytes a lane (the rows
//      are not 4-byte aligned: out_stride is odd).
//   5. Staged payload.  The member's warp copies it into shared memory with
//      16-byte asynchronous copies; candidates and extensions then read
//      shared memory, never device memory.
//
// What sets the members an SM: shared memory.  A full-size member (57,088
// bytes) stages ≈ 56 KiB, the heads and the group slots take 2^hb 32-bit
// words each (h1 and h2 as 16-bit halves of a head: positions + 1 <=
// 65,533 fit), 16 KiB at hb = 11, and the ring 256 bytes: ≈ 72 KiB a CTA,
// three CTAs an SM, 396 members at once on 132 SMs.  A part's 920 members
// take three rounds, the last a third full.  A CTA is the member's one
// warp (four warps a CTA, three of them idle after the staging, ran a
// little slower).

#include <cstdint>

#include <cuda_runtime.h>

#include "deflate_core.cuh"

namespace {

using namespace hbt_deflate;

constexpr int kThreads = kLanes;  // the member's warp

__global__ void __launch_bounds__(kThreads)
deflate_members_kernel(const uint8_t* __restrict__ stream, int64_t n_stream,
                       const int64_t* __restrict__ offs,
                       const int32_t* __restrict__ lens, int hb,
                       int64_t out_stride, uint8_t* __restrict__ comp,
                       int32_t* __restrict__ clens, int32_t* __restrict__ ok,
                       int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int H = 1 << hb;
  uint32_t* heads = reinterpret_cast<uint32_t*>(smem);
  uint32_t* groups = heads + H;
  uint32_t* ring = groups + H;
  uint8_t* staged = reinterpret_cast<uint8_t*>(ring + kRingWords);  // 16-aligned

  const int64_t i = blockIdx.x;
  const int32_t plen = lens[i];

  // 1. Stage [offs, offs + plen) from the 16-byte aligned base below it;
  //    vectors that reach outside the stream fall back to byte loads.
  const uintptr_t lo = reinterpret_cast<uintptr_t>(stream);
  const uintptr_t hi = lo + static_cast<uintptr_t>(n_stream);
  const uintptr_t src = lo + static_cast<uintptr_t>(offs[i]);
  const uintptr_t base = src & ~uintptr_t(15);
  const int lead = static_cast<int>(src - base);
  const int nvec = plen > 0 ? (lead + plen + 15) / 16 : 0;
  for (int k = threadIdx.x; k < 2 * H + kRingWords; k += kThreads) heads[k] = 0;
  for (int k = threadIdx.x; k < nvec; k += kThreads) {
    const uintptr_t a = base + 16 * static_cast<uintptr_t>(k);
    if (a >= lo && a + 16 <= hi) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(staged + 16 * k));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                   "l"(reinterpret_cast<const void*>(a))
                   : "memory");
    } else {
      for (int j = 0; j < 16; ++j) {
        const uintptr_t b = a + j;
        staged[16 * k + j] = (b >= lo && b < hi) ? *reinterpret_cast<const uint8_t*>(b) : 0;
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();

  // 2. Walk and emit.
  Warp q;
  init_lanes(q, threadIdx.x);
  const Member m{reinterpret_cast<const uint32_t*>(staged), lead, plen, hb, heads, groups,
                 ring, comp + i * out_stride};
  Counts c;
  const int32_t clen = deflate_member(q, m, &c);

  // 3. Meta.
  if (threadIdx.x == 0) {
    clens[i] = clen;
    ok[i] = 1;  // the walk always ends at plen
    if (counts != nullptr) {
      counts[3 * i] = c.literals;
      counts[3 * i + 1] = c.copies;
      counts[3 * i + 2] = c.windows;
    }
  }
}

}  // namespace

extern "C" {

// Compress n members.  Member i's payload is stream[offs[i] .. + lens[i])
// of a stream of n_stream bytes; its DEFLATE member goes to
// comp[i * out_stride ..], which the caller zeroes, and meta to clens[i],
// ok[i]; counts (int32 [n][3], or null) gets each member's literals, copies
// and windows.  stage_bytes >= 16 * ceil((15 + max lens + 16) / 16); hb is
// the hash-head width (8..11).  Returns the CUDA error code of the launch.
int hbt_deflate_members(const void* stream, long long n_stream,
                        const void* offs, const void* lens, long long n,
                        int hb, int stage_bytes, long long out_stride,
                        void* comp, void* clens, void* ok, void* counts,
                        void* cuda_stream) {
  if (n <= 0) return 0;
  const int smem = 4 * (2 * (1 << hb) + kRingWords) + stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      deflate_members_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  deflate_members_kernel<<<static_cast<unsigned>(n), kThreads, smem,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream), static_cast<int64_t>(n_stream),
      static_cast<const int64_t*>(offs), static_cast<const int32_t*>(lens), hb,
      static_cast<int64_t>(out_stride), static_cast<uint8_t*>(comp),
      static_cast<int32_t*>(clens), static_cast<int32_t*>(ok),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
