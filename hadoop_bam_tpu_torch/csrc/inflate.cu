// BGZF member inflate for Hopper (sm_90a): one warp per member.
//
// Replaces the TPU kernel hadoop_bam_tpu/ops/pallas/inflate_lanes.py
// (_kernel_factory, _launch and the host replay _apply_far_copies).  The
// TPU kernel walks 128 members in lockstep, one per vector lane, streams
// its output through a 32 KiB ring in VMEM and defers far LZ77 copies to a
// host pass.  Here every member gets a CTA of one warp and the grid is the
// launch's member count.  The decoder core is inflate_core.cuh (a host
// build of it is held to zlib by the CPU tests); per member:
//
//   1. No staging.  The stream is read in place in aligned 8-byte words,
//      copied asynchronously (cp.async) into a 32-word ring in shared memory
//      16 words ahead of use, and fed to a 128-bit register bit window.
//   2. Table-driven decode.  Each block's codes get root tables in shared
//      memory (2^10 literal/length entries, 2^8 distance entries, 2^7 for
//      the code-length code), built by the warp together: the length
//      histogram with shared atomics, the canonical order with match-any
//      ranks, the entries on a stride.  One lookup gives a symbol, its code
//      length and its extra bits; a longer code resumes the canonical walk
//      where the root left off.
//   3. Output through a 16 KiB ring in shared memory, at the same address
//      as the member's place in `out` modulo 16.  It holds the last 16 KiB;
//      at the end of every round the warp writes the round's bytes to `out`
//      with 16-byte stores, so a copy from farther back reads `out` (L2).
//      Any isize decodes this way, also past BGZF's 64 KiB.
//   4. Decode and execute.  Lane 0 decodes literals four at a time and
//      writes them, and copies of <= 8 bytes, into the ring itself.  Other
//      copies become (position, length, distance) tokens, which the warp
//      applies in order at the end of the round (128 tokens, 16 KiB of
//      output or the end of a block), 32 bytes a step, as out[o+k] =
//      out[o - dist + (k mod dist)]: every source byte precedes o, so
//      overlapping copies are exact.  The warp also copies stored blocks.
//   5. Occupancy.  A CTA takes 24,848 bytes of shared memory, so nine fit an
//      SM: 1,188 members in flight on 132 SMs.
//
// Why so: a lone warp stalls on every branch whose condition comes from a
// load it has just made, about as long as a shared-memory load, and for a
// whole device-memory latency on the first use of a register a load is
// still filling.  So the literal
// loop takes one branch per four symbols, short copies are predicated byte
// moves, the bit window refills once per 64 bits from shared memory, and
// many members share an SM instead of one member using a 64 KiB window.
//
// Verdicts (meta[i] = {n_out, ok}) are zlib's; inflate_core.cuh lists
// them.  A declined member is re-decoded on the host by the caller.
//
// Bound on this card: (compressed bytes + output bytes) / 3.35 TB/s.  The
// kernel is far from it: each member is one serial chain of dependent
// table lookups.  What else Hopper offers does not apply: the tensor cores
// need a matrix product and inflate has none; TMA and cp.async.bulk need
// 16-byte-aligned addresses and sizes, which member streams and outputs do
// not have, and each member is one serial stream, served by a small ring of
// 8-byte asynchronous copies.  Decoding in one warp while another executes
// is later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "inflate_core.cuh"

namespace {

using namespace hbt_inflate;

constexpr int kTablesBytes = 8448;  // Shared, rounded up to 16; the output ring follows
constexpr int kSmemBytes = kTablesBytes + kWin + 16;
static_assert(sizeof(Shared) <= kTablesBytes, "Shared outgrew its reservation");

__global__ void __launch_bounds__(32) inflate_members_kernel(
    const uint8_t* __restrict__ comp, const int64_t* __restrict__ comp_off,
    const int32_t* __restrict__ clens, const int64_t* __restrict__ out_off,
    const int32_t* __restrict__ isizes, uint8_t* out, int32_t* meta) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared* sh = reinterpret_cast<Shared*>(smem);
  const int lane = threadIdx.x;
  const int64_t i = blockIdx.x;
  const int32_t clen = clens[i];
  const int32_t isize = isizes[i];
  const uint8_t* src = comp + comp_off[i];
  uint8_t* dst = out + out_off[i];
  uint8_t* ring = smem + kTablesBytes + (reinterpret_cast<uintptr_t>(dst) & 15);
  const Result r = run_member(sh, ring, dst, src, clen, isize, lane, 32);
  if (lane == 0) {
    meta[2 * i] = r.n_out;
    meta[2 * i + 1] = r.ok ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Decode n members.  Member i's DEFLATE stream is comp[comp_off[i] ..
// + clens[i]); its output goes to out[out_off[i] .. + isizes[i]).  comp
// must hold 7 readable bytes past its last member (aligned 8-byte loads).
// smem_bytes must be at least 24,848 (the CTA's tables and output ring).
// Returns the CUDA error code of the launch (0 on success).
int hbt_inflate_members(const void* comp, const void* comp_off,
                        const void* clens, const void* out_off,
                        const void* isizes, void* out, void* meta,
                        long long n, int smem_bytes, void* stream) {
  if (n <= 0) return 0;
  if (smem_bytes < kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      inflate_members_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(inflate_members_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  inflate_members_kernel<<<static_cast<unsigned>(n), 32, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int64_t*>(comp_off),
      static_cast<const int32_t*>(clens), static_cast<const int64_t*>(out_off),
      static_cast<const int32_t*>(isizes), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
