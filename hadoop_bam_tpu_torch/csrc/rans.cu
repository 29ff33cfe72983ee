// rANS 4x8 decode (CRAM 3.0, order 0 and order 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel hadoop_bam_tpu/ops/pallas/rans_lanes.py
// (_kernel_factory, reached through rans_lanes) together with its host
// post-pass rans_deinterleave: each stream's bytes land straight at their
// output positions.  The TPU kernel ran 128 streams in lockstep on the
// vector lanes, every per-lane lookup a dense compare-and-reduce over VMEM
// banks, and declined streams whose payload, output or context banks
// passed its VMEM budget.  Here one block decodes one stream, so nothing is
// declined for size: the wrapper only keeps n_out inside int32.
//
// Bound on this card: each payload byte read once, each output byte
// written once, over 3.35 TB/s.  The kernel is far from it, because a
// stream is one serial chain: a group of four waves needs the four states
// of the group before it (their slots pick the table entries), and every
// state's renorm bytes sit behind the cursor that all earlier renorms
// moved.  Streams run in parallel, one block each; a container's launch
// lasts as long as its longest stream, so the kernel is built around the
// latency of one group.  The walk is rans_core.cuh (a host build of it is
// held to the plain version by the CPU tests); what each part takes off
// the chain:
//
//   1. Four lanes a stream.  Lane j of warp 0 owns state j, so the four
//      table lookups and state updates of a group are one instruction each
//      for the warp, not four for a lone thread.  The only thing the lanes
//      share is the renorm cursor: two ballots (reads a byte, reads two)
//      and a popcount give each lane its byte offset and the group its
//      advance, with no branch.
//   2. Slot tables in shared memory.  The block's 128 threads build three
//      16-bit arrays a table, F[sym], the bias m - C[sym] and sym, so a step
//      is three independent shared loads at one index and one 32-bit
//      multiply-add; the renorm's funnel shift yields the next index.
//      Order 0's table is 24 KiB; order 1 stages its first `stage`
//      contexts (up to 9) the same way and builds the rest into a global
//      spill area read through L1; a 256-entry map in shared memory gives
//      each context's table.
//   3. Exact 32-bit states.  F * (R >> 12) + bias <= 2^32 - 1 for u32
//      states, F <= 4096 and a bias below 4096 (frequency sums past 4,096
//      tier down before the launch), so each state costs one 32-bit IMAD
//      where 64-bit arithmetic cost several.
//   4. Branch-free renorm.  A lane reads (x < 2^23) + (x < 2^15) bytes,
//      taken from the 8-byte window at the cursor by one byte permute and
//      one funnel shift.  The verdicts accumulate (each lane keeps its
//      least x) and are looked at once per 16 groups.
//   5. A payload ring filled by bulk copies.  pack() starts each payload
//      on a 16-byte boundary and pads the last by 256 bytes, so lane 0
//      copies the stream in 1 KiB chunks into an 8 KiB ring with
//      cp.async.bulk (completion on an mbarrier a slot), up to eight
//      chunks ahead of the cursor, the first ones while the tables are
//      built.  The window is three aligned shared loads at the cursor
//      (the ring's first 16 bytes are mirrored past its end), loaded
//      beside the group's table loads; no step waits for device memory.
//   6. Output.  Each lane writes its byte of a group, so a group's four
//      bytes are one coalesced store; a 16-byte store would first need a
//      transpose across the lanes.  Order 1's lanes write their quarters.
//
// The verdicts (ok = 0, and the host decodes the stream again) are the
// plain version's: a renorm read at or past the payload's clen bytes, a
// state still below L = 2^23 after two reads, an order-1 context absent
// from the stream's tables.  The groups a block decodes after a failed
// verdict write bytes that nobody reads.

#include <cstdint>

#include <cuda_runtime.h>

#include "rans_core.cuh"

namespace {

using namespace hbt_rans;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rans_kernel(const uint8_t* __restrict__ payload, const int64_t* __restrict__ meta,
            const uint8_t* __restrict__ lookup, const uint32_t* __restrict__ fc,
            const int32_t* __restrict__ cmap, uint8_t* spill, uint8_t* __restrict__ out,
            int32_t* __restrict__ ok, int stage) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Slabs s_slabs;
  const int b = blockIdx.x;
  const int64_t* mt = meta + static_cast<int64_t>(b) * kMetaCols;
  const int order = static_cast<int>(mt[4]);
  const int32_t* cm = cmap + static_cast<int64_t>(b) * 256;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* ptrs = reinterpret_cast<uint64_t*>(smem + kPtrOff);
  uint8_t* tabs = smem + kTabOff;
  const uint8_t* src = payload + mt[0];
  const uint32_t clen = static_cast<uint32_t>(mt[1]);
  if (threadIdx.x == 0) {
    // The first chunks fly while the tables are built.
    init_bars(bars);
    Ring g = open_ring(smem, bars, src, clen);
    prime(g, true);
    s_slabs = stream_slabs(cm, order);
  }
  __syncthreads();
  const Slabs s = s_slabs;
  fill_tables(lookup, fc, s, stage, tabs, spill, threadIdx.x, kThreads);
  if (order == 1) fill_ptrs(cm, s, stage, tabs, spill, ptrs, threadIdx.x, kThreads);
  __syncthreads();
  if (threadIdx.x >= kLanes) return;
  Ring g = open_ring(smem, bars, src, clen);
  prime(g, false);  // the counts of what thread 0 asked for
  const bool good = decode_stream(g, threadIdx.x, mt, tabs, ptrs, out + mt[2]);
  if (threadIdx.x == 0) ok[b] = good;
}

}  // namespace

extern "C" {

// One block per stream.  meta is int64[n_streams][9] (payload offset, clen,
// output offset, n_out, order, R0..R3); lookup uint8[slabs][4096]; fc
// uint32[slabs][256] (C << 16 | F); cmap int32[n_streams][256] (slab index,
// -1 for an absent order-1 context; an order-0 stream's row holds its one
// slab; a stream's slabs are consecutive); spill uint8[slabs][24576], the
// tables of order-1 contexts past `stage`; payload 16-aligned, each stream
// at a 16-aligned offset, with 256 readable bytes past the last stream; out
// uint8 with each stream's 16-aligned region; ok int32 [n_streams].  stage
// (1..9) is the number of tables a block keeps in shared memory.  Returns
// the CUDA error code of the launch.
int hbt_rans_decode(const void* payload, const void* meta, const void* lookup,
                    const void* fc, const void* cmap, void* spill, void* out, void* ok,
                    int n_streams, int stage, void* stream) {
  if (n_streams <= 0) return 0;
  if (stage < 1 || stage > kMaxStage) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes(stage));
  cudaError_t e = cudaFuncSetAttribute(rans_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rans_kernel<<<n_streams, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int64_t*>(meta),
      static_cast<const uint8_t*>(lookup), static_cast<const uint32_t*>(fc),
      static_cast<const int32_t*>(cmap), static_cast<uint8_t*>(spill),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(ok), stage);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
