// FASTQ record-boundary scan for Hopper (sm_90a): one block a chunk over
// shared-memory tiles.
//
// record_scan_kernel replaces hadoop_bam_tpu/ops/pallas/record_scan.py
// (record_scan, the pallas_call at :305).  There, up to 128 chunks ride the
// 128 vector lanes of one kernel in lockstep, one byte per lane per wave,
// over a transposed bank of packed words, with a 40-row register file per
// lane updated by iota selects.  Here each chunk gets a block that reads
// its window in place from one flat byte tensor (chunks overlap, so nothing
// is copied into a bank), a tile of `tile` bytes at a time, double-buffered
// in shared memory by 16-byte cp.async; the block finds the tile's
// newlines with a block scan, writes a line table into a shared ring, and
// takes the line machine's decisions as block minima over the tile's
// complete frames, writing the records before a stop in parallel
// (record_scan_core.cuh).
//
// The verdicts are the Pallas kernel's, exactly: sync on two back-to-back
// verified frames with no end-of-data relaxation; a bad frame, a record
// past the chunk's cap, a partial claimed frame, dangling claimed text and
// a window that never synced over content give ok = 0; a final window's
// unterminated last line completes through a synthetic newline.
//
// Bound: bytes (every window byte read once, 32 bytes written per record)
// over 3.35 TB/s.  The design before this one gave a warp to a chunk and
// walked the line machine serially, 128 bytes a step (3.089 ms on an H100
// at the ingest's 1,575 chunks); here a chunk's tiles take a few
// block-wide steps each (~67 lines and ~17 records of 151 bp reads a 6 KiB
// tile), and the chunks run as blocks over every SM.
//
// Geometry, tuned on an H100 (700 W) at the ingest's 1,575 R1 windows by
// the bare launch's time: 6 KiB tiles and 128 threads a block by default
// (ops/kernels/record_scan.TILE, THREADS; 38 KB of shared memory, five
// blocks an SM; 0.106 ms).  A line is a 4-byte ring entry: with 8-byte
// entries the ring held five 4 KiB blocks an SM (0.124 ms), with 4-byte
// ones eight (0.111 ms); 256 threads a block took 0.145 ms, 2 KiB tiles
// 0.139 ms, one warp a chunk 0.120 ms.  The C entry takes another tile (a
// multiple of 16, for the tests' tiny tiles) and 128 or 256 threads.

#include <cstdint>

#include <cuda_runtime.h>

#include "record_scan_core.cuh"

namespace {

using namespace hbt_scan;

constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

template <int kThreads, bool kTimed>
__global__ void __launch_bounds__(kThreads)
record_scan_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ win_off,
                   const int64_t* __restrict__ win_len, const int64_t* __restrict__ chunk_len,
                   const int64_t* __restrict__ flags, const int64_t* __restrict__ caps,
                   const int64_t* __restrict__ row_base, int32_t* __restrict__ rows,
                   int32_t* __restrict__ meta, int tile, unsigned long long* cyc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t k = blockIdx.x;
  const Layout L = carve(smem, tile, kThreads);
  const uint8_t* w = data + win_off[k];
  const int32_t fl = static_cast<int32_t>(flags[k]);
  const Chunk c{w,
                static_cast<int32_t>(win_len[k]),
                static_cast<int32_t>(chunk_len[k]),
                static_cast<int32_t>(caps[k]),
                fl & 1,
                (fl >> 1) & 1,
                static_cast<int32_t>(reinterpret_cast<uintptr_t>(w) & 15),
                rows + 8 * row_base[k]};
  scan_chunk<kTimed>(c, L, kThreads, meta + 2 * k, cyc);
}

template <int kThreads, bool kTimed>
int launch(const void* data, const void* win_off, const void* win_len, const void* chunk_len,
           const void* flags, const void* caps, const void* row_base, void* rows, void* meta,
           long long n_chunks, int tile, void* cyc, cudaStream_t stream) {
  const int64_t smem = smem_bytes(tile, kThreads);
  auto kern = record_scan_kernel<kThreads, kTimed>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<static_cast<unsigned>(n_chunks), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(win_off),
      static_cast<const int64_t*>(win_len), static_cast<const int64_t*>(chunk_len),
      static_cast<const int64_t*>(flags), static_cast<const int64_t*>(caps),
      static_cast<const int64_t*>(row_base), static_cast<int32_t*>(rows),
      static_cast<int32_t*>(meta), tile, static_cast<unsigned long long*>(cyc));
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads>
int launch_timed(const void* data, const void* win_off, const void* win_len,
                 const void* chunk_len, const void* flags, const void* caps,
                 const void* row_base, void* rows, void* meta, long long n_chunks, int tile,
                 void* cyc, cudaStream_t stream) {
  return cyc ? launch<kThreads, true>(data, win_off, win_len, chunk_len, flags, caps, row_base,
                                      rows, meta, n_chunks, tile, cyc, stream)
             : launch<kThreads, false>(data, win_off, win_len, chunk_len, flags, caps,
                                       row_base, rows, meta, n_chunks, tile, cyc, stream);
}

}  // namespace

extern "C" {

// Scan n_chunks windows data[win_off[k] .. + win_len[k]) (each at most
// 2^17 bytes, the wrapper's cap; every column int64); chunk k's claimed
// records go to rows[row_base[k] ..] (8 int32 each, at most caps[k]) and
// its [n, ok] to meta[2k], meta[2k+1].  flags bit 0: aligned, bit 1:
// final.  tile: bytes a tile (a multiple of 16); threads: 128 or 256 a
// block; cycles: null, or kPhases uint64 that the phases' clock cycles are
// added to (summed over blocks).  Returns the CUDA error code of the
// launch.
int hbt_record_scan(const void* data, const void* win_off, const void* win_len,
                    const void* chunk_len, const void* flags, const void* caps,
                    const void* row_base, void* rows, void* meta, long long n_chunks, int tile,
                    int threads, void* cycles, void* cuda_stream) {
  if (n_chunks <= 0) return 0;
  if (tile < 16 || tile % 16 != 0 || n_chunks > 0x7FFFFFFFLL ||
      smem_bytes(tile, threads) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  switch (threads) {
    case 128:
      return launch_timed<128>(data, win_off, win_len, chunk_len, flags, caps, row_base, rows,
                               meta, n_chunks, tile, cycles, s);
    case 256:
      return launch_timed<256>(data, win_off, win_len, chunk_len, flags, caps, row_base, rows,
                               meta, n_chunks, tile, cycles, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
