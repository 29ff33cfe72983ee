// The part writer's two device passes for Hopper (sm_90a): the sorted
// record gather (with the duplicate-flag patch) and the per-member CRC32.
// The work of both is in write_core.cuh; this file holds the launches.
//
// gather_stream_kernel replaces hadoop_bam_tpu/ops/pallas/gather_stream.py
// (gather_stream_device, :93), an XLA program with no pallas_call: there,
// every output byte finds its record with a batched searchsorted over the
// sorted destination offsets and then gathers one byte.  Here the output is
// cut into tiles of T bytes (default 2048) and a block owns a tile: a first
// pass, one thread a record, writes each tile's first record; then each
// thread of the tile's block builds a run of whole 16-byte output chunks,
// finds its first chunk's record by a binary search of the destination ends
// between its tile's first record and the next tile's (the reference's
// searchsorted, once a run and not once a byte; the chunks after it go on
// from the record the one before ended in), reads the source bytes as
// aligned 16-byte loads re-aligned by funnel shifts, ORs the duplicate flag
// into bytes 18 and 19 in registers and stores the chunk as one aligned
// 16-byte store.  Bound:
// bytes (each record read once and written once, plus its columns) over
// 3.35 TB/s.  The design before this one gave each record a warp that
// copied one byte a lane an instruction.
//
// crc32_members_kernel replaces hadoop_bam_tpu/ops/pallas/crc32.py
// (crc32_device, :131), also plain XLA, which advances every member one
// 32-bit word per fori_loop step in lockstep.  Here a block takes a member
// (the grid is as many blocks as fit the card at once, each looping over
// members): it stages the member in rounds of threads * w bytes (default 128
// threads, w = 32) through two shared-memory buffers by 16-byte cp.async,
// each thread folds its own w bytes of a round with slicing-by-4 tables and
// shifts its register by the round between pieces, and a tree of constant
// shifts, across warp shuffles and then across the warps, combines the
// threads' registers into the member's CRC.  Bound: the member bytes read
// once over 3.35 TB/s.  The design before this one gave each member one
// thread (eight blocks for a part's ~920 members).
//
// Plain C entry points (ctypes): device pointers and the stream as
// integers; each returns cudaGetLastError() of its launches.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "write_core.cuh"

namespace {

using namespace hbt_write;

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kTileThreads = 256;  // the tile-map pass

__global__ void __launch_bounds__(kTileThreads) gather_tiles_kernel(GatherArgs a, int32_t* tf) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r < a.n) tile_first_of(a, tf, r);
}

// The wrapper's checks over the host columns as uploaded (int64): the sum
// of lens, the largest src + lens and the smallest src or lens, reduced a
// warp at a time into stats (initialised to 0, INT64_MIN, INT64_MAX); lens
// also go out as int32 for the gather.
__global__ void __launch_bounds__(kTileThreads)
gather_check_kernel(const int64_t* __restrict__ src, const int64_t* __restrict__ lens,
                    long long n, int32_t* __restrict__ lens32, long long* __restrict__ stats) {
  long long sum = 0, hi = LLONG_MIN, lo = LLONG_MAX;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long s = src[i], l = lens[i];
    sum += l;
    hi = max(hi, s + l);
    lo = min(lo, min(s, l));
    lens32[i] = static_cast<int32_t>(l);
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, o);
    hi = max(hi, __shfl_down_sync(0xFFFFFFFFu, hi, o));
    lo = min(lo, __shfl_down_sync(0xFFFFFFFFu, lo, o));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(stats), static_cast<unsigned long long>(sum));
    atomicMax(stats + 1, hi);
    atomicMin(stats + 2, lo);
  }
}

__global__ void __launch_bounds__(kMaxThreads) gather_stream_kernel(GatherArgs a) {
  gather_tile(a, blockIdx.x, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kMaxThreads)
crc32_members_kernel(const uint8_t* __restrict__ stream, long long numel,
                     const int64_t* __restrict__ offs, const int32_t* __restrict__ lens,
                     long long n, uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ consts, int w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const CrcGeometry g = crc_geometry(blockDim.x, w);
  const CrcLayout L = crc_carve(smem, g);
  load_consts(L, consts, consts_words(g.nth), threadIdx.x, g.nth);
  __syncthreads();
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    const CrcMember m{stream, numel, offs[i], lens[i], out + i};
    crc_member(m, g, L, nullptr);
  }
}

bool valid_threads(int threads) {
  return threads == 32 || threads == 64 || threads == 128 || threads == 256;
}

}  // namespace

extern "C" {

// out[dst_end[r] - lens[r] .. dst_end[r]) = stream[src[r] .. + lens[r]) for
// r < n_rec, with the low and high bytes of `bits` ORed into bytes 18 and 19
// of records whose dup[r] is set (dup may be null).  stream holds numel
// bytes (any alignment); src int64, lens int32 (>= 0), dst_end int32 (the
// inclusive prefix sum of lens, total at the end); out 16-byte aligned, of
// total bytes.  tile_first: int32 scratch of ceil(total / tile) entries;
// tile: bytes a block (a multiple of 16); threads: 32, 64, 128 or 256 a
// block.  Returns the CUDA error code of the launches.
int hbt_gather_stream(const void* stream, long long numel, const void* src, const void* lens,
                      const void* dst_end, const void* dup, long long n_rec, int bits, void* out,
                      long long total, void* tile_first, int tile, int threads,
                      void* cuda_stream) {
  if (n_rec <= 0 || total <= 0) return 0;
  if (tile < 16 || tile % 16 != 0 || !valid_threads(threads) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (total + tile - 1) / tile;
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  GatherArgs a;
  a.stream = static_cast<const uint8_t*>(stream);
  a.numel = numel;
  a.src = static_cast<const int64_t*>(src);
  a.lens = static_cast<const int32_t*>(lens);
  a.dst_end = static_cast<const int32_t*>(dst_end);
  a.dup = static_cast<const uint8_t*>(dup);
  a.n = n_rec;
  a.lo = static_cast<uint32_t>(bits) & 0xFFu;
  a.hi = (static_cast<uint32_t>(bits) >> 8) & 0xFFu;
  a.out = static_cast<uint8_t*>(out);
  a.total = total;
  a.tile_first = static_cast<const int32_t*>(tile_first);
  a.tile = tile;
  a.tiles = tiles;
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const long long blocks = (n_rec + kTileThreads - 1) / kTileThreads;
  gather_tiles_kernel<<<static_cast<unsigned>(blocks), kTileThreads, 0, s>>>(
      a, static_cast<int32_t*>(tile_first));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gather_stream_kernel<<<static_cast<unsigned>(tiles), threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The gather's checks on the card: stats (int64 [3], set to 0, INT64_MIN,
// INT64_MAX) gets the sum of lens, the largest src[r] + lens[r] and the
// smallest of every src and lens; lens32 gets lens as int32.  src and lens
// int64 [n].  Returns the CUDA error code of the launch.
int hbt_gather_check(const void* src, const void* lens, long long n, void* lens32, void* stats,
                     void* cuda_stream) {
  if (n <= 0) return 0;
  const long long want = (n + kTileThreads - 1) / kTileThreads;
  const unsigned grid = static_cast<unsigned>(want < 1056 ? want : 1056);
  gather_check_kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int64_t*>(src), static_cast<const int64_t*>(lens), n,
      static_cast<int32_t*>(lens32), static_cast<long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// out[i] = CRC32 of stream[offs[i] .. + lens[i]) (zlib's polynomial; 0 for an
// empty member) for i < n.  stream holds numel bytes (any alignment; no
// byte outside it is read); offs int64, lens int32; consts: the
// kernel's constants for (threads, w) as ops/kernels/crc32.py builds them
// (device memory); threads: 32, 64, 128 or 256 a block; w: bytes a thread a
// round (16, 32, 64, 128 or 256).  Returns the CUDA error code of the launch.
int hbt_crc32_members(const void* stream, long long numel, const void* offs, const void* lens,
                      long long n, void* out, const void* consts, int threads, int w,
                      void* cuda_stream) {
  if (n <= 0) return 0;
  if (!valid_threads(threads) || w < 16 || w > 256 || (w & (w - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = crc_smem_bytes(threads, w);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        crc32_members_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc32_members_kernel, threads,
                                                      static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(n < fit ? n : fit);
  crc32_members_kernel<<<grid, threads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream), numel, static_cast<const int64_t*>(offs),
      static_cast<const int32_t*>(lens), n, static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(consts), w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
