// BCF record chain for Hopper (sm_90a): the record-boundary walk over an
// inflated BCF payload and the six fixed shared words of every record.
//
// Replaces the TPU kernel hadoop_bam_tpu/ops/pallas/bcf_chain.py
// (_bcf_chain_kernel, _bcf_chain_chunk and _bcf_chain_all, reached through
// walk_chain_device).  Records are [u32 l_shared][u32 l_indiv][shared]
// [indiv] back to back; the walk starts at `start` and keeps starting
// records while pos + 8 <= limit, stepping pos += 8 + l_shared + l_indiv.
// Each record emits seven int32 columns: its start offset and the six
// fixed shared words (CHROM, POS, rlen, QUAL bits, n_allele<<16|n_info,
// n_fmt<<24|n_sample), reinterpreted from u32 as the host walk does.
// Validity is framing only: l_shared < 24 or >= 2^24, l_indiv >= 2^28 (or
// negative as int32), or a record running past the whole payload
// (pos + 8 + l_shared + l_indiv > n) stops the walk with an error.  The
// straddling tail record completes from the bytes past `limit`.  Bytes
// past n read as 0.  meta = {count, ok}, ok = no error and the cursor
// ended with cursor + 8 > limit.
//
// The TPU walk ran over 4 MiB chunks with the cursor carried between
// sequential grid steps, each chunk holding at most MAX_REC_PER_CHUNK =
// 131,200 records, in int32.  Here one block walks the whole window with
// int64 offsets.  The chunk cap never bound: a record is at least 32 bytes
// (8 bytes of lengths and the 24 fixed shared bytes) and a chunk's records
// start inside its 4 MiB, so a chunk starts at most 4 MiB / 32 = 131,072
// records.  The int32 columns keep the reference's payload domain; the
// wrapper sends a payload past 2^31 - 2^29 bytes to the host walk before
// any launch.
//
// Design: the block loads a 32 KiB tile at the cursor with coalesced
// 16-byte loads; lane 0 walks every record whose length words lie in the
// tile, reading them from shared memory, and lists the starts; then all
// 256 threads gather the six words of the listed records (from the tile,
// or from device memory for a record whose fixed fields run past it) and
// write the columns, neighbouring threads on neighbouring rows.
//
// Bound on this card: per record 8 B of lengths and 24 B of fixed fields
// read and 28 B of columns written, over 3.35 TB/s.  The walk is
// latency-bound (each record's start depends on the previous record's
// lengths): the staging turns that dependent load into a shared-memory
// one, and the gather is spread over the block's 256 threads.  One block
// uses one SM; a faster walk is later work.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMinShared = 24;
constexpr uint32_t kMaxShared = 1u << 24;
constexpr uint32_t kMaxIndiv = 1u << 28;
constexpr int kThreads = 256;
constexpr int64_t kTile = 32768;
constexpr int kVecsPerThread = kTile / (16 * kThreads);
// Records whose length words lie whole in one tile: starts at least 32
// bytes apart inside kTile bytes.
constexpr int kMaxPerTile = kTile / 32 + 1;

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

__device__ __forceinline__ uint32_t le32_at(const uint8_t* s, int64_t at, int64_t n) {
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k) {
    const int64_t p = at + k;
    v |= (p < n ? static_cast<uint32_t>(s[p]) : 0u) << (8 * k);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
bcf_chain_kernel(const uint8_t* __restrict__ s, int64_t n, int64_t start,
                 int64_t limit, int32_t* __restrict__ cols, int64_t cap,
                 int64_t* __restrict__ meta) {
  __shared__ __align__(16) uint8_t tile[kTile];
  __shared__ int64_t found[kMaxPerTile];
  __shared__ int64_t sh_cur, sh_count;
  __shared__ int sh_err, sh_found;
  if (threadIdx.x == 0) {
    sh_cur = start;
    sh_count = 0;
    sh_err = 0;
  }
  __syncthreads();
  const uintptr_t s_addr = reinterpret_cast<uintptr_t>(s);
  for (;;) {
    const int64_t cur = sh_cur;
    if (sh_err || cur + 8 > limit) break;
    // Tile start: the cursor rounded down to a 16-byte address (at most 15
    // bytes before it, inside the allocation), so the first record's
    // length words always lie in the tile and every pass makes progress.
    const int64_t tb =
        static_cast<int64_t>(((s_addr + cur) & ~uintptr_t(15)) - s_addr);
    uint4 v[kVecsPerThread];
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
      const int64_t p = tb + 16 * (threadIdx.x + j * kThreads);
      if (p + 16 <= n) {
        v[j] = *reinterpret_cast<const uint4*>(s + p);
      } else {
        uint8_t b[16];
        for (int q = 0; q < 16; ++q) b[q] = p + q < n ? s[p + q] : 0;
        memcpy(&v[j], b, 16);
      }
    }
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j)
      reinterpret_cast<uint4*>(tile)[threadIdx.x + j * kThreads] = v[j];
    __syncthreads();
    if (threadIdx.x == 0) {
      int64_t c = cur;
      int k = 0;
      while (c + 8 <= limit && c - tb + 8 <= kTile) {
        const uint32_t l_shared = le32(tile + (c - tb));
        const uint32_t l_indiv = le32(tile + (c - tb) + 4);
        if (l_shared < kMinShared || l_shared >= kMaxShared ||
            l_indiv >= kMaxIndiv ||
            c + 8 + static_cast<int64_t>(l_shared) + l_indiv > n) {
          sh_err = 1;
          break;
        }
        found[k++] = c;
        c += 8 + static_cast<int64_t>(l_shared) + l_indiv;
      }
      sh_found = k;
      sh_cur = c;
    }
    __syncthreads();
    const int nf = sh_found;
    const int64_t base = sh_count;
    for (int j = threadIdx.x; j < nf; j += kThreads) {
      const int64_t c = found[j];
      const int64_t row = base + j;
      cols[row] = static_cast<int32_t>(c);
      // A valid record's 24 fixed bytes lie inside the payload.
      const bool in_tile = c + 32 - tb <= kTile;
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        const int64_t at = c + 8 + 4 * f;
        const uint32_t w = in_tile ? le32(tile + (at - tb)) : le32_at(s, at, n);
        cols[(1 + f) * cap + row] = static_cast<int32_t>(w);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) sh_count = base + nf;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    meta[0] = sh_count;
    meta[1] = (!sh_err && sh_cur + 8 > limit) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// cols is int32[7][cap] with cap >= (limit - start) / 32 + 1 (records are
// at least 32 bytes apart); meta is int64[2].  Returns the CUDA error code
// of the launch.
int hbt_bcf_chain_walk(const void* payload, long long n, long long start,
                       long long limit, void* cols, long long cap, void* meta,
                       void* stream) {
  bcf_chain_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), n, start, limit,
      static_cast<int32_t*>(cols), cap, static_cast<int64_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
