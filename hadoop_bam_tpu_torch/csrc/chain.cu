// BAM record chain for Hopper (sm_90a): the record-boundary walk and the
// sort-key gather over one split's inflated record stream.
//
// Replaces the TPU kernel hadoop_bam_tpu/ops/pallas/chain.py (_chain_kernel,
// _chain_chunk and _chain_all) and the XLA key gather it feeds,
// hadoop_bam_tpu/ops/decode.py _stream_keys with ops/keys.py make_keys and
// unmapped_mask.  The TPU walk ran over 4 MiB chunks with the cursor carried
// between sequential grid steps, in int32; here one block walks the whole
// stream with int64 offsets, so the 2 GiB domain and the per-chunk record
// cap fall away.
//
// chain_walk_kernel (one block, one walking lane): pos += 4 + u32(pos)
// from 0 while pos < n_bytes.  A size word below 32 (the fixed fields) or
// above 2^28 is an error and stops the walk; bytes at or past n_bytes read
// as 0, as the TPU kernel's zero padding did.  meta = {count, ok} with ok =
// no error and the cursor landing exactly on n_bytes.
//
// stream_keys_kernel (one thread per record): refid, pos and flag at
// offs[i] + 4 → the packed int64 sort key (Java's (long)refIdx << 32 | pos0,
// sign extension of a negative low word included) and the unmapped mask
// (flag 0x4, refid < 0, or pos + 1 < 0 in int32 arithmetic).  Unmapped rows
// carry key INT_MAX << 32 until the host murmur3 hash is patched in.
//
// Bound on this card: (4 B size word read + 8 B offset written) per record
// for the walk and (8 B offset + 10 B of fields read, 8 B key + 1 B mask
// written) per record for the gather, over 3.35 TB/s.  The walk is
// latency-bound: each record is one dependent load.  It reads its size
// words from shared-memory tiles the block stages with coalesced loads,
// so the dependent load is a shared-memory one, not a device-memory miss.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMinBody = 32;
constexpr uint32_t kMaxBody = 1u << 28;

__device__ __forceinline__ uint32_t le_at(const uint8_t* s, int64_t at,
                                          int64_t n, int nbytes) {
  uint32_t v = 0;
  for (int k = 0; k < nbytes; ++k) {
    const int64_t p = at + k;
    const uint32_t b = p < n ? s[p] : 0u;
    v |= b << (8 * k);
  }
  return v;
}

// The walk stages the stream through shared memory: the block loads a
// kTile-byte tile at the cursor with coalesced 16-byte loads, then lane 0
// walks every size word that lies whole in the tile, then the block loads
// the tile at the new cursor.  A size word costs a shared-memory load
// instead of a device-memory round trip.
constexpr int kWalkThreads = 256;
constexpr int64_t kTile = 32768;
constexpr int kVecsPerThread = kTile / (16 * kWalkThreads);

__global__ void __launch_bounds__(kWalkThreads)
chain_walk_kernel(const uint8_t* __restrict__ s, int64_t n_bytes,
                  int64_t* __restrict__ offs, int64_t* __restrict__ meta) {
  __shared__ __align__(16) uint8_t tile[kTile];
  __shared__ int64_t sh_cur, sh_count;
  __shared__ int sh_err;
  if (threadIdx.x == 0) {
    sh_cur = 0;
    sh_count = 0;
    sh_err = 0;
  }
  __syncthreads();
  const uintptr_t s_addr = reinterpret_cast<uintptr_t>(s);
  for (;;) {
    const int64_t cur = sh_cur;
    if (sh_err || cur >= n_bytes) break;
    // Tile start, as a stream offset: the cursor rounded down to a 16-byte
    // address (at most 15 bytes before it, inside the same allocation).
    const int64_t tb =
        static_cast<int64_t>(((s_addr + cur) & ~uintptr_t(15)) - s_addr);
    // All of a thread's loads are issued before any is stored, so the
    // whole tile is one device-memory round trip.
    uint4 v[kVecsPerThread];
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
      const int64_t p = tb + 16 * (threadIdx.x + j * kWalkThreads);
      if (p + 16 <= n_bytes) {
        v[j] = *reinterpret_cast<const uint4*>(s + p);
      } else {
        uint8_t b[16];
        for (int q = 0; q < 16; ++q) b[q] = p + q < n_bytes ? s[p + q] : 0;
        memcpy(&v[j], b, 16);
      }
    }
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j)
      reinterpret_cast<uint4*>(tile)[threadIdx.x + j * kWalkThreads] = v[j];
    __syncthreads();
    if (threadIdx.x == 0) {
      int64_t c = cur, count = sh_count;
      while (c < n_bytes && c - tb + 4 <= kTile) {
        const uint8_t* w = tile + (c - tb);
        const uint32_t bs = w[0] | (w[1] << 8) | (w[2] << 16) |
                            (static_cast<uint32_t>(w[3]) << 24);
        if (bs < kMinBody || bs > kMaxBody) {
          sh_err = 1;
          break;
        }
        offs[count++] = c;
        c += 4 + static_cast<int64_t>(bs);
      }
      sh_cur = c;
      sh_count = count;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    meta[0] = sh_count;
    meta[1] = (!sh_err && sh_cur == n_bytes) ? 1 : 0;
  }
}

__global__ void stream_keys_kernel(const uint8_t* __restrict__ s,
                                   int64_t n_bytes,
                                   const int64_t* __restrict__ offs,
                                   const int64_t* __restrict__ meta,
                                   int64_t n_rows, int64_t* __restrict__ keys,
                                   uint8_t* __restrict__ unmapped) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  if (i >= meta[0]) {
    keys[i] = 0;
    unmapped[i] = 0;
    return;
  }
  const int64_t body = offs[i] + 4;
  const int32_t refid = static_cast<int32_t>(le_at(s, body, n_bytes, 4));
  const int32_t pos = static_cast<int32_t>(le_at(s, body + 4, n_bytes, 4));
  const uint32_t flag = le_at(s, body + 14, n_bytes, 2);
  const int32_t pos1 = static_cast<int32_t>(static_cast<uint32_t>(pos) + 1u);
  const bool unm = (flag & 0x4u) != 0 || refid < 0 || pos1 < 0;
  const int32_t sel_hi = unm ? 0x7fffffff : refid;
  const int32_t sel_lo = unm ? 0 : pos;
  const int32_t hi = sel_lo < 0 ? -1 : sel_hi;
  keys[i] = static_cast<int64_t>((static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
                                 static_cast<uint32_t>(sel_lo));
  unmapped[i] = unm ? 1 : 0;
}

}  // namespace

extern "C" {

// offs holds >= n_bytes / 36 + 1 entries (a record takes >= 36 bytes);
// meta is int64[2].  Returns the CUDA error code of the launch.
int hbt_chain_walk(const void* stream_bytes, long long n_bytes, void* offs,
                   void* meta, void* stream) {
  chain_walk_kernel<<<1, kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(stream_bytes), n_bytes,
      static_cast<int64_t*>(offs), static_cast<int64_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

// Keys of rows [0, n_rows); rows at or past meta[0] get key 0, unmapped 0.
int hbt_stream_keys(const void* stream_bytes, long long n_bytes,
                    const void* offs, const void* meta, long long n_rows,
                    void* keys, void* unmapped, void* stream) {
  if (n_rows <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n_rows + threads - 1) / threads;
  stream_keys_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(stream_bytes), n_bytes,
      static_cast<const int64_t*>(offs), static_cast<const int64_t*>(meta),
      n_rows, static_cast<int64_t*>(keys), static_cast<uint8_t*>(unmapped));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
