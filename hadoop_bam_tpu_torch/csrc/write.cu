// The part writer's two device passes for Hopper (sm_90a): the sorted
// record gather (with the duplicate-flag patch) and the per-member CRC32.
//
// gather_stream_kernel replaces hadoop_bam_tpu/ops/pallas/gather_stream.py
// (gather_stream_device, :93), an XLA program with no pallas_call: there,
// every output byte finds its record with a batched searchsorted over the
// sorted destination offsets and then gathers one byte.  Here each warp
// owns whole records (grid-stride over records), so no search exists: lane
// k copies bytes k, k + 32, ... of its record from stream[src] to
// out[dst].  When dup[r] is set the low and high bytes of `bits` are ORed
// into record bytes 18 and 19 (the BAM flag, body offset 14), the device
// form of io/bam.py patch_flags.  Bound: bytes (each record read once and
// written once, plus its columns) over 3.35 TB/s; the byte-wide copy keeps
// it from that bound (one byte per lane per instruction), and wider copies
// need source and destination to share an alignment, which records do not.
//
// crc32_members_kernel replaces hadoop_bam_tpu/ops/pallas/crc32.py
// (crc32_device, :131), also plain XLA, which advances every member one
// 32-bit word per fori_loop step in lockstep.  Here one thread owns one
// member and runs the same slicing-by-4 recurrence
//     c ^= word;  c = T3[c & ff] ^ T2[(c >> 8) & ff] ^ T1[(c >> 16) & ff] ^ T0[c >> 24]
// over 16-byte loads, with bytewise steps for the unaligned head and the
// tail; the four 256-entry tables are built in shared memory by each block.
// Bound: the member bytes read once over 3.35 TB/s; one serial chain per
// member keeps it far from that (a part has about 900 members, so about 900
// threads on a card of 132 SMs).  Splitting members and combining partial
// CRCs is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kCrcThreads = 128;

__global__ void __launch_bounds__(kGatherThreads)
gather_stream_kernel(const uint8_t* __restrict__ stream,
                     const int64_t* __restrict__ src,
                     const int64_t* __restrict__ dst,
                     const int32_t* __restrict__ lens,
                     const uint8_t* __restrict__ dup, int64_t n_rec, int bits,
                     uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  const uint8_t lo = static_cast<uint8_t>(bits & 0xFF);
  const uint8_t hi = static_cast<uint8_t>((bits >> 8) & 0xFF);
  for (int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
       r < n_rec; r += warps) {
    const uint8_t* s = stream + src[r];
    uint8_t* d = out + dst[r];
    const int32_t n = lens[r];
    const bool mark = dup != nullptr && dup[r] != 0;
    for (int32_t k = lane; k < n; k += 32) {
      uint8_t v = s[k];
      if (mark) {
        if (k == 18) v |= lo;
        if (k == 19) v |= hi;
      }
      d[k] = v;
    }
  }
}

__device__ __forceinline__ uint32_t crc_byte(const uint32_t* t0, uint32_t c, uint32_t b) {
  return (c >> 8) ^ t0[(c ^ b) & 0xFFu];
}

__device__ __forceinline__ uint32_t crc_word(const uint32_t* t, uint32_t c, uint32_t w) {
  c ^= w;
  return t[768 + (c & 0xFFu)] ^ t[512 + ((c >> 8) & 0xFFu)] ^
         t[256 + ((c >> 16) & 0xFFu)] ^ t[c >> 24];
}

__global__ void __launch_bounds__(kCrcThreads)
crc32_members_kernel(const uint8_t* __restrict__ stream,
                     const int64_t* __restrict__ offs,
                     const int32_t* __restrict__ lens, int64_t n,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t t[4 * 256];  // T0 | T1 | T2 | T3
  for (int k = threadIdx.x; k < 256; k += blockDim.x) {
    uint32_t c = static_cast<uint32_t>(k);
    for (int j = 0; j < 8; ++j) c = (c >> 1) ^ ((c & 1u) ? 0xEDB88320u : 0u);
    t[k] = c;
  }
  __syncthreads();
  for (int s = 1; s < 4; ++s) {
    for (int k = threadIdx.x; k < 256; k += blockDim.x) {
      const uint32_t prev = t[256 * (s - 1) + k];
      t[256 * s + k] = (prev >> 8) ^ t[prev & 0xFFu];
    }
    __syncthreads();
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* p = stream + offs[i];
  const uint8_t* end = p + lens[i];
  uint32_t c = 0xFFFFFFFFu;
  while (p < end && (reinterpret_cast<uintptr_t>(p) & 15) != 0) c = crc_byte(t, c, *p++);
#pragma unroll 2
  for (; p + 16 <= end; p += 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    c = crc_word(t, c, v.x);
    c = crc_word(t, c, v.y);
    c = crc_word(t, c, v.z);
    c = crc_word(t, c, v.w);
  }
  while (p < end) c = crc_byte(t, c, *p++);
  out[i] = c ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" {

// out[dst[r] .. + lens[r]) = stream[src[r] .. + lens[r]) for r < n_rec, with
// `bits` ORed into bytes 18/19 of records whose dup[r] is set (dup may be
// null).  Returns the CUDA error code of the launch.
int hbt_gather_stream(const void* stream, const void* src, const void* dst,
                      const void* lens, const void* dup, long long n_rec,
                      int bits, void* out, void* cuda_stream) {
  if (n_rec <= 0) return 0;
  const long long per_block = kGatherThreads / 32;
  const long long blocks = (n_rec + per_block - 1) / per_block;
  const unsigned grid = static_cast<unsigned>(blocks < 1048576 ? blocks : 1048576);
  gather_stream_kernel<<<grid, kGatherThreads, 0,
                         static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream), static_cast<const int64_t*>(src),
      static_cast<const int64_t*>(dst), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(dup), static_cast<int64_t>(n_rec), bits,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out[i] = CRC32 of stream[offs[i] .. + lens[i]) (zlib's polynomial; 0 for an
// empty member).  Returns the CUDA error code of the launch.
int hbt_crc32_members(const void* stream, const void* offs, const void* lens,
                      long long n, void* out, void* cuda_stream) {
  if (n <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kCrcThreads - 1) / kCrcThreads);
  crc32_members_kernel<<<grid, kCrcThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream), static_cast<const int64_t*>(offs),
      static_cast<const int32_t*>(lens), static_cast<int64_t>(n),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
