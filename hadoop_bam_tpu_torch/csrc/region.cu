// Region-plane kernels for Hopper (sm_90a): the record/interval overlap
// cut, the masked quality histogram and the BAM nibble unpack.
//
// overlap_kernel replaces hadoop_bam_tpu/ops/pallas/overlap.py
// (_overlap_call / overlap_mask): out[i] = 1 when record i's [start, end)
// on refid overlaps any of the K query intervals (refid, beg, end).  The
// TPU kernel tiles the records [8, 128] and unrolls K from SMEM; here one
// thread takes one record and the block stages the intervals into shared
// memory, kOverlapChunk at a time, so K is unbounded.  Bound: bytes (12
// read and 1 written per record, a few operations per interval).
//
// histogram_kernel replaces hadoop_bam_tpu/ops/pallas/histogram.py
// (quality_histogram): int32 counts of values in [0, nbins) where valid
// != 0.  The TPU kernel puts the bins on the lanes and compares every
// value with every bin; here each block keeps a shared int32[nbins]
// histogram fed by shared-memory atomics over a grid-stride loop, then
// adds it to the global one with one atomic per nonzero bin.  Bound:
// bytes (8 read per value); quality values cluster on ~40 bins, so the
// shared atomics contend.
//
// unpack_kernel replaces hadoop_bam_tpu/ops/pallas/unpack.py
// (unpack_nibbles): int32 [B, 2W] codes from [B, W] packed bytes, high
// nibble first.  One thread per packed element writes an int2 (hi, lo);
// the TPU kernel's two planes and the interleave outside it become one
// store.  Bound: bytes (1 or 4 read, 8 written per packed element).
//
// Plain C entry points (ctypes): device pointers and the stream as
// integers; each returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOverlapChunk = 1024;  // intervals staged per pass: 12 KiB

__global__ void overlap_kernel(const int* __restrict__ iv, int k,
                               const int* __restrict__ refid,
                               const int* __restrict__ start,
                               const int* __restrict__ end, long long n,
                               uint8_t* __restrict__ out) {
  __shared__ int s_iv[3 * kOverlapChunk];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  int r = 0, s = 0, e = 0;
  if (live) {
    r = refid[i];
    s = start[i];
    e = end[i];
  }
  uint8_t hit = 0;
  for (int c0 = 0; c0 < k; c0 += kOverlapChunk) {
    const int m = min(kOverlapChunk, k - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < 3 * m; j += blockDim.x) s_iv[j] = iv[3 * c0 + j];
    __syncthreads();
    if (live && !hit) {
      for (int j = 0; j < m; ++j) {
        if (r == s_iv[3 * j] && s < s_iv[3 * j + 2] && e > s_iv[3 * j + 1]) {
          hit = 1;
          break;
        }
      }
    }
  }
  if (live) out[i] = hit;
}

__global__ void histogram_kernel(const int* __restrict__ values,
                                 const int* __restrict__ valid, long long total,
                                 int nbins, int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int v = values[i];
    if (valid[i] != 0 && v >= 0 && v < nbins) atomicAdd(&hist[v], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    const int h = hist[b];
    if (h) atomicAdd(&out[b], h);
  }
}

template <typename T>
__global__ void unpack_kernel(const T* __restrict__ packed, long long total,
                              int2* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int p = (int)packed[i];
  out[i] = make_int2((p >> 4) & 0xF, p & 0xF);
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int hbt_overlap_mask(const void* iv, int k, const void* refid,
                                const void* start, const void* end, long long n,
                                void* out, void* stream) {
  if (n <= 0) return 0;
  overlap_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)iv, k, (const int*)refid, (const int*)start, (const int*)end, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int hbt_quality_histogram(const void* values, const void* valid,
                                     long long total, int nbins, void* out,
                                     void* stream) {
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;  // grid-stride: a few blocks per SM
  histogram_kernel<<<(int)blocks, kThreads, nbins * sizeof(int), (cudaStream_t)stream>>>(
      (const int*)values, (const int*)valid, total, nbins, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int hbt_unpack_nibbles_u8(const void* packed, long long total, void* out,
                                     void* stream) {
  if (total <= 0) return 0;
  unpack_kernel<uint8_t><<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, total, (int2*)out);
  return (int)cudaGetLastError();
}

extern "C" int hbt_unpack_nibbles_i32(const void* packed, long long total, void* out,
                                      void* stream) {
  if (total <= 0) return 0;
  unpack_kernel<int><<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)packed, total, (int2*)out);
  return (int)cudaGetLastError();
}
