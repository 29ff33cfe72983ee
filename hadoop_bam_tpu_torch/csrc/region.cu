// Region-plane kernels for Hopper (sm_90a): the record/interval overlap
// cut, the masked quality histogram and the BAM nibble unpack.
//
// The overlap cut replaces hadoop_bam_tpu/ops/pallas/overlap.py
// (_overlap_call / overlap_mask) and the caller's np.nonzero of its mask.
// The TPU kernel tiles the records [8, 128], unrolls K from SMEM and hands
// back a mask, one launch a chunk span of the view.  Here the view is cut
// once: the count, scan and scatter launches of region_core.cuh read the
// view's raw columns (refid, pos, ref_len), apply the span rule inside the
// kernel and write the hit rows compacted and in order, with their count
// (hbt_overlap_rows).  Bound: bytes (12 read a record, 4 written a hit);
// at a view's tens of thousands of records that is well under a launch,
// so the design spends launches and host work, not bandwidth: one upload
// of the view's packed columns, three launches, one read-back.
// overlap_kernel keeps the mask form (out[i] = 1 when record i's [start,
// end) on refid overlaps an interval), one thread a record over the same
// staged intervals.
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

#include "region_core.cuh"

namespace {

using namespace hbt_region;

__global__ void overlap_kernel(const int* __restrict__ iv, int k,
                               const int* __restrict__ refid,
                               const int* __restrict__ start,
                               const int* __restrict__ end, long long n,
                               uint8_t* __restrict__ out) {
  __shared__ int s_iv[3 * kOverlapChunk];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const Span x = live ? Span{refid[i], start[i], end[i], true} : Span{0, 0, 0, false};
  bool hit = false;
  for (int c0 = 0; c0 < k; c0 += kOverlapChunk) {
    const int m = min(kOverlapChunk, k - c0);
    __syncthreads();
    stage_intervals(iv, c0, m, s_iv, threadIdx.x, blockDim.x);
    __syncthreads();
    if (!hit) hit = hits(x, s_iv, m);
  }
  if (live) out[i] = hit;
}

__global__ void __launch_bounds__(1024) cut_count_kernel(Cut c) {
  __shared__ int32_t s_iv[3 * kOverlapChunk];
  __shared__ int32_t wc[kMaxWarps];
  count_block(c, blockIdx.x, s_iv, wc, nullptr);
}

__global__ void __launch_bounds__(kScanThreads) cut_scan_kernel(int32_t* blk, long long nb,
                                                                int32_t* out) {
  __shared__ int32_t part[kScanThreads], tmp[kScanThreads];
  scan_blocks(blk, nb, out, part, tmp, kScanThreads);
}

__global__ void __launch_bounds__(1024) cut_scatter_kernel(Cut c) {
  __shared__ uint32_t word[kMaxWarps];
  __shared__ int32_t woff[kMaxWarps];
  scatter_block(c, blockIdx.x, word, woff);
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

// The overlap cut of a view: the rows (int32) of the n records whose span
// [pos, pos + max(len, 1)) on refid (pos >= 0) overlaps one of the k
// intervals, in order, to out[1 ..], and their count to out[0].  work
// holds (n + 31) / 32 + blocks int32 (blocks = ceil(n / threads)); threads
// is 32 to 1,024, a multiple of 32.  Three launches: count, scan, scatter.
extern "C" int hbt_overlap_rows(const void* iv, int k, const void* refid, const void* pos,
                                const void* len, long long n, void* out, void* work,
                                int threads, void* stream) {
  if (threads < 32 || threads > 32 * kMaxWarps || threads % 32 != 0 || n < 0 || n > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) {
    cudaMemsetAsync(out, 0, sizeof(int32_t), st);
    return (int)cudaGetLastError();
  }
  Cut c;
  c.iv = (const int32_t*)iv;
  c.k = k;
  c.refid = (const int32_t*)refid;
  c.pos = (const int32_t*)pos;
  c.len = (const int32_t*)len;
  c.n = n;
  c.nth = threads;
  c.bits = (uint32_t*)work;
  c.blk = (int32_t*)work + words(n);
  c.out = (int32_t*)out;
  const long long nb = blocks(c);
  cut_count_kernel<<<(unsigned)nb, threads, 0, st>>>(c);
  cut_scan_kernel<<<1, kScanThreads, 0, st>>>(c.blk, nb, c.out);
  cut_scatter_kernel<<<(unsigned)nb, threads, 0, st>>>(c);
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
