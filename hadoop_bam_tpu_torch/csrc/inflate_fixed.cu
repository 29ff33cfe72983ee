// Literal-only fixed-Huffman inflate for Hopper (sm_90a): one block a member
// over shared-memory rounds.
//
// inflate_fixed_kernel replaces hadoop_bam_tpu/ops/pallas/inflate_fixed.py
// (the kernel of _kernel_factory, launched by inflate_fixed_literal; the
// pallas_call at :140): single-block btype=01 members whose symbols are
// literals and one EOB, as ops.flate.deflate_fixed writes them.  The TPU
// kernel puts 128 members on the vector lanes, one token a wave.  Here a
// member gets a block: its stream is read in rounds of threads * seg bits,
// double-buffered in shared memory by 4-byte cp.async (transposed, so that
// each thread reads its own segment without bank conflicts); each thread
// maps its segment from each of the 9 offsets a symbol chain can enter; a
// block scan composes the maps into each segment's true entry and the
// literals before it, and each thread walks its segment again from there,
// writing its literals into a shared stage that goes to the row as 16-byte
// stores (inflate_fixed_core.cuh).
//
// Verdicts (ok = 0 and a zero row) are the plain version's: a header other
// than 011, a length code, an EOB ending past clens * 8, and a literal count
// other than ISIZE (the block stops at the round where it passes ISIZE).
//
// Bound: bytes (each member's stream read once, its row written once) over
// 3.35 TB/s.  The design before this one gave each member one thread that
// walked its ~24,000 symbols one after another (4.9 ms on an H100 at the
// codec's 2,797 members: 88 warps on the whole card).  Here a member's walk
// is split over a block's threads and the members run as blocks over every
// SM, but a segment is walked from each of its 9 entries: in record bytes
// (quality strings) a misaligned entry often decodes as literals for many
// symbols before it stops or meets entry 0's path, and a warp waits for its
// longest lane, so the map takes about 70% of the blocks' cycles and the
// launch ~0.70 ms on an H100 at 700 W (PERF.md).  The map's step keeps two
// stream words in registers and reloads one per 32 bits; entries 1-8 share
// one loop, so that a thread goes on to its next entry as soon as one ends.
//
// Geometry: 512-bit segments and 128 threads a block by default
// (ops/kernels/inflate_fixed.SEG, THREADS; on the H100 at the codec's
// members 0.70 ms, against 0.76 at 256-bit segments and 0.71 at 64 threads);
// the C entry takes another segment (a power of two, 32-1024 bits) and 32,
// 64, 128 or 256 threads.
//
// Plain C entry point (ctypes): device pointers and the stream as
// integers; returns cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "inflate_fixed_core.cuh"

namespace {

using namespace hbt_fixed;

constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

template <int kThreads, bool kTimed>
__global__ void __launch_bounds__(kThreads)
inflate_fixed_kernel(const uint8_t* __restrict__ comp, long long stride,
                     const int32_t* __restrict__ clens, const int32_t* __restrict__ isizes,
                     uint8_t* __restrict__ out, long long out_stride, uint8_t* __restrict__ ok,
                     int seg, unsigned long long* cyc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t i = blockIdx.x;
  const Geometry g = geometry(seg, kThreads);
  const Layout L = carve(smem, g);
  const Member m{comp + i * stride, static_cast<int32_t>(stride), member_bits(clens[i], stride),
                 isizes[i], out + i * out_stride, out_stride};
  const bool good = inflate_member<kTimed>(m, g, L, nullptr, cyc);
  if (threadIdx.x == 0) ok[i] = good;
}

template <int kThreads, bool kTimed>
int launch(const void* comp, long long stride, const void* clens, const void* isizes,
           long long n, void* out, long long out_stride, void* ok, int seg, void* cyc,
           cudaStream_t stream) {
  const int64_t smem = smem_bytes(seg, kThreads);
  auto kern = inflate_fixed_kernel<kThreads, kTimed>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<static_cast<unsigned>(n), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint8_t*>(comp), stride, static_cast<const int32_t*>(clens),
      static_cast<const int32_t*>(isizes), static_cast<uint8_t*>(out), out_stride,
      static_cast<uint8_t*>(ok), seg, static_cast<unsigned long long*>(cyc));
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads>
int launch_timed(const void* comp, long long stride, const void* clens, const void* isizes,
                 long long n, void* out, long long out_stride, void* ok, int seg, void* cyc,
                 cudaStream_t stream) {
  return cyc ? launch<kThreads, true>(comp, stride, clens, isizes, n, out, out_stride, ok, seg,
                                      cyc, stream)
             : launch<kThreads, false>(comp, stride, clens, isizes, n, out, out_stride, ok,
                                       seg, cyc, stream);
}

}  // namespace

extern "C" {

// Inflate n members: member i's stream is comp[i * stride ..] (stride a
// multiple of 16 below 2^28, 16-byte aligned), its compressed bytes
// clens[i] and payload isizes[i] (int32); its payload goes to
// out[i * out_stride ..] (out_stride a multiple of 16, at least every
// isize), zeros after it, and ok[i] (one byte).  seg: bits a segment (a
// power of two, 32-1024); threads: 32, 64, 128 or 256 a block; cycles:
// null, or kPhases uint64 that the phases' clock cycles are added to
// (summed over blocks).  Returns the CUDA error code of the launch.
int hbt_inflate_fixed_literal(const void* comp, long long stride, const void* clens,
                              const void* isizes, long long n, void* out, long long out_stride,
                              void* ok, int seg, int threads, void* cycles, void* cuda_stream) {
  if (n <= 0) return 0;
  if (seg < kMinSeg || seg > kMaxSeg || (seg & (seg - 1)) != 0 || stride < 0 || stride % 16 != 0 ||
      stride >= (1LL << 28) || out_stride % 16 != 0 || n > 0x7FFFFFFFLL ||
      smem_bytes(seg, threads) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  switch (threads) {
    case 32:
      return launch_timed<32>(comp, stride, clens, isizes, n, out, out_stride, ok, seg, cycles, s);
    case 64:
      return launch_timed<64>(comp, stride, clens, isizes, n, out, out_stride, ok, seg, cycles, s);
    case 128:
      return launch_timed<128>(comp, stride, clens, isizes, n, out, out_stride, ok, seg, cycles,
                               s);
    case 256:
      return launch_timed<256>(comp, stride, clens, isizes, n, out, out_stride, ok, seg, cycles,
                               s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
