// The lockstep-walk probe for Hopper (sm_90a).
//
// Replaces hadoop_bam_tpu/ops/pallas/inflate_probe.py (the kernel of
// _walk_kernel_factory, launched by make_walk): 128 lanes, each with a bit
// cursor into its column of a transposed int32 [R, 128] stream, run T
// waves of: the two words under the cursor (0 outside [0, R)), a 32-bit
// window, a 15-class range-compare "decode", cur += length + (win & 7),
// acc += win with int32 wrap.  The TPU kernel extracts each lane's word by
// an iota-compare reduction over the whole [R, 128] tile every wave; here
// one thread a lane loads its two words directly.
//
// Bound: latency.  Each wave's loads depend on the previous wave's cursor,
// so a wave costs two dependent L2 round trips (issued together) plus the
// compare chain.  The stream (2 MiB at R = 4096) is too large for one
// block's shared memory and stays resident in the 50 MB L2 after the first
// touches; its bytes would take well under a microsecond, the integer
// operations (~80 a lane-wave) a few hundredths of a millisecond at T =
// 131,072.  One block of 128 threads occupies one SM: the probe measures a
// serial chain, not throughput.
//
// Plain C entry point (ctypes): device pointers and the stream as
// integers; returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

__global__ void probe_walk_kernel(const int* __restrict__ streams, int R,
                                  const int* __restrict__ cursors, int T,
                                  int* __restrict__ cur_out, int* __restrict__ acc_out) {
  const int lane = threadIdx.x;
  unsigned c = (unsigned)cursors[lane];  // int32 arithmetic, wrapping
  unsigned acc = 0;
  for (int t = 0; t < T; ++t) {
    const int widx = (int)c >> 5;  // arithmetic shift
    const unsigned w0 = (widx >= 0 && widx < R) ? (unsigned)streams[widx * kLanes + lane] : 0u;
    const unsigned w1 =
        (widx >= -1 && widx + 1 < R) ? (unsigned)streams[(widx + 1) * kLanes + lane] : 0u;
    const unsigned sh = c & 31;
    const unsigned win = sh ? (w0 >> sh) | (w1 << (32 - sh)) : w0;
    const int rev = (int)(win & 0x7FFF);
    const int bar = (rev >> 7) & 0x7F;
    int lsel = 15;
#pragma unroll
    for (int L = 15; L >= 1; --L) {
      if ((rev >> (15 - L)) < bar + L) lsel = L;
    }
    c += (unsigned)lsel + (win & 7);
    acc += win;
  }
  cur_out[lane] = (int)c;
  acc_out[lane] = (int)acc;
}

}  // namespace

extern "C" int hbt_inflate_probe_walk(const void* streams, int R, const void* cursors, int T,
                                      void* cur_out, void* acc_out, void* stream) {
  probe_walk_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
      (const int*)streams, R, (const int*)cursors, T, (int*)cur_out, (int*)acc_out);
  return (int)cudaGetLastError();
}
