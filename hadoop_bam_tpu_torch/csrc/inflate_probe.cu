// The lockstep-walk probe for Hopper (sm_90a).
//
// Replaces hadoop_bam_tpu/ops/pallas/inflate_probe.py (the kernel of
// _walk_kernel_factory, launched by make_walk): 128 lanes, each with a bit
// cursor into its column of a transposed int32 [R, 128] stream, run T
// waves of: the two words under the cursor (0 outside [0, R)), a 32-bit
// window, a 15-class range-compare "decode", cur += length + (win & 7),
// acc += win with int32 wrap.  The TPU kernel extracts each lane's word by
// an iota-compare reduction over the whole [R, 128] tile every wave; here a
// thread is a lane and walks with inflate_probe_core.cuh's walk_lane.
//
// Bound: latency.  The T waves of a lane form one dependent chain, so the
// least time is T times one wave's dependent steps; the stream's bytes (2
// MiB at R = 4096) and the integer operations (~80 a lane and wave) would
// take well under a microsecond at the card's rates.  The design takes the
// loads and the length class's select chain off that chain: each lane keeps
// the 64 stream bits from its cursor on in two registers and shifts them
// down by each wave's advance, taking the bits after them in at the top;
// the words behind those come from a ring of kRing words in shared memory
// that 4-byte cp.async copies fill ahead (groups issued kDepth blocks of
// kWaves waves before they are read).  The length class plus the window's
// low bits is one shared-memory byte read from a 32 KiB table built by the
// block at launch.  A wave's dependent chain is then the table's index
// mask, its byte read and one funnel shift.
//
// Geometry: one block of 128 threads, a thread a lane; a lane's ring is its
// own, so no warp waits on another.  Shared memory (dynamic): the table and
// kRing + 1 words a lane, 49,664 bytes, above the 48 KiB a launch gets
// without opting in.
//
// Plain C entry point (ctypes): device pointers and the stream as integers;
// returns the error of the shared-memory opt-in, else cudaGetLastError() of
// the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inflate_probe_core.cuh"

namespace {

using namespace hbt_probe;

constexpr int kRing = 32;   // ring words a lane
constexpr int kWaves = 8;   // waves a block of the walk
constexpr int kDepth = 4;   // groups of copies in flight when a block starts
constexpr int kSmemBytes = kTableBytes + 4 * (kRing + 1) * kLanes;

__global__ void __launch_bounds__(kLanes)
probe_walk_kernel(const int32_t* __restrict__ streams, int R, const int32_t* __restrict__ cursors,
                  int T, int32_t* __restrict__ cur_out, int32_t* __restrict__ acc_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint8_t* tab = reinterpret_cast<uint8_t*>(smem);
  build_table(tab, threadIdx.x, kLanes);
  __syncthreads();
  const int lane = threadIdx.x;
  walk_lane<kRing, kWaves, kDepth>(streams + lane, R, static_cast<uint32_t>(cursors[lane]), T,
                                   tab, smem + kTableBytes / 4 + lane, kLanes, cur_out + lane,
                                   acc_out + lane);
}

}  // namespace

extern "C" int hbt_inflate_probe_walk(const void* streams, int R, const void* cursors, int T,
                                      void* cur_out, void* acc_out, void* stream) {
  const cudaError_t opted_in = cudaFuncSetAttribute(
      probe_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (opted_in != cudaSuccess) return static_cast<int>(opted_in);
  probe_walk_kernel<<<1, kLanes, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(streams), R, static_cast<const int32_t*>(cursors), T,
      static_cast<int32_t*>(cur_out), static_cast<int32_t*>(acc_out));
  return static_cast<int>(cudaGetLastError());
}
