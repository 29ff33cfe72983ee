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
// 131,200 records, in int32.  The chunk cap never bound: a record is at
// least 32 bytes and a chunk's records start inside its 4 MiB, so a chunk
// starts at most 131,072.  Offsets here are int64; the int32 columns keep
// the reference's payload domain, and the wrapper sends a payload past
// 2^31 - 2^29 bytes to the host walk before any launch.
//
// Design (bcf_chain_core.cuh): the walk is serial from `start`, so one
// block walking it used one SM of 132 (8.5 ms a 10.8 MB split).  Here the
// window is cut into segments of `seg` bytes and each is tabulated alone:
// map, one block of 512 threads a segment, every position's segment exit
// and count; compose, one block a segment, the exits over the next kGroup
// segments of its first kHead positions; hop, one warp, from `start`
// through the group exits, one read for kGroup segments; fill, one thread
// a group step, the entries of the segments it crossed; emit, one block a
// segment, the re-walk from its true entry and its rows.  A walk is
// therefore several CUDA launches (five a slab of `slab` bytes); the
// wrapper counts it as one.  The workspace (6 bytes a position of a slab
// and 8 a head position, from PyTorch's caching allocator) holds the exits,
// the entries and the carry between slabs; nothing goes back to the host
// between slabs.
//
// Segment size: the wrapper's seg = 16 KiB cuts a 10.8 MB split into ~660
// segments, five an SM; a map block holds 82 KB of shared memory (a 4-byte
// word and the staged byte a position), so two run on an SM at once.  The
// hop's series is ~660 / 16 group reads.  8 KiB segments took as long
// (more hop steps, a shorter emit walk), 32 KiB ones longer (one map block
// an SM); 1,024-thread map blocks were slower than 512.
//
// Bound on this card: per record 8 B of lengths and 24 B of fixed fields
// read and 28 B of columns written, over 3.35 TB/s.  The map reads each
// byte once and writes 6 B of exits a position (the design's, not the
// work's): that traffic and its three waves of blocks set its time.  The
// hop, compose and fill are chains of dependent device-memory reads; the
// emit's walk is one serial chain of records a segment, all segments at
// once.

#include <cstdint>

#include <cuda_runtime.h>

#include "bcf_chain_core.cuh"

namespace {

using namespace hbt_bcf;

constexpr int kMapThreads = 512;  // 16 warps: the map's sub-segments
constexpr int kSub = kMapThreads / 32;
constexpr int kEmitThreads = 128;
constexpr int kFillThreads = 128;

__global__ void __launch_bounds__(kMapThreads, 2)
map_kernel(Walk w, int64_t slab0, Work t) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* lk = reinterpret_cast<uint32_t*>(smem);
  uint8_t* buf = smem + 4 * w.seg;
  const int64_t k = blockIdx.x, seg0 = slab0 + (k << w.shift);
  const int tid = threadIdx.x;
  const int lead = stage(w, seg0, buf, tid, kMapThreads);
  __syncthreads();
  map_links(w, seg0, buf, lead, lk, tid, kMapThreads);
  __syncthreads();
  map_strips(w, lk, tid >> 5, tid & 31, 32);
  __syncthreads();
  map_join(w, lk, tid, kMapThreads);
  map_exits(w, seg0, buf, lead, lk, t.to + (k << w.shift), t.rows + (k << w.shift), tid,
            kMapThreads);
}

__global__ void __launch_bounds__(kHead)
compose_kernel(Walk w, int64_t slab0, int64_t nseg, Work t) {
  compose(w, slab0, nseg, t, blockIdx.x, threadIdx.x, kHead);
}

__global__ void __launch_bounds__(32)
hop_kernel(Walk w, int64_t slab0, int64_t nseg, bool first, Work t, int64_t* __restrict__ meta) {
  hop(w, slab0, nseg, first, t, meta, threadIdx.x, 32);
}

__global__ void __launch_bounds__(kFillThreads)
fill_kernel(Walk w, int64_t slab0, int64_t nseg, Work t) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kFillThreads + threadIdx.x;
  if (k < nseg) fill(w, slab0, t, k);
}

__global__ void __launch_bounds__(kEmitThreads)
emit_kernel(Walk w, int64_t slab0, Work t, int32_t* __restrict__ cols, int64_t cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int sh_m;
  const int32_t e = t.entry[blockIdx.x];
  if (e < 0) return;
  uint8_t* buf = smem;
  int32_t* starts = reinterpret_cast<int32_t*>(smem + stage_bytes(w.seg));
  const int64_t seg0 = slab0 + (static_cast<int64_t>(blockIdx.x) << w.shift);
  const int tid = threadIdx.x;
  const int lead = stage(w, seg0, buf, tid, kEmitThreads);
  __syncthreads();
  if (tid == 0) sh_m = emit_walk(w, seg0, buf, lead, e, starts);
  __syncthreads();
  emit_rows(w, seg0, buf, lead, starts, sh_m, t.base[blockIdx.x], cols, cap, tid, kEmitThreads);
}

// seg: a power of two from 512 to 65,536; slab: a multiple of seg up to 2^30.
bool bad_geometry(long long seg, long long slab) {
  return seg < 32 * kSub || seg > kMaxSeg || seg_shift(seg) < 0 || slab < seg ||
         slab > kMaxSlab || slab % seg != 0;
}

}  // namespace

extern "C" {

// The walk's plan for a window: out[0] the bytes of the workspace that
// hbt_bcf_chain_walk takes (hbt_bcf::work_bytes), out[1] the segments the
// window is cut into.  Returns cudaErrorInvalidValue for a geometry the walk
// refuses, else 0.
int hbt_bcf_chain_plan(long long n, long long start, long long limit, long long seg,
                       long long slab, long long* out) {
  if (bad_geometry(seg, slab)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = make_plan(n, start, limit, seg, slab);
  out[0] = work_bytes(pl, seg);
  out[1] = pl.segs;
  return 0;
}

// cols is int32[7][cap] with cap >= (limit - start) / 32 + 1 (records are
// at least 32 bytes apart); meta is int64[2]; work (16-aligned) holds the
// bytes hbt_bcf_chain_plan gives for the same arguments.  With phase_ms
// (host floats, or null) the call records events around each phase, waits
// for them, and adds each phase's milliseconds (map, compose, hop, fill,
// emit) over the slabs.  Returns the CUDA error code of the launches.
int hbt_bcf_chain_walk(const void* payload, long long n, long long start, long long limit,
                       void* cols, long long cap, void* meta, void* work, long long seg,
                       long long slab, float* phase_ms, void* stream) {
  if (bad_geometry(seg, slab)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl = make_plan(n, start, limit, seg, slab);
  const Walk w{static_cast<const uint8_t*>(payload), n,  start,   limit,
               seg, pl.width, kSub, seg_shift(seg)};
  const Work t = carve(work, pl, seg);
  const int msm = static_cast<int>(map_smem(seg)), esm = static_cast<int>(emit_smem(seg));
  cudaError_t e = cudaFuncSetAttribute(map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, msm);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, esm);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int kPhases = 5;
  cudaEvent_t ev[kPhases + 1] = {};
  if (phase_ms) {
    for (auto& x : ev) cudaEventCreate(&x);
    for (int k = 0; k < kPhases; ++k) phase_ms[k] = 0.f;
  }
  const int64_t spl = slab / seg;
  for (int64_t j = 0; j < pl.slabs; ++j) {
    const int64_t slab0 = start + j * slab;
    const int64_t left = pl.segs - j * spl;
    const int64_t segs = left < 0 ? 0 : left < spl ? left : spl;
    const unsigned grid = static_cast<unsigned>(segs);
    if (phase_ms) cudaEventRecord(ev[0], st);
    if (segs) map_kernel<<<grid, kMapThreads, msm, st>>>(w, slab0, t);
    if (phase_ms) cudaEventRecord(ev[1], st);
    if (segs) compose_kernel<<<grid, kHead, 0, st>>>(w, slab0, segs, t);
    if (phase_ms) cudaEventRecord(ev[2], st);
    hop_kernel<<<1, 32, 0, st>>>(w, slab0, segs, j == 0, t, static_cast<int64_t*>(meta));
    if (phase_ms) cudaEventRecord(ev[3], st);
    if (segs)
      fill_kernel<<<(grid + kFillThreads - 1) / kFillThreads, kFillThreads, 0, st>>>(w, slab0,
                                                                                  segs, t);
    if (phase_ms) cudaEventRecord(ev[4], st);
    if (segs)
      emit_kernel<<<grid, kEmitThreads, esm, st>>>(w, slab0, t, static_cast<int32_t*>(cols), cap);
    if (phase_ms) {
      cudaEventRecord(ev[5], st);
      cudaEventSynchronize(ev[5]);
      for (int k = 0; k < kPhases; ++k) {
        float ms = 0.f;
        cudaEventElapsedTime(&ms, ev[k], ev[k + 1]);
        phase_ms[k] += ms;
      }
    }
  }
  e = cudaGetLastError();
  if (phase_ms)
    for (auto& x : ev) cudaEventDestroy(x);
  return static_cast<int>(e);
}

}  // extern "C"
