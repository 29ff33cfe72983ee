// BAM record chain for Hopper (sm_90a): the record-boundary walk and the
// sort-key gather over one split's inflated record stream.
//
// Replaces the TPU kernel hadoop_bam_tpu/ops/pallas/chain.py (_chain_kernel,
// _chain_chunk and _chain_all, reached through record_chain_device) and the
// XLA key gather it feeds, hadoop_bam_tpu/ops/decode.py _stream_keys with
// ops/keys.py make_keys and unmapped_mask.  The TPU walk ran over 4 MiB
// chunks with the cursor carried between sequential grid steps, in int32;
// here offsets are int64, so the 2 GiB domain and the per-chunk record cap
// fall away.
//
// The walk: pos += 4 + u32(pos) from 0 while pos < n_bytes.  A size word
// below 32 (the fixed fields) or above 2^28 is an error and stops the walk
// without a record; bytes at or past n_bytes read as 0, as the TPU kernel's
// zero padding did; a record running past n_bytes is counted and fails the
// walk.  meta = {count, ok} with ok = no error and the cursor landing
// exactly on n_bytes.
//
// Design (chain_core.cuh): the walk is serial from 0, so one block walking
// it used one SM of 132 (12.4 ms a 52.5 MB split).  Here the stream is cut
// into segments of `seg` bytes and each is tabulated alone: map, one block
// of 512 threads a segment, every position's segment exit and count;
// compose, one block a segment, the exits over the next kGroup segments of
// its first kHead positions; hop, one warp, from 0 through the group exits,
// one read for kGroup segments; fill, one thread a group step, the entries
// of the segments it crossed; emit, one block a segment, thread 0's re-walk
// from its true entry into a list, then the block writes the int64 offsets
// and, on the sort's path, the keys.  A walk is therefore several
// CUDA launches (five a slab of `slab` bytes); the wrapper counts it as one.
// The workspace (8 bytes a position of a slab, 4 of them written, and 8 a
// head position, from PyTorch's caching allocator) holds the exits, the
// entries and the carry between slabs; nothing goes back to the host
// between slabs.
//
// Geometry, tuned on the sort's 280-byte records (a 52.5 MB split, 3,204
// segments): 16 KiB segments, two 82 KB map blocks an SM; the wrapper's
// 64 MiB slab walks a split in five launches (16 MiB slabs took 0.386 ms
// for the old 6-byte table, 64 MiB 0.320).  kHead = 320 positions outlast
// a 280-byte record, so the chain enters every segment in its head and the
// hop reads one group exit a step (a 128-position head read 426 exits, 320
// reads 201); kGroup = 32 halves that again (101 reads) for a compose of
// twice the steps; 8 KiB segments doubled the hop, 32 KiB ones held one map
// block an SM; a 512-position head composed more than it saved.
//
// The key gather rides the emit: the emit stages its segment with a
// 24-byte halo (the map's stays 8 bytes, so its two blocks an SM keep their
// shared memory), and reads each record's refid, pos and flag from those
// staged bytes instead of from device memory again.  stream_keys_kernel is
// the same gather standalone, for offsets from elsewhere (one thread per
// record): refid, pos and flag at offs[i] + 4 → the packed int64 sort key
// (Java's (long)refIdx << 32 | pos0, sign extension of a negative low word
// included) and the unmapped mask (flag 0x4, refid < 0, or pos + 1 < 0 in
// int32 arithmetic).  Unmapped rows carry key INT_MAX << 32 until the host
// murmur3 hash is patched in.
//
// Bound on this card: (4 B size word read + 8 B offset written) per record
// for the walk, 10 B of fields read and 9 B written more with the keys;
// (8 B offset + 10 B of fields read, 8 B key + 1 B mask written) per record
// for the standalone gather, over 3.35 TB/s.  The map reads each
// byte once and writes a 4-byte table word a position (the design's, not
// the work's); the dependent shared-memory steps of its strips and its 13
// waves of blocks set its time (7 of 10 parts of the walk).  The hop,
// compose and fill are chains of dependent device-memory reads; the emit's
// walk is one serial chain of records a segment, all segments at once.

#include <cstdint>

#include <cuda_runtime.h>

#include "chain_core.cuh"

namespace {

using namespace hbt_chain;

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
  map_strips(w, seg0, static_cast<int32_t>(k << w.shift), buf, lead, lk, t.far + (k << w.shift),
             tid >> 5, tid & 31, 32);
  __syncthreads();
  map_join(w, lk, tid, kMapThreads);
  map_store(w, lk, t.exits + (k << w.shift), tid, kMapThreads);
}

__global__ void __launch_bounds__(kHead)
compose_kernel(Walk w, int64_t nseg, Work t) {
  compose(w, nseg, t, blockIdx.x, threadIdx.x, kHead);
}

__global__ void __launch_bounds__(32)
hop_kernel(Walk w, int64_t slab0, int64_t nseg, bool first, Work t, int64_t* __restrict__ meta) {
  hop(w, slab0, nseg, first, t, meta, threadIdx.x, 32);
}

__global__ void __launch_bounds__(kFillThreads)
fill_kernel(Walk w, int64_t nseg, Work t) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kFillThreads + threadIdx.x;
  if (k < nseg) fill(w, t, k);
}

__global__ void __launch_bounds__(kEmitThreads)
emit_kernel(Walk w, int64_t slab0, int64_t nseg, Work t, int64_t* __restrict__ offs, Keys kk,
            const int64_t* __restrict__ meta, bool last) {
  extern __shared__ __align__(16) uint8_t smem[];
  if (last && kk.keys != nullptr)
    emit_rest(kk, meta[0], blockIdx.x, gridDim.x, threadIdx.x, kEmitThreads);
  if (blockIdx.x >= nseg || t.entry[blockIdx.x] < 0) return;
  const int lead = emit_stage(w, slab0 + (static_cast<int64_t>(blockIdx.x) << w.shift), smem,
                              threadIdx.x, kEmitThreads);
  __syncthreads();
  int32_t* at = emit_list(smem, w.seg);
  if (threadIdx.x == 0) at[0] = emit_walk(w, slab0, t, blockIdx.x, smem, lead, at + 1);
  __syncthreads();
  emit_rows(w, slab0, t, blockIdx.x, smem, lead, at + 1, at[0], offs, kk, threadIdx.x,
            kEmitThreads);
}

// seg: a power of two from 512 to 65,536; slab: a multiple of seg up to 2^30.
bool bad_geometry(long long seg, long long slab) {
  return seg < 32 * kSub || seg > kMaxSeg || seg_shift(seg) < 0 || slab < seg ||
         slab > kMaxSlab || slab % seg != 0;
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
  pack_key(static_cast<int32_t>(le_at(s, body, n_bytes, 4)),
           static_cast<int32_t>(le_at(s, body + 4, n_bytes, 4)), le_at(s, body + 14, n_bytes, 2),
           keys + i, unmapped + i);
}

}  // namespace

extern "C" {

// The walk's plan for a stream of n bytes: out[0] the bytes of the
// workspace that hbt_chain_walk takes (hbt_chain::work_bytes), out[1] the
// segments the stream is cut into.  Returns cudaErrorInvalidValue for a
// geometry the walk refuses, else 0.
int hbt_chain_plan(long long n, long long seg, long long slab, long long* out) {
  if (bad_geometry(seg, slab)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = make_plan(n, seg, slab);
  out[0] = work_bytes(pl, seg);
  out[1] = pl.segs;
  return 0;
}

// offs holds >= n_bytes / 36 + 1 entries (a record takes >= 36 bytes);
// meta is int64[2]; work (16-aligned) holds the bytes hbt_chain_plan gives
// for the same arguments.  With keys (int64[n_rows]) and unmapped
// (uint8[n_rows]) non-null, the emit also writes each record's sort key and
// unmapped byte below n_rows, and rows from the count up get 0 (the rule of
// hbt_stream_keys).  With phase_ms (host floats, or null) the call
// records events around each phase, waits for them, and adds each phase's
// milliseconds (map, compose, hop, fill, emit) over the slabs.  Returns the
// CUDA error code of the launches.
int hbt_chain_walk(const void* stream_bytes, long long n_bytes, void* offs, void* meta,
                   void* work, long long seg, long long slab, void* keys, void* unmapped,
                   long long n_rows, float* phase_ms, void* stream) {
  if (bad_geometry(seg, slab)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl = make_plan(n_bytes, seg, slab);
  const Walk w{static_cast<const uint8_t*>(stream_bytes), n_bytes, seg, kSub, seg_shift(seg)};
  const Work t = carve(work, pl, seg);
  const Keys kk{static_cast<int64_t*>(keys), static_cast<uint8_t*>(unmapped), n_rows};
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
    const int64_t slab0 = j * slab;
    const int64_t left = pl.segs - j * spl;
    const int64_t segs = left < 0 ? 0 : left < spl ? left : spl;
    const unsigned grid = static_cast<unsigned>(segs);
    if (phase_ms) cudaEventRecord(ev[0], st);
    if (segs) map_kernel<<<grid, kMapThreads, msm, st>>>(w, slab0, t);
    if (phase_ms) cudaEventRecord(ev[1], st);
    if (segs) compose_kernel<<<grid, kHead, 0, st>>>(w, segs, t);
    if (phase_ms) cudaEventRecord(ev[2], st);
    hop_kernel<<<1, 32, 0, st>>>(w, slab0, segs, j == 0, t, static_cast<int64_t*>(meta));
    if (phase_ms) cudaEventRecord(ev[3], st);
    if (segs)
      fill_kernel<<<(grid + kFillThreads - 1) / kFillThreads, kFillThreads, 0, st>>>(w, segs, t);
    if (phase_ms) cudaEventRecord(ev[4], st);
    const bool last = j + 1 == pl.slabs;
    if (segs || (last && keys != nullptr))
      emit_kernel<<<grid ? grid : 1, kEmitThreads, esm, st>>>(
          w, slab0, segs, t, static_cast<int64_t*>(offs), kk, static_cast<const int64_t*>(meta),
          last);
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
