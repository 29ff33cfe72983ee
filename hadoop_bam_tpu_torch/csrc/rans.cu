// rANS 4x8 decode (CRAM 3.0, order 0 and order 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel hadoop_bam_tpu/ops/pallas/rans_lanes.py
// (_kernel_factory, reached through rans_lanes) together with its host
// post-pass rans_deinterleave: each stream's bytes land straight at their
// output positions.
//
// A stream is four interleaved rANS states over one renorm byte stream.
// Wave t (0 <= t < n_out) decodes one byte with state j = t & 3 while
// t < 4*q4v and j = 3 afterwards (order 1's remainder tail), where q4v is
// n_out >> 2 for order 1 and ceil(n_out / 4) for order 0.  The symbol is
// lookup[slab][R & 4095] with slab the stream's one table (order 0) or
// the table of the state's previous symbol (order 1, 0 before the first);
// then R = F[s] * (R >> 12) + (R & 4095) - C[s] and at most two renorm
// reads R = R << 8 | byte bring it back to at least L = 2^23.  Order 0
// writes wave t at position t; order 1 at (t & 3) * q4 + (t >> 2) in the
// quarters and at t in the tail.
//
// ok = 0 (the host decodes the stream again) when a renorm read would pass
// the payload's clen bytes, when a state is still below L after two reads,
// or when an order-1 context is absent from the stream's table (cmap -1):
// the verdicts of the reference's NumPy tier (_decode_plan_group).  State
// arithmetic is in 64 bits, as that tier's.
//
// The TPU kernel ran 128 streams in lockstep on the vector lanes, every
// per-lane lookup a dense compare-and-reduce over VMEM banks, and declined
// streams whose payload, output or context banks passed its VMEM budget.
// Here one block decodes one stream from device memory, so nothing is
// declined for size: the wrapper only keeps n_out inside int32.
//
// Bound on this card: each payload byte read once, each output byte
// written once, over 3.35 TB/s.  The decode is a serial chain (each wave's
// renorm reads depend on all earlier waves' cursor), so one thread walks a
// stream, a group of four waves at a time: the four states' table lookups
// do not depend on the cursor, so all four are issued before the renorm
// reads, which take bytes from an 8-byte register window loaded once a
// group (a group reads at most 8 bytes).  A failed verdict is noted in the group and
// ends the walk after it.  Order 0's table (4 KiB of slot -> symbol plus F
// and C) and order 1's context map are staged in shared memory; order-1
// tables are read through the read-only cache.  Streams run in parallel,
// one per block; a container's launch takes as long as its longest stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int64_t kL = 1 << 23;
constexpr int kMetaCols = 9;  // pay_off, clen, out_off, n_out, order, R0..R3

// The renorm bytes from cursor p on: `buf` holds the next 8 bytes, low
// byte first, loaded at the start of each group of four waves (a group
// reads at most 8).  The payload buffer is padded past its last stream, so
// the load may read past a stream's clen bytes (bytes a stream only
// consumes when its verdict fails).
struct Window {
  const uint8_t* pay;
  int64_t clen;
  int64_t p;
  uint64_t buf;

  // Two aligned 8-byte loads and a funnel shift.
  __device__ __forceinline__ void fill() {
    const uintptr_t a = reinterpret_cast<uintptr_t>(pay) + p;
    const unsigned long long* q =
        reinterpret_cast<const unsigned long long*>(a & ~uintptr_t(7));
    const unsigned sh = 8 * static_cast<unsigned>(a & 7);
    const uint64_t lo = __ldg(q);
    const uint64_t hi = __ldg(q + 1);
    buf = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
  }

  // At most two renorm reads; `bad` notes a read past clen or a state
  // still below L.
  __device__ __forceinline__ void renorm(int64_t& rn, int& bad) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool need = rn < kL;
      bad |= need & (p >= clen);
      rn = need ? ((rn << 8) | static_cast<int64_t>(buf & 0xFF)) : rn;
      buf = need ? (buf >> 8) : buf;
      p += need;
    }
    bad |= rn < kL;
  }
};

// The symbol of state r over a table slab (lk: 4096 slot -> symbol, fc:
// C << 16 | F per symbol) and the state before renorm.
__device__ __forceinline__ int64_t step(int64_t r, const uint8_t* lk, const uint32_t* fc,
                                        int& s) {
  const int64_t m = r & 4095;
  s = lk[m];
  const uint32_t e = fc[s];
  return static_cast<int64_t>(e & 0xFFFFu) * (r >> 12) + m - static_cast<int64_t>(e >> 16);
}

__global__ void __launch_bounds__(kThreads)
rans_kernel(const uint8_t* __restrict__ payload, const int64_t* __restrict__ meta,
            const uint8_t* __restrict__ lookup, const uint32_t* __restrict__ fc,
            const int32_t* __restrict__ cmap, uint8_t* __restrict__ out,
            int32_t* __restrict__ ok) {
  __shared__ __align__(16) uint8_t s_lk[4096];
  __shared__ __align__(16) uint32_t s_fc[256];
  __shared__ int32_t s_cm[256];
  const int b = blockIdx.x;
  const int64_t* mt = meta + static_cast<int64_t>(b) * kMetaCols;
  const int64_t n = mt[3];
  const int order = static_cast<int>(mt[4]);
  const int32_t* cm = cmap + static_cast<int64_t>(b) * 256;
  if (order == 0) {
    const int64_t slab = cm[0];
    const uint4* src = reinterpret_cast<const uint4*>(lookup + slab * 4096);
    for (int i = threadIdx.x; i < 4096 / 16; i += kThreads)
      reinterpret_cast<uint4*>(s_lk)[i] = src[i];
    for (int i = threadIdx.x; i < 256; i += kThreads) s_fc[i] = fc[slab * 256 + i];
  } else {
    for (int i = threadIdx.x; i < 256; i += kThreads) s_cm[i] = cm[i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  Window w{payload + mt[0], mt[1], 0, 0};
  uint8_t* o = out + mt[2];
  int64_t r[4] = {mt[5], mt[6], mt[7], mt[8]};
  int bad = 0;
  if (order == 0) {
    const int64_t groups = n >> 2;
    for (int64_t g = 0; g < groups; ++g) {
      w.fill();
      int s[4];
      int64_t rn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) rn[j] = step(r[j], s_lk, s_fc, s[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w.renorm(rn[j], bad);
        r[j] = rn[j];
      }
      if (bad) break;
      // out_off is 16-aligned, so the group's four bytes are one word.
      reinterpret_cast<uint32_t*>(o)[g] = static_cast<uint32_t>(s[0]) | (s[1] << 8) |
                                          (s[2] << 16) | (static_cast<uint32_t>(s[3]) << 24);
    }
    for (int64_t t = groups * 4; t < n && !bad; ++t) {
      w.fill();
      int s;
      int64_t rn = step(r[t & 3], s_lk, s_fc, s);
      w.renorm(rn, bad);
      r[t & 3] = rn;
      o[t] = static_cast<uint8_t>(s);
    }
  } else {
    const int64_t q4 = n >> 2;
    int last[4] = {0, 0, 0, 0};
    for (int64_t g = 0; g < q4; ++g) {
      w.fill();
      int s[4];
      int64_t rn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int slab = s_cm[last[j]];
        bad |= slab < 0;
        const int64_t sl = slab < 0 ? 0 : slab;
        rn[j] = step(r[j], lookup + sl * 4096, fc + sl * 256, s[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w.renorm(rn[j], bad);
        r[j] = rn[j];
        last[j] = s[j];
        o[j * q4 + g] = static_cast<uint8_t>(s[j]);
      }
      if (bad) break;
    }
    for (int64_t t = 4 * q4; t < n && !bad; ++t) {
      w.fill();
      const int slab = s_cm[last[3]];
      bad |= slab < 0;
      const int64_t sl = slab < 0 ? 0 : slab;
      int s;
      int64_t rn = step(r[3], lookup + sl * 4096, fc + sl * 256, s);
      w.renorm(rn, bad);
      r[3] = rn;
      last[3] = s;
      o[t] = static_cast<uint8_t>(s);
    }
  }
  ok[b] = !bad;
}

}  // namespace

extern "C" {

// One block per stream.  meta is int64[n_streams][9]; lookup uint8[slabs]
// [4096]; fc uint32[slabs][256]; cmap int32[n_streams][256] (slab index,
// -1 for an absent order-1 context; an order-0 stream's row holds its one
// slab); payload 8-aligned and padded with 16 bytes past the last stream; out uint8
// with each stream's 16-aligned region; ok int32 [n_streams].  Returns the
// CUDA error code of the launch.
int hbt_rans_decode(const void* payload, const void* meta, const void* lookup,
                    const void* fc, const void* cmap, void* out, void* ok,
                    int n_streams, void* stream) {
  if (n_streams <= 0) return 0;
  rans_kernel<<<n_streams, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int64_t*>(meta),
      static_cast<const uint8_t*>(lookup), static_cast<const uint32_t*>(fc),
      static_cast<const int32_t*>(cmap), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
