// The overlap cut's core (csrc/region.cu): which records of a view overlap
// the query intervals, written out as their row indices, compacted and in
// order.  The device runs each phase with a block's threads; a host build
// with g++ runs the same functions with the threads as loops
// (HBT_RG_EACH), which the CPU tests hold to the plain version.
//
// A record is the view's three int32 columns (refid, pos, ref_len).  Its
// span is [pos, pos + max(ref_len, 1)) with the end wrapping in int32, as
// the reference's jitted op computes it; a record with pos < 0 never
// matches.  It overlaps interval (refid, beg, end) when the refids are
// equal, pos < end and its end > beg.  The intervals are staged in shared
// memory kOverlapChunk at a time, so K is unbounded.
//
// The cut is three launches, which the wrapper counts as one:
//   1. Count, one block of nth threads a run of nth records: each thread's
//      hit; each warp's ballot word goes to bits[], the block's hits (the
//      popcounts of its warps' words) to blk[b].
//   2. Scan, one block: blk[] becomes each block's hits before it; out[0]
//      the count.
//   3. Scatter, one block a run again: the block scans its warps' counts
//      from the ballot words, and each thread with a hit writes its row
//      index to out[1 + blk[b] + its warp's offset + the hits of the lanes
//      below it].
// The mask never reaches device memory in bytes, and nothing goes back to
// the host in between.  Rows are int32: a view's records are far below
// 2^31.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define HBT_RG_HD __host__ __device__
#define HBT_RG_INLINE __forceinline__
#else
#define HBT_RG_HD
#define HBT_RG_INLINE inline
#endif

#ifdef __CUDA_ARCH__
#define HBT_RG_SYNC() __syncthreads()
#define HBT_RG_EACH(tid, nth) for (int tid = threadIdx.x, tid##_once = 1; tid##_once; tid##_once = 0)
#else
#define HBT_RG_SYNC() ((void)0)
#define HBT_RG_EACH(tid, nth) for (int tid = 0; tid < (nth); ++tid)
#endif

namespace hbt_region {

constexpr int kThreads = 256;        // the count's and the scatter's blocks
constexpr int kScanThreads = 1024;   // the scan's one block
constexpr int kOverlapChunk = 1024;  // intervals staged per pass: 12 KiB
constexpr int kMaxWarps = 32;

HBT_RG_HD HBT_RG_INLINE int popc(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}

// A record's reference span [s, e) on contig r; only a placed one matches.
struct Span {
  int32_t r, s, e;
  bool placed;
};

// The view's rule: the end wraps in int32, and pos < 0 is unplaced.
HBT_RG_HD HBT_RG_INLINE Span view_span(int32_t refid, int32_t pos, int32_t ref_len) {
  const uint32_t len = static_cast<uint32_t>(ref_len > 1 ? ref_len : 1);
  return Span{refid, pos, static_cast<int32_t>(static_cast<uint32_t>(pos) + len), pos >= 0};
}

// Any of the m staged intervals (refid, beg, end) overlaps x.
HBT_RG_HD HBT_RG_INLINE bool hits(const Span& x, const int32_t* iv, int m) {
  if (!x.placed) return false;
  for (int j = 0; j < m; ++j)
    if (x.r == iv[3 * j] && x.s < iv[3 * j + 2] && x.e > iv[3 * j + 1]) return true;
  return false;
}

// Intervals [c0, c0 + m) of iv into s_iv, by the block.
HBT_RG_HD HBT_RG_INLINE void stage_intervals(const int32_t* iv, int c0, int m, int32_t* s_iv,
                                             int tid, int nth) {
  for (int j = tid; j < 3 * m; j += nth) s_iv[j] = iv[3 * c0 + j];
}

struct Cut {
  const int32_t* iv;  // [k][3]: refid, beg, end (half-open, 0-based)
  int k;
  const int32_t* refid;  // [n]
  const int32_t* pos;    // [n]
  const int32_t* len;    // [n]: the reference lengths
  int64_t n;
  int nth;          // threads a block of the count and the scatter: 32 * (1 .. kMaxWarps)
  uint32_t* bits;   // [words(n)]: a warp's hits, lane l at bit l
  int32_t* blk;     // [blocks]: a block's hits, then the hits before it
  int32_t* out;     // [1 + n]: the count, then the rows
};

HBT_RG_HD HBT_RG_INLINE int64_t words(int64_t n) { return (n + 31) / 32; }
HBT_RG_HD HBT_RG_INLINE int64_t blocks(const Cut& c) { return (c.n + c.nth - 1) / c.nth; }

HBT_RG_HD HBT_RG_INLINE Span span_at(const Cut& c, int64_t i) {
  return view_span(c.refid[i], c.pos[i], c.len[i]);
}

// ---------------------------------------------------------------------------
// 1. Count, block b (records b * nth .. b * nth + nth - 1).  s_iv: shared,
// 3 * kOverlapChunk; wc: shared, one a warp.  hit: on the host, one a
// thread (the device keeps each in a register).

HBT_RG_HD inline void count_block(const Cut& c, int64_t b, int32_t* s_iv, int32_t* wc,
                                  uint8_t* hit) {
  const int nth = c.nth;
#ifdef __CUDA_ARCH__
  bool mine = false;
#define HBT_RG_HIT(tid) mine
  (void)hit;
#else
  for (int t = 0; t < nth; ++t) hit[t] = 0;
#define HBT_RG_HIT(tid) hit[tid]
#endif
  for (int c0 = 0; c0 < c.k; c0 += kOverlapChunk) {
    const int m = c.k - c0 < kOverlapChunk ? c.k - c0 : kOverlapChunk;
    HBT_RG_SYNC();
    HBT_RG_EACH(tid, nth) stage_intervals(c.iv, c0, m, s_iv, tid, nth);
    HBT_RG_SYNC();
    HBT_RG_EACH(tid, nth) {
      const int64_t i = b * nth + tid;
      if (i < c.n && !HBT_RG_HIT(tid)) HBT_RG_HIT(tid) = hits(span_at(c, i), s_iv, m);
    }
  }
  HBT_RG_EACH(tid, nth) {
#ifdef __CUDA_ARCH__
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, HBT_RG_HIT(tid));
#else
    uint32_t word = 0;
    for (int l = 0; l < 32; ++l) word |= static_cast<uint32_t>(hit[(tid & ~31) + l] != 0) << l;
#endif
    if ((tid & 31) == 0) {
      const int64_t w = (b * nth + tid) >> 5;
      if (w < words(c.n)) c.bits[w] = word;
      wc[tid >> 5] = popc(word);
    }
  }
#undef HBT_RG_HIT
  HBT_RG_SYNC();
  HBT_RG_EACH(tid, nth) {
    if (tid == 0) {
      int32_t s = 0;
      for (int v = 0; v < nth / 32; ++v) s += wc[v];
      c.blk[b] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. Scan, one block of nth threads over the nb block counts: thread t sums
// a run of them, the block scans the sums in shared memory (part, tmp: nth
// each; Kogge-Stone), and each thread writes its run's exclusive offsets.
// out[0] gets the count.

HBT_RG_HD inline void scan_blocks(int32_t* blk, int64_t nb, int32_t* out, int32_t* part,
                                  int32_t* tmp, int nth) {
  const int64_t q = (nb + nth - 1) / nth;
  HBT_RG_EACH(tid, nth) {
    int32_t s = 0;
    for (int64_t j = tid * q; j < (tid + 1) * q && j < nb; ++j) s += blk[j];
    part[tid] = s;
  }
  HBT_RG_SYNC();
  for (int d = 1; d < nth; d <<= 1) {
    HBT_RG_EACH(tid, nth) tmp[tid] = tid >= d ? part[tid - d] : 0;
    HBT_RG_SYNC();
    HBT_RG_EACH(tid, nth) part[tid] += tmp[tid];
    HBT_RG_SYNC();
  }
  HBT_RG_EACH(tid, nth) {
    int32_t s = tid ? part[tid - 1] : 0;
    for (int64_t j = tid * q; j < (tid + 1) * q && j < nb; ++j) {
      const int32_t v = blk[j];
      blk[j] = s;
      s += v;
    }
    if (tid == nth - 1) out[0] = part[nth - 1];
  }
}

// ---------------------------------------------------------------------------
// 3. Scatter, block b.  word, woff: shared, one a warp.

HBT_RG_HD inline void scatter_block(const Cut& c, int64_t b, uint32_t* word, int32_t* woff) {
  const int nth = c.nth, nw = nth / 32;
  HBT_RG_EACH(tid, nth) {
    if (tid < nw) {
      const int64_t w = b * nw + tid;
      word[tid] = w < words(c.n) ? c.bits[w] : 0u;
    }
  }
  HBT_RG_SYNC();
  HBT_RG_EACH(tid, nth) {  // the block's scan of its warps' counts
    if (tid < nw) {
      int32_t s = c.blk[b];
      for (int v = 0; v < tid; ++v) s += popc(word[v]);
      woff[tid] = s;
    }
  }
  HBT_RG_SYNC();
  HBT_RG_EACH(tid, nth) {
    const uint32_t wd = word[tid >> 5];
    const int lane = tid & 31;
    if (wd >> lane & 1u)
      c.out[1 + woff[tid >> 5] + popc(wd & ((1u << lane) - 1u))] =
          static_cast<int32_t>(b * nth + tid);
  }
}

}  // namespace hbt_region
