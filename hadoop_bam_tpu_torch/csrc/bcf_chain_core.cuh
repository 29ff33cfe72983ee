// The walk core of csrc/bcf_chain.cu: the BCF record chain of a window,
// decided by segments in parallel and exactly.  The device runs each phase
// with a block's threads; a host build with g++ runs the same functions
// with the threads as loops, which the CPU tests hold to the plain version.
//
// Records are [u32 l_shared][u32 l_indiv][shared][indiv] back to back.  The
// walk starts at `start`, keeps starting records while p + 8 <= limit and
// steps p += 8 + l_shared + l_indiv; a record whose framing fails
// (next_record) stops it with an error.  Bytes past n read 0.
//
// The chain is serial from `start`, but where it leaves a stretch of bytes
// is a function of the position at which it enters, and each stretch can
// tabulate that function alone.  So the window (the positions start ..
// start + width - 1 that can start a record) is cut into segments of `seg`
// bytes anchored at `start`, and:
//
//   1. Map, one block a segment.  For every position p of the segment, its
//      exit (the first chain position at or past the segment's end, or the
//      sink the chain falls into: kErr at a record whose framing fails, kEnd
//      at a position with p + 8 > limit) and its count (the records started
//      from p up to there; a kErr position starts none).  succ(p) >= p + 32,
//      so the segment is cut into `nsub` sub-segments of 32-position strips;
//      warp g walks its sub-segment's strips backward (each strip reads only
//      later strips), then the block joins the sub-segments backward, one
//      pass each.  Every position is touched a fixed number of times.  The
//      segment exits take 6 bytes a position of a slab.
//   2. Hop.  Compose, one block a segment: for each of the segment's first
//      positions (its head), the exit over the next kGroup segments and
//      the records before it.  Hop, one warp: from `start`, read the exit
//      at the cursor (a group exit when the cursor is in its segment's head,
//      else a segment exit), record entry[k] = cursor and base[k] = rows so
//      far for the cursor's segment, add the count, move to the exit.
//      Fill, one thread a group step: the entries and bases of the segments
//      the step crossed, from the segment exits.  Segments the chain jumps
//      over keep entry -1.  One dependent read a group of segments.
//   3. Emit, one block a segment with entry >= 0.  Thread 0 re-walks the
//      segment from its entry (stopping at its end, at limit, or at the
//      failing record), then the block gathers the six fixed words of each
//      record found into rows base[k] + i, neighbouring threads on
//      neighbouring rows.
//
// A window longer than a slab goes slab by slab; the cursor, the row count
// and the verdict ride in device memory (Carry) from one hop to the next.
// Every table value is a function of the bytes alone and the hop follows
// the chain the serial walk follows, so the result is the serial walk's.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define HBT_BCF_HD __host__ __device__
#define HBT_BCF_INLINE __forceinline__
#else
#define HBT_BCF_HD
#define HBT_BCF_INLINE inline
#endif

#ifdef __CUDA_ARCH__
#define HBT_BCF_SYNC() __syncthreads()
#define HBT_BCF_SYNCWARP() __syncwarp()
#else
#define HBT_BCF_SYNC() ((void)0)
#define HBT_BCF_SYNCWARP() ((void)0)
#endif

namespace hbt_bcf {

constexpr uint32_t kMinShared = 24;  // the fixed shared fields every record carries
constexpr uint32_t kMaxShared = 1u << 24;
constexpr uint32_t kMaxIndiv = 1u << 28;
constexpr int kMinRecord = 32;       // 8 bytes of lengths and 24 fixed bytes
constexpr int64_t kErr = -1;         // exits: a record whose framing fails
constexpr int64_t kEnd = -2;         //        a position with p + 8 > limit
constexpr int kHalo = 40;            // bytes staged past a segment: a record's fixed fields
constexpr int64_t kMaxSeg = 1 << 16; // a position's index in a segment fits 16 bits
constexpr int64_t kMaxSlab = 1 << 30; // a position's offset in a slab fits 32 bits
constexpr uint32_t kOne = 1u << 16;  // one record, in a packed (index, count) word

enum : int64_t { kWalking = 0, kEnded = 1, kFailed = 2 };

struct Walk {
  const uint8_t* s;  // the payload
  int64_t n;         // its bytes
  int64_t start, limit;
  int64_t seg;       // bytes a segment: 2^shift, a multiple of 32 * nsub, at most kMaxSeg
  int64_t width;     // positions with a table entry: start .. start + width - 1
  int nsub;          // sub-segments of the map (warps of its block)
  int shift;
};

// log2(seg) for a power of two, else -1.
HBT_BCF_HD inline int seg_shift(int64_t seg) {
  int sh = 0;
  while ((int64_t{1} << sh) < seg && sh < 62) ++sh;
  return (int64_t{1} << sh) == seg ? sh : -1;
}

// An exit over a group of segments: the chain position, kErr or kEnd, and
// the records started before it.
struct alignas(8) Exit {
  int32_t to;
  int32_t rows;
};

// What one slab's hop hands the next.  hops counts the hop's table reads.
struct Carry {
  int64_t cur, rows, status, hops;
};

// ---------------------------------------------------------------------------
// The record rule.

// The chain position after a record at offset i of a segment whose length
// words are ls and li, or kErr when its framing fails; n is the payload's
// end from the segment's first position, clamped to int32 (frame).  The
// walk only asks at i < kMaxSeg, and the framing test bounds ls + li below
// 2^24 + 2^28, so the sum stays below 2^29 + 2^17 and int32 holds it; the
// comparison with n is the true one.
HBT_BCF_HD HBT_BCF_INLINE int32_t next_record(int32_t i, uint32_t ls, uint32_t li, int32_t n) {
  if (ls < kMinShared || ls >= kMaxShared || li >= kMaxIndiv) return static_cast<int32_t>(kErr);
  const int32_t q = i + 8 + static_cast<int32_t>(ls) + static_cast<int32_t>(li);
  return q > n ? static_cast<int32_t>(kErr) : q;
}

// ---------------------------------------------------------------------------
// Geometry and the workspace.

// Positions that can start a record: p + 8 <= limit and p <= n (past n the
// length words read 0, so the framing fails there).
HBT_BCF_HD inline int64_t table_width(int64_t n, int64_t start, int64_t limit) {
  const int64_t last = limit - 8 < n ? limit - 8 : n;
  return last < start ? 0 : last - start + 1;
}

struct Plan {
  int64_t width;     // positions with a table entry
  int64_t segs;      // segments in all
  int64_t per_slab;  // segments of one slab's table (at least 1)
  int64_t slabs;     // hops launched (at least 1, which writes meta)
};

HBT_BCF_HD inline Plan make_plan(int64_t n, int64_t start, int64_t limit, int64_t seg,
                                 int64_t slab) {
  Plan p;
  p.width = table_width(n, start, limit);
  p.segs = (p.width + seg - 1) / seg;
  const int64_t spl = slab / seg;
  p.per_slab = p.segs < spl ? (p.segs > 0 ? p.segs : 1) : spl;
  p.slabs = p.segs > 0 ? (p.segs + spl - 1) / spl : 1;
  return p;
}

constexpr int kHead = 128;   // a segment's first positions with a group exit
constexpr int kGroup = 16;   // segments a group exit crosses

// Positions of a segment with a group exit: kHead, at most an eighth of a
// segment (so the workspace stays within 8 bytes a byte of a slab).
HBT_BCF_HD HBT_BCF_INLINE int head_of(int64_t seg) {
  return seg / 8 < kHead ? static_cast<int>(seg / 8) : kHead;
}

// The workspace of one slab: the Carry; entry, base and until (int32) a
// segment; from a 16-byte boundary the group exits (an Exit a head
// position); then the segment exits, to (int32) and rows (u16) a position:
// 6 bytes a byte of the slab, 8 bytes a head position, at most 8 bytes a
// byte in all.
HBT_BCF_HD inline int64_t groups_offset(const Plan& p) {
  return (static_cast<int64_t>(sizeof(Carry)) + 12 * p.per_slab + 15) / 16 * 16;
}

HBT_BCF_HD inline int64_t work_bytes(const Plan& p, int64_t seg) {
  return groups_offset(p) + 8 * p.per_slab * head_of(seg) + 6 * p.per_slab * seg;
}

struct Work {
  Carry* carry;
  int32_t* entry;  // the chain's first position in the segment, or -1
  int32_t* base;   // the records before it
  int32_t* until;  // where a group exit read at entry leads, or -1
  Exit* groups;    // [segment][head position]
  int32_t* to;     // [position]: the segment exit
  uint16_t* rows;  // [position]: the records before it
};

// The workspace's parts, from its (16-aligned) first byte.
HBT_BCF_HD inline Work carve(void* work, const Plan& p, int64_t seg) {
  uint8_t* wk = static_cast<uint8_t*>(work);
  int32_t* entry = reinterpret_cast<int32_t*>(wk + sizeof(Carry));
  Exit* groups = reinterpret_cast<Exit*>(wk + groups_offset(p));
  int32_t* to = reinterpret_cast<int32_t*>(groups + p.per_slab * head_of(seg));
  return Work{reinterpret_cast<Carry*>(wk), entry, entry + p.per_slab, entry + 2 * p.per_slab,
              groups, to, reinterpret_cast<uint16_t*>(to + p.per_slab * seg)};
}

// Shared memory: the staged bytes of a segment (16-aligned lead, the
// segment, kHalo, rounded up).
HBT_BCF_HD constexpr int64_t stage_bytes(int64_t seg) { return seg + 64; }
// The map: a packed (index, count) word a position, then the staged bytes.
HBT_BCF_HD constexpr int64_t map_smem(int64_t seg) { return 4 * seg + stage_bytes(seg); }
// The emit: the staged bytes, then the record starts found.
HBT_BCF_HD constexpr int64_t emit_smem(int64_t seg) {
  return stage_bytes(seg) + 4 * (seg / kMinRecord + 1);
}

// ---------------------------------------------------------------------------
// Primitives, plain on the host.

// The two u32 words at byte offset off of the 16-aligned staged buffer.
HBT_BCF_HD HBT_BCF_INLINE void words2(const uint8_t* buf, int off, uint32_t& a, uint32_t& b) {
#ifdef __CUDA_ARCH__
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf) + (off >> 2);
  const uint32_t sh = static_cast<uint32_t>(off & 3) * 8;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  a = __funnelshift_r(w0, w1, sh);
  b = __funnelshift_r(w1, w2, sh);
#else
  memcpy(&a, buf + off, 4);
  memcpy(&b, buf + off + 4, 4);
#endif
}

// 16 bytes from device memory to shared memory without a register round
// trip (cp.async; every copy of the thread lands at wait_copies()); a plain
// copy on the host.
HBT_BCF_HD HBT_BCF_INLINE void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

HBT_BCF_HD HBT_BCF_INLINE void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// Stage s[from - lead .. from + seg + kHalo) into buf with 16-byte copies
// from the 16-aligned address at or below s + from, all in flight at once;
// returns lead once this thread's copies landed (the block syncs next).
// Bytes outside [0, n) read 0.
HBT_BCF_HD inline int stage(const Walk& w, int64_t from, uint8_t* buf, int tid, int nthreads) {
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(w.s) + from) & 15);
  const int64_t base = from - lead;
  const int nvec = static_cast<int>((lead + w.seg + kHalo + 15) / 16);
  for (int v = tid; v < nvec; v += nthreads) {
    const int64_t p = base + 16 * v;
    if (p >= 0 && p + 16 <= w.n) {
      copy16_async(buf + 16 * v, w.s + p);
    } else {
      for (int q = 0; q < 16; ++q)
        buf[16 * v + q] = p + q >= 0 && p + q < w.n ? w.s[p + q] : 0;
    }
  }
  wait_copies();
  return lead;
}

// A segment's frame: the last offset from its first position that can
// start a record (limit - 8 - seg0) and the payload's end (n - seg0),
// clamped to int32.
struct Frame {
  int32_t last, n;
};

HBT_BCF_HD HBT_BCF_INLINE int32_t clamp32(int64_t v) {
  return static_cast<int32_t>(v < INT32_MIN ? INT32_MIN : v > INT32_MAX ? INT32_MAX : v);
}

HBT_BCF_HD HBT_BCF_INLINE Frame frame(const Walk& w, int64_t seg0) {
  return Frame{clamp32(w.limit - 8 - seg0), clamp32(w.n - seg0)};
}

// The chain step at offset i of a staged segment: the next offset, kErr or
// kEnd.
HBT_BCF_HD HBT_BCF_INLINE int32_t succ(Frame f, const uint8_t* buf, int lead, int32_t i) {
  if (i > f.last) return static_cast<int32_t>(kEnd);
  uint32_t ls, li;
  words2(buf, lead + i, ls, li);
  return next_record(i, ls, li, f.n);
}

// ---------------------------------------------------------------------------
// 1. Map.  Indexes into a segment are ints (seg <= kMaxSeg).

// Each position's successor inside the segment, or its own index when the
// chain leaves the segment or ends at it.
HBT_BCF_HD inline void map_links(const Walk& w, int64_t seg0, const uint8_t* buf, int lead,
                                 uint32_t* lk, int tid, int nthreads) {
  const int seg = static_cast<int>(w.seg);
  const Frame f = frame(w, seg0);
  for (int i = tid; i < seg; i += nthreads) {
    const int32_t q = succ(f, buf, lead, i);
    lk[i] = static_cast<uint32_t>(q >= 0 && q < seg ? q : i);
  }
}

// Sub-segment g's strips, last first: lk[i] becomes x | c << 16, x the
// chain's first position past the sub-segment (a later one's index) or the
// position in it where the chain leaves the segment, c the records from i
// to x.  Lanes lane0, lane0 + lanes, ... of each strip.
HBT_BCF_HD inline void map_strips(const Walk& w, uint32_t* lk, int g, int lane0, int lanes) {
  const int span = static_cast<int>(w.seg) / w.nsub, lo = g * span;
  const uint32_t hi = static_cast<uint32_t>(lo + span);
  for (int j = lo + span - 32; j >= lo; j -= 32) {
    for (int L = lane0; L < 32; L += lanes) {
      const uint32_t i = static_cast<uint32_t>(j + L), l = lk[i];
      lk[i] = l == i ? i : l >= hi ? l | kOne : lk[l] + kOne;
    }
    HBT_BCF_SYNCWARP();
  }
}

// Join the sub-segments, last first: a position whose chain passes into a
// later sub-segment takes that position's (final) word plus its own count.
HBT_BCF_HD inline void map_join(const Walk& w, uint32_t* lk, int tid, int nthreads) {
  const int span = static_cast<int>(w.seg) / w.nsub;
  for (int g = w.nsub - 2; g >= 0; --g) {
    const uint32_t hi = static_cast<uint32_t>((g + 1) * span);
    for (uint32_t i = g * span + tid; i < hi; i += nthreads) {
      const uint32_t v = lk[i], x = v & 0xFFFF;
      if (x >= hi) lk[i] = lk[x] + (v & 0xFFFF0000u);
    }
    HBT_BCF_SYNC();
  }
}

// The segment exits: lk[i] = t | c << 16, t where the chain leaves the
// segment; t's own step gives the exit, and t starts a record when that
// step is a position.
HBT_BCF_HD inline void map_exits(const Walk& w, int64_t seg0, const uint8_t* buf, int lead,
                                 const uint32_t* lk, int32_t* to, uint16_t* rows, int tid,
                                 int nthreads) {
  const int seg = static_cast<int>(w.seg);
  const Frame f = frame(w, seg0);
  const int32_t seg0_32 = static_cast<int32_t>(seg0);  // a table's segments lie below 2^31
  for (int i = tid; i < seg; i += nthreads) {
    const uint32_t v = lk[i];
    const int32_t e = succ(f, buf, lead, static_cast<int32_t>(v & 0xFFFF));
    to[i] = e >= 0 ? seg0_32 + e : e;
    rows[i] = static_cast<uint16_t>((v >> 16) + (e >= 0));
  }
}

// ---------------------------------------------------------------------------
// 2. Hop.
//
// One warp reading one table entry a segment spends its time in each
// step's latency (a dependent read and the step's own instructions), ~650
// steps a split.  So the hop reads group exits: for each of a segment's first head_of(seg)
// positions, the chain's first position at or past the segment kGroup
// segments on (composed from the segment exits, all segments and head
// positions at once).  A chain of short records enters every segment near
// its start, so the hop crosses kGroup segments a step; an entry past the
// head takes one segment exit.  Then one thread a group step fills the
// entries of the segments it crossed from the segment exits, all steps at
// once.  The rows are counted on the way, so every entry gets its base.

// Segment k's group exits (threads tid, tid + nthreads, ... over its head
// positions): follow the segment exits to the first position at or past
// segment k + kGroup (or the slab's end), or to a sink.
HBT_BCF_HD inline void compose(const Walk& w, int64_t slab0, int64_t nseg, const Work& t,
                               int64_t k, int tid, int nthreads) {
  const int head = head_of(w.seg);
  const uint32_t end = static_cast<uint32_t>((k + kGroup < nseg ? k + kGroup : nseg) << w.shift);
  for (int h = tid; h < head; h += nthreads) {
    uint32_t rel = static_cast<uint32_t>(k << w.shift) + h;
    int32_t to, rows = 0;
    for (;;) {
      to = t.to[rel];
      rows += t.rows[rel];
      if (to < 0) break;
      rel = static_cast<uint32_t>(to - slab0);
      if (rel >= end) break;
    }
    t.groups[k * head + h] = Exit{to, rows};
  }
}

// One slab's hop over its nseg segments from slab0, lanes lane0, lane0 +
// lanes, ... of one warp (every lane walks; lane 0 writes).  Inside the
// slab's segments the exits say where the chain ends (kEnd at a position
// with p + 8 > limit, kErr past the payload), so only a cursor past them
// is judged here.
HBT_BCF_HD inline void hop(const Walk& w, int64_t slab0, int64_t nseg, bool first, const Work& t,
                           int64_t* meta, int lane0, int lanes) {
  for (int64_t k = lane0; k < nseg; k += lanes) t.entry[k] = t.until[k] = -1;
  HBT_BCF_SYNCWARP();
  Carry c = first ? Carry{w.start, 0, kWalking, 0} : *t.carry;
  const int64_t slab_end = slab0 + (nseg << w.shift);
  if (c.status == kWalking && c.cur < slab_end) {
    const uint32_t end = static_cast<uint32_t>(slab_end - slab0);
    const uint32_t mask = static_cast<uint32_t>(w.seg) - 1;
    const int head = head_of(w.seg);
    uint32_t rel = static_cast<uint32_t>(c.cur - slab0);
    do {
      const uint32_t k = rel >> w.shift, off = rel & mask;
      const bool group = static_cast<int>(off) < head;
      const Exit x = group ? t.groups[k * head + off] : Exit{t.to[rel], t.rows[rel]};
      if (lane0 == 0) {
        t.entry[k] = static_cast<int32_t>(slab0 + rel);
        t.base[k] = static_cast<int32_t>(c.rows);
        if (group) t.until[k] = x.to < 0 ? INT32_MAX : x.to;
      }
      c.rows += x.rows;
      ++c.hops;
      if (x.to < 0) {
        c.status = x.to == kErr ? kFailed : kEnded;
        break;
      }
      rel = static_cast<uint32_t>(x.to - slab0);
    } while (rel < end);
    c.cur = slab0 + rel;
  }
  if (c.status == kWalking) {
    if (c.cur + 8 > w.limit) c.status = kEnded;
    else if (c.cur - w.start >= w.width) c.status = kFailed;  // past the payload
    // else: at or past the slab's end, the next slab's
  }
  if (lane0 == 0) {
    *t.carry = c;
    meta[0] = c.rows;
    meta[1] = c.status == kEnded ? 1 : 0;
  }
}

// The entries and bases of the segments crossed by the group step read at
// segment k's entry (one thread; the steps' segments are disjoint).
HBT_BCF_HD inline void fill(const Walk& w, int64_t slab0, const Work& t, int64_t k) {
  const int32_t until = t.until[k];
  if (until < 0) return;
  uint32_t rel = static_cast<uint32_t>(t.entry[k] - slab0);
  int32_t rows = t.base[k];
  for (;;) {
    const int32_t to = t.to[rel];
    rows += t.rows[rel];
    if (to < 0 || to >= until) return;
    rel = static_cast<uint32_t>(to - slab0);
    t.entry[rel >> w.shift] = to;
    t.base[rel >> w.shift] = rows;
  }
}

// ---------------------------------------------------------------------------
// 3. Emit.

// The records of the segment from its entry e: their indexes into starts;
// returns how many.  One thread.
HBT_BCF_HD inline int emit_walk(const Walk& w, int64_t seg0, const uint8_t* buf, int lead,
                                int64_t e, int32_t* starts) {
  const Frame f = frame(w, seg0);
  const int32_t seg = static_cast<int32_t>(w.seg);
  int m = 0;
  for (int32_t i = static_cast<int32_t>(e - seg0); i < seg;) {
    const int32_t q = succ(f, buf, lead, i);
    if (q < 0) break;
    starts[m++] = i;
    i = q;
  }
  return m;
}

// Rows row0 .. row0 + m - 1 of cols (int32 [7][cap]): the start offset and
// the six fixed shared words, reinterpreted from u32.  A record's fixed
// fields lie in the staged halo.
HBT_BCF_HD inline void emit_rows(const Walk& w, int64_t seg0, const uint8_t* buf, int lead,
                                 const int32_t* starts, int m, int64_t row0, int32_t* cols,
                                 int64_t cap, int tid, int nthreads) {
  for (int j = tid; j < m; j += nthreads) {
    const int i = starts[j];
    const int64_t row = row0 + j;
    cols[row] = static_cast<int32_t>(seg0 + i);
    for (int f = 0; f < 6; f += 2) {
      uint32_t a, b;
      words2(buf, lead + i + 8 + 4 * f, a, b);
      cols[(1 + f) * cap + row] = static_cast<int32_t>(a);
      cols[(2 + f) * cap + row] = static_cast<int32_t>(b);
    }
  }
}

}  // namespace hbt_bcf
