// The walk core of csrc/chain.cu: the BAM record chain of a split's record
// stream, decided by segments in parallel and exactly.  The device runs each
// phase with a block's threads; a host build with g++ runs the same
// functions with the threads as loops, which the CPU tests hold to the plain
// version.
//
// Records are [u32 block_size][body] back to back.  The walk starts at 0,
// keeps starting records while p < n and steps p += 4 + block_size; a size
// word below 32 or above 2^28 stops it with an error and starts no record.
// Bytes at or past n read 0.  A record running past n is counted and the
// walk fails; it ends ok only on p == n.
//
// The chain is serial from 0, but where it leaves a stretch of bytes is a
// function of the position at which it enters, and each stretch can
// tabulate that function alone.  So the stream (positions 0 .. n - 1, the
// ones that can start a record) is cut into segments of `seg` bytes
// anchored at 0, and:
//
//   1. Map, one block a segment.  For every position p of the segment, its
//      exit (the first chain position at or past the segment's end, or the
//      sink the chain falls into: kErr at a bad size word or past n, kEnd
//      at n) and its count (the records started from p up to there).  The
//      record rule (next_record) clamps a step past n to n + 1, a failing
//      sink, so an overrun is one record and then a failure, and no table
//      carries a 2^28 jump past the stream.  succ(p) >= p + 36 or is a sink,
//      so the segment is cut into `nsub` sub-segments of 32-position strips;
//      warp g walks its sub-segment's strips backward, taking each
//      position's step as it goes (a strip reads only later strips), then
//      the block joins the sub-segments backward, one pass each.  Every
//      word is then final in shared memory, and the block copies the
//      segment's words out: 4 bytes a position of a slab (the table word,
//      below).
//   2. Hop.  Compose, one block a segment: for each of the segment's first
//      positions (its head), the exit over the next kGroup segments and the
//      records before it.  Hop, one warp: from 0, read the exit at the
//      cursor (a group exit when the cursor is in its segment's head, else a
//      segment exit), record entry[k] = cursor and base[k] = rows so far for
//      the cursor's segment, add the count, move to the exit.  Fill, one
//      thread a group step: the entries and bases of the segments the step
//      crossed, from the segment exits.  Segments the chain jumps over keep
//      entry -1.
//   3. Emit, one block a segment with entry >= 0.  Thread 0 re-walks the
//      segment from its entry (stopping at its end or at a sink) into a
//      list in shared memory, then the block writes the int64 offsets into
//      rows base[k] + j and, when asked, each record's packed sort key and
//      unmapped byte from the same staged bytes (the key gather of
//      hadoop_bam_tpu/ops/decode.py _stream_keys, folded in).
//
// A stream longer than a slab goes slab by slab; the cursor, the row count
// and the verdict ride in device memory (Carry) from one hop to the next.
// Every position in the tables is relative to its slab's first byte (a slab
// is at most 2^30 bytes and a step at most 4 + 2^28 past a segment), so
// int32 holds it whatever the stream's length; offsets, the cursor and the
// rows are int64.
// Every table value is a function of the bytes alone and the hop follows
// the chain the serial walk follows, so the result is the serial walk's.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define HBT_CHAIN_HD __host__ __device__
#define HBT_CHAIN_INLINE __forceinline__
#else
#define HBT_CHAIN_HD
#define HBT_CHAIN_INLINE inline
#endif

#ifdef __CUDA_ARCH__
#define HBT_CHAIN_SYNC() __syncthreads()
#define HBT_CHAIN_SYNCWARP() __syncwarp()
#else
#define HBT_CHAIN_SYNC() ((void)0)
#define HBT_CHAIN_SYNCWARP() ((void)0)
#endif

namespace hbt_chain {

constexpr uint32_t kMinBody = 32;     // the fixed fields every record carries
constexpr uint32_t kMaxBody = 1u << 28;
constexpr int32_t kErr = -1;          // exits: a bad size word, or a position past n
constexpr int32_t kEnd = -2;          //        position n: the walk ends ok
constexpr int kHalo = 8;              // bytes staged past a segment: a size word's read
constexpr int kEmitHalo = 24;         // the emit's: a record's key fields end 20 bytes past
                                      // its start, and word_at reads the word after
constexpr int64_t kMaxSeg = 1 << 16;  // a position's index in a segment fits 16 bits
constexpr int64_t kMaxSlab = 1 << 30; // a position's offset in a slab, plus a step, fits int32
constexpr uint32_t kOne = 1u << 16;   // one record, in a table word

enum : int64_t { kWalking = 0, kEnded = 1, kFailed = 2 };

struct Walk {
  const uint8_t* s;  // the stream
  int64_t n;         // its bytes
  int64_t seg;       // bytes a segment: 2^shift, a multiple of 32 * nsub, at most kMaxSeg
  int nsub;          // sub-segments of the map (warps of its block)
  int shift;
};

// log2(seg) for a power of two, else -1.
HBT_CHAIN_HD inline int seg_shift(int64_t seg) {
  int sh = 0;
  while ((int64_t{1} << sh) < seg && sh < 62) ++sh;
  return (int64_t{1} << sh) == seg ? sh : -1;
}

// An exit over a group of segments: the chain position (slab-relative),
// kErr or kEnd, and the records started before it.
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

// The chain step at offset i of a segment, whose size word is bs; n is the
// stream's end from the segment's first position, clamped to int32.  At n
// the walk ends ok (kEnd); past n, or at a bad size word, it fails (kErr)
// and starts no record.  Otherwise one record, and the step goes to
// i + 4 + bs, or to n + 1 (a failing sink) when that runs past n.  The walk
// only asks at i < kMaxSeg, so i + 4 + bs < 2^29 and int32 holds it; n + 1
// is taken only when n < i + 4 + bs, so it does not overflow either.
HBT_CHAIN_HD HBT_CHAIN_INLINE int32_t next_record(int32_t i, uint32_t bs, int32_t n) {
  if (i >= n) return i == n ? kEnd : kErr;
  if (bs < kMinBody || bs > kMaxBody) return kErr;
  const int32_t q = i + 4 + static_cast<int32_t>(bs);
  return q > n ? n + 1 : q;
}

// ---------------------------------------------------------------------------
// Geometry and the workspace.

struct Plan {
  int64_t segs;      // segments in all: positions 0 .. n - 1
  int64_t per_slab;  // segments of one slab's table (at least 1)
  int64_t slabs;     // hops launched (at least 1, which writes meta)
};

HBT_CHAIN_HD inline Plan make_plan(int64_t n, int64_t seg, int64_t slab) {
  Plan p;
  p.segs = n > 0 ? (n + seg - 1) / seg : 0;
  const int64_t spl = slab / seg;
  p.per_slab = p.segs < spl ? (p.segs > 0 ? p.segs : 1) : spl;
  p.slabs = p.segs > 0 ? (p.segs + spl - 1) / spl : 1;
  return p;
}

constexpr int kHead = 320;   // a segment's first positions with a group exit
constexpr int kGroup = 32;   // segments a group exit crosses

// Positions of a segment with a group exit: kHead, at most an eighth of a
// segment.
HBT_CHAIN_HD HBT_CHAIN_INLINE int head_of(int64_t seg) {
  return seg / 8 < kHead ? static_cast<int>(seg / 8) : kHead;
}

// The workspace of one slab: the Carry; entry, base and until (int32) a
// segment; from a 16-byte boundary the group exits (an Exit a head
// position); then the segment exits, a table word a position, and the far
// exits (int32 a position, written only where a word is kFar): 8 bytes a
// byte of the slab and 8 bytes a head position.
HBT_CHAIN_HD inline int64_t groups_offset(const Plan& p) {
  return (static_cast<int64_t>(sizeof(Carry)) + 12 * p.per_slab + 15) / 16 * 16;
}

HBT_CHAIN_HD inline int64_t work_bytes(const Plan& p, int64_t seg) {
  return groups_offset(p) + 8 * p.per_slab * head_of(seg) + 8 * p.per_slab * seg;
}

struct Work {
  Carry* carry;
  int32_t* entry;   // the chain's first position in the segment (slab-relative), or -1
  int32_t* base;    // the records before it (a stream of under 77 GB has < 2^31)
  int32_t* until;   // where a group exit read at entry leads, or -1
  Exit* groups;     // [segment][head position]
  uint32_t* exits;  // [position]: the table word of the segment exit
  int32_t* far;     // [position]: a far exit (slab-relative), where a word says kFar
};

// The workspace's parts, from its (16-aligned) first byte.  The group
// exits take a multiple of 16 bytes (head_of is even), so exits is
// 16-aligned.
HBT_CHAIN_HD inline Work carve(void* work, const Plan& p, int64_t seg) {
  uint8_t* wk = static_cast<uint8_t*>(work);
  int32_t* entry = reinterpret_cast<int32_t*>(wk + sizeof(Carry));
  Exit* groups = reinterpret_cast<Exit*>(wk + groups_offset(p));
  uint32_t* exits = reinterpret_cast<uint32_t*>(groups + p.per_slab * head_of(seg));
  return Work{reinterpret_cast<Carry*>(wk), entry, entry + p.per_slab, entry + 2 * p.per_slab,
              groups, exits, reinterpret_cast<int32_t*>(exits + p.per_slab * seg)};
}

// A table word: bits 0-15 the exit's code, bits 16-29 the records before
// the exit (at most kMaxSeg / 36 + 1), bit 30 kFar.  A code below kCodeEnd
// puts the exit that many bytes past the segment's end; kCodeEnd and
// kCodeErr are the sinks; with kFar the code is the position in the
// segment whose step leaves it, and far[] at that position holds the exit.
// While the map runs, a word without kFinal is instead the index of a
// position in a later sub-segment (bits 0-15) and the records up to it.
constexpr uint32_t kCodeEnd = 0xFFFE, kCodeErr = 0xFFFF;
constexpr uint32_t kFar = 1u << 30;
constexpr uint32_t kFinal = 1u << 31;
constexpr uint32_t kRows = 0x3FFF0000u;

// The segment exit at slab-relative position rel: the position
// (slab-relative), kErr or kEnd, and the records before it.
HBT_CHAIN_HD HBT_CHAIN_INLINE Exit exit_at(const Work& t, uint32_t rel, int shift) {
  const uint32_t v = t.exits[rel], c = v & 0xFFFF, seg0 = rel >> shift << shift;
  const int32_t to = v & kFar ? t.far[seg0 + c]
                   : c == kCodeErr ? kErr
                   : c == kCodeEnd ? kEnd
                   : static_cast<int32_t>(seg0 + (1u << shift) + c);
  return Exit{to, static_cast<int32_t>((v & kRows) >> 16)};
}

// Shared memory: the staged bytes of a segment (16-aligned lead, the
// segment, kHalo, rounded up).
HBT_CHAIN_HD constexpr int64_t stage_bytes(int64_t seg) { return seg + 32; }
// The map: a table word a position, then the staged bytes.
HBT_CHAIN_HD constexpr int64_t map_smem(int64_t seg) { return 4 * seg + stage_bytes(seg); }
// The emit: the staged bytes with kEmitHalo, then its list (a count and an
// offset a record; a record takes >= 36 bytes).
HBT_CHAIN_HD constexpr int64_t emit_stage_bytes(int64_t seg) { return seg + 48; }
HBT_CHAIN_HD constexpr int64_t emit_smem(int64_t seg) {
  return emit_stage_bytes(seg) + 4 * (seg / 36 + 3);
}

// ---------------------------------------------------------------------------
// Primitives, plain on the host.

// The u32 at byte offset off of the 16-aligned staged buffer.
HBT_CHAIN_HD HBT_CHAIN_INLINE uint32_t word_at(const uint8_t* buf, int off) {
#ifdef __CUDA_ARCH__
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf) + (off >> 2);
  return __funnelshift_r(w[0], w[1], static_cast<uint32_t>(off & 3) * 8);
#else
  uint32_t v;
  memcpy(&v, buf + off, 4);
  return v;
#endif
}

// 16 bytes from device memory to shared memory without a register round
// trip (cp.async; every copy of the thread lands at wait_copies()); a plain
// copy on the host.
HBT_CHAIN_HD HBT_CHAIN_INLINE void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

HBT_CHAIN_HD HBT_CHAIN_INLINE void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// Stage s[from - lead .. from + seg + halo) into buf with 16-byte copies
// from the 16-aligned address at or below s + from, all in flight at once;
// returns lead once this thread's copies landed (the block syncs next).
// Bytes outside [0, n) read 0.
HBT_CHAIN_HD inline int stage(const Walk& w, int64_t from, uint8_t* buf, int tid, int nthreads,
                              int halo = kHalo) {
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(w.s) + from) & 15);
  const int64_t base = from - lead;
  const int nvec = static_cast<int>((lead + w.seg + halo + 15) / 16);
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

// The stream's end from a segment's first position, clamped to int32.
HBT_CHAIN_HD HBT_CHAIN_INLINE int32_t frame(const Walk& w, int64_t seg0) {
  const int64_t v = w.n - seg0;
  return static_cast<int32_t>(v > INT32_MAX ? INT32_MAX : v);
}

// The chain step at offset i of a staged segment: the next offset, kErr or
// kEnd.
HBT_CHAIN_HD HBT_CHAIN_INLINE int32_t succ(int32_t n, const uint8_t* buf, int lead, int32_t i) {
  return next_record(i, word_at(buf, lead + i), n);
}

// ---------------------------------------------------------------------------
// 1. Map.  Indexes into a segment are ints (seg <= kMaxSeg).

// Sub-segment g's strips, last first, lanes lane0, lane0 + lanes, ... of
// each: position i takes its step q and becomes a final word when q is a
// sink or leaves the segment, else the index of q (a later sub-segment's
// position) with one record, else q's word (a later strip's) plus one
// record.  A step past n (to n + 1) is one record into the failing sink, so
// no position reads a word of its own strip.  A far exit goes to far[i]
// (the segment's far exits; rel0 is its first byte from the slab's).
HBT_CHAIN_HD inline void map_strips(const Walk& w, int64_t seg0, int32_t rel0, const uint8_t* buf,
                                    int lead, uint32_t* lk, int32_t* far, int g, int lane0,
                                    int lanes) {
  const int32_t seg = static_cast<int32_t>(w.seg), span = seg / w.nsub, lo = g * span;
  const int32_t hi = lo + span, n = frame(w, seg0);
  for (int32_t j = hi - 32; j >= lo; j -= 32) {
    for (int32_t L = lane0; L < 32; L += lanes) {
      const int32_t i = j + L, q = succ(n, buf, lead, i);
      uint32_t v;
      if (q == kErr) {
        v = kFinal | kCodeErr;  // a bad size word, or a position past n: no record
      } else if (q == kEnd) {
        v = kFinal | kCodeEnd;
      } else if (q > n) {
        v = kFinal | kCodeErr | kOne;
      } else if (q >= seg) {
        const uint32_t c = static_cast<uint32_t>(q - seg);
        if (c < kCodeEnd) {
          v = kFinal | c | kOne;
        } else {
          far[i] = rel0 + q;
          v = kFinal | kFar | static_cast<uint32_t>(i) | kOne;
        }
      } else {
        v = q >= hi ? static_cast<uint32_t>(q) | kOne : lk[q] + kOne;
      }
      lk[i] = v;
    }
    HBT_CHAIN_SYNCWARP();
  }
}

// Join the sub-segments, last first: a word that is an index takes that
// position's (final) word plus its own count.
HBT_CHAIN_HD inline void map_join(const Walk& w, uint32_t* lk, int tid, int nthreads) {
  const int span = static_cast<int>(w.seg) / w.nsub;
  for (int g = w.nsub - 2; g >= 0; --g) {
    for (int i = g * span + tid; i < (g + 1) * span; i += nthreads) {
      const uint32_t v = lk[i];
      if (!(v & kFinal)) lk[i] = lk[v & 0xFFFF] + (v & kRows);
    }
    HBT_CHAIN_SYNC();
  }
}

// The segment's words out to its table, four a thread at a time.
HBT_CHAIN_HD inline void map_store(const Walk& w, const uint32_t* lk, uint32_t* exits, int tid,
                                   int nthreads) {
  for (int64_t i = 4 * tid; i < w.seg; i += 4 * nthreads) {
#ifdef __CUDA_ARCH__
    uint4 v = *reinterpret_cast<const uint4*>(lk + i);
    v.x &= ~kFinal;
    v.y &= ~kFinal;
    v.z &= ~kFinal;
    v.w &= ~kFinal;
    *reinterpret_cast<uint4*>(exits + i) = v;
#else
    for (int k = 0; k < 4; ++k) exits[i + k] = lk[i + k] & ~kFinal;
#endif
  }
}

// ---------------------------------------------------------------------------
// 2. Hop.
//
// One warp reading one table entry a segment spends its time in each
// step's latency (a dependent read and the step's own instructions).  So
// the hop reads group exits: for each of a segment's first head_of(seg)
// positions, the chain's first position at or past the segment kGroup
// segments on (composed from the segment exits, all segments and head
// positions at once).  A chain of records shorter than the head enters
// every segment in its head, so the hop crosses kGroup segments a step; an
// entry past the head takes one segment exit.  Then one thread a group step
// fills the entries of the segments it crossed from the segment exits, all
// steps at once.  The rows are counted on the way, so every entry gets its
// base.

// Segment k's group exits (threads tid, tid + nthreads, ... over its head
// positions): follow the segment exits to the first position at or past
// segment k + kGroup (or the slab's end), or to a sink.
HBT_CHAIN_HD inline void compose(const Walk& w, int64_t nseg, const Work& t, int64_t k, int tid,
                                 int nthreads) {
  const int head = head_of(w.seg);
  const uint32_t end = static_cast<uint32_t>((k + kGroup < nseg ? k + kGroup : nseg) << w.shift);
  for (int h = tid; h < head; h += nthreads) {
    uint32_t rel = static_cast<uint32_t>(k << w.shift) + h;
    Exit g{0, 0};
    for (;;) {
      const Exit x = exit_at(t, rel, w.shift);
      g = Exit{x.to, g.rows + x.rows};
      if (x.to < 0) break;
      rel = static_cast<uint32_t>(x.to);
      if (rel >= end) break;
    }
    t.groups[k * head + h] = g;
  }
}

// One slab's hop over its nseg segments from slab0, lanes lane0, lane0 +
// lanes, ... of one warp (every lane walks; lane 0 writes).  Inside the
// slab's segments the exits say where the chain ends (kEnd at n, kErr past
// it), so only a cursor past them is judged here.
HBT_CHAIN_HD inline void hop(const Walk& w, int64_t slab0, int64_t nseg, bool first, const Work& t,
                             int64_t* meta, int lane0, int lanes) {
  for (int64_t k = lane0; k < nseg; k += lanes) t.entry[k] = t.until[k] = -1;
  HBT_CHAIN_SYNCWARP();
  Carry c = first ? Carry{0, 0, kWalking, 0} : *t.carry;
  const int64_t slab_end = slab0 + (nseg << w.shift);
  if (c.status == kWalking && c.cur < slab_end) {
    const uint32_t end = static_cast<uint32_t>(nseg << w.shift);
    const uint32_t mask = static_cast<uint32_t>(w.seg) - 1;
    const int head = head_of(w.seg);
    uint32_t rel = static_cast<uint32_t>(c.cur - slab0);
    do {
      const uint32_t k = rel >> w.shift, off = rel & mask;
      const bool group = static_cast<int>(off) < head;
      const Exit x = group ? t.groups[k * head + off] : exit_at(t, rel, w.shift);
      if (lane0 == 0) {
        t.entry[k] = static_cast<int32_t>(rel);
        t.base[k] = static_cast<int32_t>(c.rows);
        if (group) t.until[k] = x.to < 0 ? INT32_MAX : x.to;
      }
      c.rows += x.rows;
      ++c.hops;
      if (x.to < 0) {
        c.status = x.to == kErr ? kFailed : kEnded;
        break;
      }
      rel = static_cast<uint32_t>(x.to);
    } while (rel < end);
    c.cur = slab0 + rel;
  }
  if (c.status == kWalking) {
    if (c.cur == w.n) c.status = kEnded;
    else if (c.cur > w.n) c.status = kFailed;  // a step past n that left the last segment
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
HBT_CHAIN_HD inline void fill(const Walk& w, const Work& t, int64_t k) {
  const int32_t until = t.until[k];
  if (until < 0) return;
  uint32_t rel = static_cast<uint32_t>(t.entry[k]);
  int32_t rows = t.base[k];
  for (;;) {
    const Exit x = exit_at(t, rel, w.shift);
    rows += x.rows;
    if (x.to < 0 || x.to >= until) return;
    rel = static_cast<uint32_t>(x.to);
    t.entry[rel >> w.shift] = x.to;
    t.base[rel >> w.shift] = rows;
  }
}

// ---------------------------------------------------------------------------
// 3. Emit.

// The sort keys the emit writes beside the offsets: rows [0, n_rows) of
// keys and unmapped, or none when keys is null.
struct Keys {
  int64_t* keys;
  uint8_t* unmapped;
  int64_t n_rows;
};

// The emit's stage of the segment at seg0: wide enough for the key fields
// of a record starting at its last byte.
HBT_CHAIN_HD inline int emit_stage(const Walk& w, int64_t seg0, uint8_t* buf, int tid,
                                   int nthreads) {
  return stage(w, seg0, buf, tid, nthreads, kEmitHalo);
}

// The emit's list in its shared memory: [0] the count, then the records'
// offsets in the segment.
HBT_CHAIN_HD HBT_CHAIN_INLINE int32_t* emit_list(uint8_t* smem, int64_t seg) {
  return reinterpret_cast<int32_t*>(smem + emit_stage_bytes(seg));
}

// The records of segment k of the slab at slab0 from its entry, their
// offsets in the segment into at[0, 1, ...]; returns how many.  One thread.
HBT_CHAIN_HD inline int32_t emit_walk(const Walk& w, int64_t slab0, const Work& t, int64_t k,
                                      const uint8_t* buf, int lead, int32_t* at) {
  const int32_t n = frame(w, slab0 + (k << w.shift));
  const int32_t seg = static_cast<int32_t>(w.seg);
  int32_t m = 0;
  for (int32_t i = t.entry[k] - static_cast<int32_t>(k << w.shift); i < seg;) {
    const int32_t q = succ(n, buf, lead, i);
    if (q < 0) break;
    at[m++] = i;
    i = q;
  }
  return m;
}

// The packed sort key and the unmapped byte of a record with these
// fields: Java's (long)refid << 32 | pos, the sign of a negative low word
// flooding the high word; unmapped when flag & 4, refid < 0 or pos + 1 < 0
// in int32, and then INT_MAX << 32 until the host's murmur3 hash is
// patched in.
HBT_CHAIN_HD HBT_CHAIN_INLINE void pack_key(int32_t refid, int32_t pos, uint32_t flag,
                                            int64_t* key, uint8_t* unmapped) {
  const int32_t pos1 = static_cast<int32_t>(static_cast<uint32_t>(pos) + 1u);
  const bool unm = (flag & 0x4u) != 0 || refid < 0 || pos1 < 0;
  const int32_t lo = unm ? 0 : pos;
  const int32_t hi = lo < 0 ? -1 : unm ? 0x7fffffff : refid;
  *key = static_cast<int64_t>((static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
                              static_cast<uint32_t>(lo));
  *unmapped = unm ? 1 : 0;
}

// pack_key of the record whose size word is at byte off of the staged
// buffer.
HBT_CHAIN_HD HBT_CHAIN_INLINE void key_at(const uint8_t* buf, int off, int64_t* key,
                                          uint8_t* unmapped) {
  pack_key(static_cast<int32_t>(word_at(buf, off + 4)),
           static_cast<int32_t>(word_at(buf, off + 8)), word_at(buf, off + 16) >> 16, key,
           unmapped);
}

// The m listed records of segment k, threads tid, tid + nthreads, ...: the
// offset seg0 + at[j] into offs[base + j] and, with keys, the key and the
// unmapped byte into rows base + j below n_rows.
HBT_CHAIN_HD inline void emit_rows(const Walk& w, int64_t slab0, const Work& t, int64_t k,
                                   const uint8_t* buf, int lead, const int32_t* at, int32_t m,
                                   int64_t* offs, const Keys& kk, int tid, int nthreads) {
  const int64_t seg0 = slab0 + (k << w.shift), base = t.base[k];
  for (int32_t j = tid; j < m; j += nthreads) {
    offs[base + j] = seg0 + at[j];
    if (kk.keys != nullptr && base + j < kk.n_rows)
      key_at(buf, lead + at[j], kk.keys + base + j, kk.unmapped + base + j);
  }
}

// Rows [count, n_rows) of the keys get key 0 and unmapped 0: blocks b of
// nb, threads tid of nthreads each (the last slab's emit, after its hop).
HBT_CHAIN_HD inline void emit_rest(const Keys& kk, int64_t count, int64_t b, int64_t nb, int tid,
                                   int nthreads) {
  for (int64_t r = count + b * nthreads + tid; r < kk.n_rows; r += nb * nthreads) {
    kk.keys[r] = 0;
    kk.unmapped[r] = 0;
  }
}

}  // namespace hbt_chain
