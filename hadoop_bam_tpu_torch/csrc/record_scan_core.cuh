// The scan core of csrc/record_scan.cu: the FASTQ record scan of one chunk,
// decided a tile at a time by the block's threads in parallel and exactly.
// The device runs scan_chunk with a block's threads; a host build with g++
// runs the same function with the threads as loops (HBT_RS_EACH), which the
// CPU tests hold to the plain version.
//
// What it computes is the line machine of ops/kernels/record_scan.py
// (_scan_one): lines end at newlines; a line is (start, first byte or -1,
// CR-stripped length); frame(i) holds when line i starts with '@', line
// i + 2 with '+' and lines i + 1 and i + 3 have one length.  An aligned
// window's records are the lines 0, 4, 8, ...; an unaligned window syncs
// at the least i with frame(i) and frame(i + 4) (two verified frames, no
// end-of-data relaxation), claims i and i + 4 under one cap test, and
// continues at i + 8, i + 12, ...  A record is claimed when it starts
// before chunk_len.  The scan stops at the first record that is not
// claimed (done, ok kept), is not a frame (ok = 0) or passes the cap
// (ok = 0, not written); a final window's unterminated last line completes
// through a synthetic newline; then a claimed frame left partial,
// dangling claimed text and a window that never synced over content give
// ok = 0.
//
// The machine is serial in form only: every quantity it reads is a
// function of the line table, and each decision is "the first line at
// which a condition holds".  So the window is read in tiles of `tile`
// bytes (double-buffered in shared memory, 16-byte cp.async from the
// 16-byte boundary at or below the window's start, nothing read at or past
// its end), and each tile goes through block-synchronous steps:
//
//   1. Count.  Each thread takes its 16-byte vectors and counts their
//      newlines; a block scan gives every newline its line number and the
//      newline before it (the lines of earlier tiles are the carry).
//   2. Lines.  Each newline writes its line's entry (where it ends, its
//      first byte, whether a CR ends it) into a ring of tile + kBack
//      4-byte entries, indexed by line number; a line starts where the one
//      before it ends.  A line's first byte and the byte before its newline
//      may lie in an earlier tile: the open line's first byte and the byte
//      before the tile are carried.
//   3. Decide, by block minima over the tile's complete frames: the sync
//      line (unsynced windows), then the first record at which the scan
//      stops.  The records before it are written in parallel, a row as two
//      16-byte stores, and the block loads no tile after a stop.
//
// Every line value is a function of the bytes alone and every decision is
// the machine's, at the same line, so the result is the machine's.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define HBT_RS_HD __host__ __device__
#define HBT_RS_INLINE __forceinline__
#else
#define HBT_RS_HD
#define HBT_RS_INLINE inline
#endif

// A block-synchronous step: on the device each thread runs the body once as
// thread `tid`; on the host the body runs for every thread in turn.
#ifdef __CUDA_ARCH__
#define HBT_RS_SYNC() __syncthreads()
#define HBT_RS_EACH(tid, nth) for (int tid = threadIdx.x, tid##_once = 1; tid##_once; tid##_once = 0)
#else
#define HBT_RS_SYNC() ((void)0)
#define HBT_RS_EACH(tid, nth) for (int tid = 0; tid < (nth); ++tid)
#endif

namespace hbt_scan {

constexpr int kAt = 0x40;
constexpr int kPlus = 0x2B;
constexpr int kNl = 0x0A;
constexpr int kCr = 0x0D;
constexpr int kBack = 8;               // lines of earlier tiles a tile reads: a sync reads i .. i + 7
constexpr int32_t kNone = 0x7FFFFFFF;  // no line or record: the identity of a block minimum
constexpr int kPhases = 5;             // wait, count, lines, decide, tail (cycle stamps)

struct Chunk {
  const uint8_t* w;  // the window
  int32_t n;         // its bytes, at most 2^17 (an entry holds n + 1 in 18 bits)
  int32_t chunk_len, cap, aligned, final_;
  int32_t lead;      // bytes from the 16-byte boundary at or below w to w
  int32_t* rows;     // the chunk's first row (8 int32 a record)
};

// A line's ring entry: bits 0-17 its newline's window offset + 1 (the next
// line's start), bit 18 a CR before that newline (stripped from the
// length), bits 19-27 its first byte + 1 (0 for an empty line).  Line -1
// is the entry 0: line 0 starts at 0.
HBT_RS_HD HBT_RS_INLINE uint32_t entry(int32_t p, int32_t cr, int32_t fc) {
  return static_cast<uint32_t>(p + 1) | static_cast<uint32_t>(cr) << 18 |
         static_cast<uint32_t>(fc + 1) << 19;
}
HBT_RS_HD HBT_RS_INLINE int32_t end_of(uint32_t e) { return static_cast<int32_t>(e & 0x3FFFF); }
HBT_RS_HD HBT_RS_INLINE int32_t cr_of(uint32_t e) { return static_cast<int32_t>(e >> 18 & 1); }
HBT_RS_HD HBT_RS_INLINE int32_t fc_of(uint32_t e) { return static_cast<int32_t>(e >> 19) - 1; }
// The CR-stripped length of a line from its entry and the one before it.
HBT_RS_HD HBT_RS_INLINE int32_t eff_of(uint32_t before, uint32_t e) {
  return end_of(e) - end_of(before) - 1 - cr_of(e);
}

// Shared memory: the ring of lines, two tiles, the scan's per-thread and
// per-warp words and four block minima (a tile's sync line and stop
// record; the same for the synthetic final line).
struct Layout {
  uint32_t* ring;  // R = tile + kBack line entries, line l at slot l mod R
  uint8_t* buf;    // tiles t & 1 = 0 and 1, 16-aligned
  int32_t* cnt;    // per thread: its newlines, then the tile's newlines before it
  int32_t* last;   // per thread: its last newline (-1), then the last one before it
  int32_t* wcnt;   // per warp (the device's scan)
  int32_t* wlast;
  int32_t* red;
  int tile, R;
};

HBT_RS_HD inline int64_t smem_bytes(int tile, int nth) {
  const int64_t warps = (nth + 31) / 32;
  return 4 * static_cast<int64_t>(tile + kBack) + 2 * static_cast<int64_t>(tile) + 8 * nth +
         8 * warps + 16;
}

HBT_RS_HD inline Layout carve(uint8_t* smem, int tile, int nth) {
  Layout L;
  L.tile = tile;
  L.R = tile + kBack;
  L.ring = reinterpret_cast<uint32_t*>(smem);
  L.buf = smem + 4 * L.R;
  int32_t* p = reinterpret_cast<int32_t*>(L.buf + 2 * tile);
  const int warps = (nth + 31) / 32;
  L.cnt = p;
  L.last = p + nth;
  L.wcnt = p + 2 * nth;
  L.wlast = L.wcnt + warps;
  L.red = L.wlast + warps;
  return L;
}

// The scan's state, the same in every thread: the line machine's, by line
// number, plus the carry from one tile to the next.
struct Scan {
  int32_t l0;       // lines completed before the tile
  int32_t r0;       // the ring slot of line l0
  int32_t open;     // where the open (unterminated) line starts
  int32_t open_fc;  // its first byte, -1 while it has none
  int32_t prev;     // the byte before the tile; after the last tile, the window's last byte
  int32_t synced, next, nrec, ok, done, stopped;  // next: the first record line not decided
};

HBT_RS_HD HBT_RS_INLINE Scan begin(const Chunk& c) {
  return Scan{0, 0, 0, -1, -1, c.aligned, 0, 0, 1, 0, 0};
}

// The ring slot of line l (l0 - kBack <= l < l0 + tile; line -1 at first).
HBT_RS_HD HBT_RS_INLINE int slot(const Scan& s, const Layout& L, int32_t l) {
  const int x = s.r0 + (l - s.l0);
  return x >= L.R ? x - L.R : x < 0 ? x + L.R : x;
}

HBT_RS_HD HBT_RS_INLINE uint32_t line_at(const Scan& s, const Layout& L, int32_t l) {
  return L.ring[slot(s, L, l)];
}

// Where line l starts.
HBT_RS_HD HBT_RS_INLINE int32_t start_of(const Scan& s, const Layout& L, int32_t l) {
  return end_of(line_at(s, L, l - 1));
}

// Lines i .. i + 3 form one (@, seq, +, qual) frame with len(seq) == len(qual).
HBT_RS_HD HBT_RS_INLINE bool frame(const Scan& s, const Layout& L, int32_t i) {
  const uint32_t a = line_at(s, L, i), b = line_at(s, L, i + 1), c = line_at(s, L, i + 2),
                 d = line_at(s, L, i + 3);
  return fc_of(a) == kAt && fc_of(c) == kPlus && eff_of(a, b) == eff_of(c, d);
}

// ---------------------------------------------------------------------------
// Primitives, plain on the host.

HBT_RS_HD HBT_RS_INLINE int popc(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// The highest and the lowest set bit of m != 0.
HBT_RS_HD HBT_RS_INLINE int high_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(m);
#else
  return 31 - __builtin_clz(m);
#endif
}

HBT_RS_HD HBT_RS_INLINE int low_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// 16 bytes from device memory to shared memory without a register round
// trip (cp.async; every copy of the thread lands at wait_copies()); a plain
// copy on the host.
HBT_RS_HD HBT_RS_INLINE void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

HBT_RS_HD HBT_RS_INLINE void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// The newlines of the 16 staged bytes at p, whose first is window offset q,
// as a 16-bit mask; bytes outside [0, n) are none.
HBT_RS_HD HBT_RS_INLINE uint32_t newlines16(const uint8_t* p, int32_t q, int32_t n) {
  uint32_t m = 0;
#ifdef __CUDA_ARCH__
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t word[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t e = __vcmpeq4(word[k], 0x0A0A0A0Au);
    m |= (((e >> 7) & 1u) | ((e >> 14) & 2u) | ((e >> 21) & 4u) | ((e >> 28) & 8u)) << (4 * k);
  }
#else
  for (int b = 0; b < 16; ++b) m |= static_cast<uint32_t>(p[b] == kNl) << b;
#endif
  const int32_t lo = q < 0 ? -q : 0, hi = n - q < 16 ? n - q : 16;
  if (hi <= lo) return 0;
  return m & ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

struct Tot {
  int32_t lines;  // newlines of the tile
  int32_t last;   // the last newline up to the tile's end (the carry if none)
};

// Exclusive block scan of cnt (sum) and last (max) in thread order, the
// carry below every last; returns the tile's totals.  On the device every
// thread calls it, once, with its own entries written.
HBT_RS_HD inline Tot block_scan(const Layout& L, int32_t carry, int nth) {
#ifdef __CUDA_ARCH__
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5, nw = nth >> 5;
  const int32_t c = L.cnt[tid];
  int32_t ic = c, il = L.last[tid];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t oc = __shfl_up_sync(0xffffffffu, ic, d);
    const int32_t ol = __shfl_up_sync(0xffffffffu, il, d);
    if (lane >= d) {
      ic += oc;
      il = il > ol ? il : ol;
    }
  }
  const int32_t el = __shfl_up_sync(0xffffffffu, il, 1);
  if (lane == 31) {
    L.wcnt[wid] = ic;
    L.wlast[wid] = il;
  }
  __syncthreads();
  Tot tot{0, carry};
  int32_t pc = 0, pl = carry;
  for (int w = 0; w < nw; ++w) {
    const int32_t wc = L.wcnt[w], wl = L.wlast[w];
    if (w < wid) {
      pc += wc;
      pl = pl > wl ? pl : wl;
    }
    tot.lines += wc;
    tot.last = tot.last > wl ? tot.last : wl;
  }
  L.cnt[tid] = pc + ic - c;
  L.last[tid] = lane && el > pl ? el : pl;
  return tot;
#else
  Tot tot{0, carry};
  for (int i = 0; i < nth; ++i) {
    const int32_t c = L.cnt[i], l = L.last[i];
    L.cnt[i] = tot.lines;
    L.last[i] = tot.last;
    tot.lines += c;
    tot.last = l > tot.last ? l : tot.last;
  }
  return tot;
#endif
}

// *red = min(*red, v) over the block; every thread calls it once (red was
// set to kNone before the step, with a sync between).
HBT_RS_HD HBT_RS_INLINE void block_min(int32_t* red, int32_t v) {
#ifdef __CUDA_ARCH__
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v != kNone) atomicMin(red, v);
#else
  if (v < *red) *red = v;
#endif
}

// ---------------------------------------------------------------------------
// Tiles.  Tile t covers the bytes from 16-byte boundary + t * tile, window
// offsets t * tile - lead ..; only window offsets in [0, n) are read.

HBT_RS_HD HBT_RS_INLINE int tiles(const Chunk& c, int tile) {
  return c.n > 0 ? (c.lead + c.n + tile - 1) / tile : 0;
}

HBT_RS_HD HBT_RS_INLINE int32_t tile_start(const Chunk& c, int t, int tile) {
  return t * tile - c.lead;
}

HBT_RS_HD HBT_RS_INLINE const uint8_t* tile_buf(const Layout& L, int t) {
  return L.buf + (t & 1) * L.tile;
}

// Stage tile t into its buffer: whole vectors by cp.async, the vectors at
// the window's two ends byte by byte.
HBT_RS_HD inline void stage(const Chunk& c, int t, const Layout& L, int tid, int nth) {
  uint8_t* dst = L.buf + (t & 1) * L.tile;
  const int32_t ts = tile_start(c, t, L.tile);
  for (int v = tid; v < L.tile / 16; v += nth) {
    const int32_t q = ts + 16 * v;
    if (q >= c.n) break;
    if (q >= 0 && q + 16 <= c.n) {
      copy16_async(dst + 16 * v, c.w + q);
    } else {
      for (int b = 0; b < 16; ++b)
        if (q + b >= 0 && q + b < c.n) dst[16 * v + b] = c.w[q + b];
    }
  }
}

// Thread tid's vectors of a tile: [v0, v1).
HBT_RS_HD HBT_RS_INLINE void vectors(const Layout& L, int tid, int nth, int& v0, int& v1) {
  const int nvec = L.tile / 16, per = (nvec + nth - 1) / nth;
  v0 = tid * per < nvec ? tid * per : nvec;
  v1 = v0 + per < nvec ? v0 + per : nvec;
}

// 1. Count: thread tid's newlines and its last one.
HBT_RS_HD inline void count(const Chunk& c, int t, const Layout& L, int tid, int nth) {
  const uint8_t* tb = tile_buf(L, t);
  const int32_t ts = tile_start(c, t, L.tile);
  int v0, v1;
  vectors(L, tid, nth, v0, v1);
  int32_t k = 0, last = -1;
  for (int v = v0; v < v1; ++v) {
    const uint32_t m = newlines16(tb + 16 * v, ts + 16 * v, c.n);
    if (m) {
      k += popc(m);
      last = ts + 16 * v + high_bit(m);
    }
  }
  L.cnt[tid] = k;
  L.last[tid] = last;
}

// 2. Lines: thread tid's newlines into the ring (after the block scan).
HBT_RS_HD inline void lines(const Chunk& c, const Scan& s, int t, const Layout& L, int tid,
                            int nth) {
  const uint8_t* tb = tile_buf(L, t);
  const int32_t ts = tile_start(c, t, L.tile);
  int v0, v1;
  vectors(L, tid, nth, v0, v1);
  int32_t l = s.l0 + L.cnt[tid], nl = L.last[tid];
  for (int v = v0; v < v1; ++v) {
    uint32_t m = newlines16(tb + 16 * v, ts + 16 * v, c.n);
    while (m) {
      const int32_t p = ts + 16 * v + low_bit(m);
      m &= m - 1;
      const int32_t start = nl + 1, raw = p - start;
      int32_t fc = -1, cr = 0;
      if (raw > 0) {
        fc = start >= ts ? tb[start - ts] : s.open_fc;
        const int32_t before = p > ts ? tb[p - 1 - ts] : s.prev;
        cr = before == kCr ? 1 : 0;
      }
      L.ring[slot(s, L, l)] = entry(p, cr, fc);
      nl = p;
      ++l;
    }
  }
}

// What a decision writes: count rows from row on, the records at lines
// line, line + 4, ...
struct Emit {
  int32_t line, row, count;
};

// 3a. The sync line: the least i >= 0 with frame(i) and frame(i + 4) whose
// line i + 7 completed in this step (the tile's T lines).
HBT_RS_HD inline void sync_candidates(const Scan& s, int32_t T, const Layout& L, int32_t* red,
                                      int tid, int nth) {
  const int32_t lo = s.l0 > 7 ? s.l0 - 7 : 0, hi = s.l0 + T - 8;
  int32_t best = kNone;
  for (int32_t i = lo + tid; i <= hi; i += nth) {
    if (frame(s, L, i) && frame(s, L, i + 4)) {
      best = i;
      break;
    }
  }
  block_min(red, best);
}

// The machine at its sync line i0 (kNone: none yet): a start at or past
// chunk_len ends the chunk without a record; else records i0 and i0 + 4
// (the second only if claimed) under one cap test.
HBT_RS_HD inline Emit take_sync(const Chunk& c, Scan& s, const Layout& L, int32_t i0) {
  Emit e{0, s.nrec, 0};
  if (i0 == kNone) return e;
  if (start_of(s, L, i0) >= c.chunk_len) {
    s.done = s.stopped = 1;
    return e;
  }
  const int32_t two = start_of(s, L, i0 + 4) < c.chunk_len ? 1 : 0;
  s.synced = 1;
  s.next = i0 + 8;
  if (s.nrec + 1 + two > c.cap) {
    s.ok = 0;
    s.stopped = 1;
    return e;
  }
  e = Emit{i0, s.nrec, 1 + two};
  s.nrec += 1 + two;
  if (!two) s.done = s.stopped = 1;
  return e;
}

// The records whose frame completed by this step's end: next, next + 4, ...
HBT_RS_HD HBT_RS_INLINE int32_t records_ready(const Scan& s, int32_t T) {
  const int32_t top = s.l0 + T - 4;
  return top >= s.next ? (top - s.next) / 4 + 1 : 0;
}

// 3b. The first of them that is not claimed or not a frame.
HBT_RS_HD inline void record_candidates(const Chunk& c, const Scan& s, int32_t T,
                                        const Layout& L, int32_t* red, int tid, int nth) {
  const int32_t J = records_ready(s, T);
  int32_t best = kNone;
  for (int32_t j = tid; j < J; j += nth) {
    const int32_t r = s.next + 4 * j;
    if (start_of(s, L, r) >= c.chunk_len || !frame(s, L, r)) {
      best = j;
      break;
    }
  }
  block_min(red, best);
}

// The machine over those records: it stops at the first not claimed (done),
// not a frame (ok = 0) or past the cap (ok = 0), in that order at one
// record; the records before the stop are written.
HBT_RS_HD inline Emit take_records(const Chunk& c, Scan& s, int32_t T, const Layout& L,
                                   int32_t j1) {
  const int32_t J = records_ready(s, T), jcap = c.cap - s.nrec;
  const int32_t js = j1 < jcap ? j1 : jcap;
  const int32_t E = js < J ? js : J;
  const Emit e{s.next, s.nrec, E};
  if (js < J) {
    s.stopped = 1;
    if (j1 <= jcap && start_of(s, L, s.next + 4 * j1) >= c.chunk_len) {
      s.done = 1;
    } else {
      s.ok = 0;
    }
  }
  s.nrec += E;
  s.next += 4 * E;
  return e;
}

// The rows of e, thread-strided.
HBT_RS_HD inline void emit(const Chunk& c, const Scan& s, const Layout& L, Emit e, int tid,
                           int nth) {
  for (int32_t j = tid; j < e.count; j += nth) {
    const int32_t r = e.line + 4 * j;
    const uint32_t z = line_at(s, L, r - 1), a = line_at(s, L, r), b = line_at(s, L, r + 1),
                   d = line_at(s, L, r + 2), q = line_at(s, L, r + 3);
    int32_t* out = c.rows + 8 * static_cast<int64_t>(e.row + j);
#ifdef __CUDA_ARCH__
    reinterpret_cast<int4*>(out)[0] =
        make_int4(end_of(z), eff_of(z, a), end_of(a), eff_of(a, b));
    reinterpret_cast<int4*>(out)[1] =
        make_int4(end_of(b), eff_of(b, d), end_of(d), eff_of(d, q));
#else
    const int32_t row[8] = {end_of(z), eff_of(z, a), end_of(a), eff_of(a, b),
                            end_of(b), eff_of(b, d), end_of(d), eff_of(d, q)};
    memcpy(out, row, sizeof(row));
#endif
  }
}

// One decision step over the T lines just written (red: its two minima,
// set to kNone before the step's lines were written).
HBT_RS_HD inline void decide(const Chunk& c, Scan& s, int32_t T, const Layout& L, int32_t* red,
                             int nth) {
  if (!s.synced) {
    HBT_RS_EACH(tid, nth) sync_candidates(s, T, L, red, tid, nth);
    HBT_RS_SYNC();
    const Emit e = take_sync(c, s, L, red[0]);
    HBT_RS_EACH(tid, nth) emit(c, s, L, e, tid, nth);
  }
  if (s.synced && !s.stopped) {
    HBT_RS_EACH(tid, nth) record_candidates(c, s, T, L, red + 1, tid, nth);
    HBT_RS_SYNC();
    const Emit e = take_records(c, s, T, L, red[1]);
    HBT_RS_EACH(tid, nth) emit(c, s, L, e, tid, nth);
  }
}

// The carry into the next tile (every thread reads the same bytes).
HBT_RS_HD inline void advance(const Chunk& c, Scan& s, int t, const Layout& L, Tot tot) {
  const uint8_t* tb = tile_buf(L, t);
  const int32_t ts = tile_start(c, t, L.tile);
  const int32_t te = ts + L.tile < c.n ? ts + L.tile : c.n;
  s.l0 += tot.lines;
  s.r0 += tot.lines;
  if (s.r0 >= L.R) s.r0 -= L.R;
  s.open = tot.last + 1;
  s.open_fc = s.open < ts ? s.open_fc : s.open < te ? tb[s.open - ts] : -1;
  s.prev = tb[te - 1 - ts];
}

// The final verdicts; meta = [n, ok].
HBT_RS_HD inline void finish(const Chunk& c, const Scan& s, const Layout& L, int32_t* meta) {
  int32_t ok = s.ok;
  if (!s.stopped) {
    const int32_t cur = c.n - s.open;  // unterminated text
    const bool bad_tail = s.synced && s.l0 > s.next && start_of(s, L, s.next) < c.chunk_len;
    const bool bad_text = cur > 0 && s.open < c.chunk_len;
    const bool bad_sync = !s.synced && (s.l0 > 0 || cur > 0);
    if (bad_tail || bad_text || bad_sync) ok = 0;
  }
  meta[0] = s.nrec;
  meta[1] = ok;
}

// Cycle stamps of the phases (device, thread 0, when timed).
struct Clock {
  unsigned long long t, acc[kPhases];
  HBT_RS_HD HBT_RS_INLINE void start() {
#ifdef __CUDA_ARCH__
    t = clock64();
#endif
    for (int k = 0; k < kPhases; ++k) acc[k] = 0;
  }
  HBT_RS_HD HBT_RS_INLINE void lap(int k) {
#ifdef __CUDA_ARCH__
    const unsigned long long now = clock64();
    acc[k] += now - t;
    t = now;
#else
    (void)k;
#endif
  }
};

// One chunk, by the block (meta: its [n, ok]; cyc: the phases' cycles
// summed over blocks, when kTimed).
template <bool kTimed>
HBT_RS_HD inline void scan_chunk(const Chunk& c, const Layout& L, int nth, int32_t* meta,
                                 unsigned long long* cyc) {
  Scan s = begin(c);
  Clock clk;
  if (kTimed) clk.start();
  const int nt = tiles(c, L.tile);
  HBT_RS_EACH(tid, nth) {
    if (tid == 0) {
      for (int k = 0; k < 4; ++k) L.red[k] = kNone;
      L.ring[slot(s, L, -1)] = 0;
    }
    if (nt > 0) stage(c, 0, L, tid, nth);
  }
  for (int t = 0; t < nt; ++t) {
    wait_copies();
    HBT_RS_SYNC();
    if (kTimed) clk.lap(0);
    HBT_RS_EACH(tid, nth) {
      if (tid == 0) L.red[0] = L.red[1] = kNone;
      if (t + 1 < nt) stage(c, t + 1, L, tid, nth);
      count(c, t, L, tid, nth);
    }
    const Tot tot = block_scan(L, s.open - 1, nth);
    if (kTimed) clk.lap(1);
    HBT_RS_EACH(tid, nth) lines(c, s, t, L, tid, nth);
    HBT_RS_SYNC();
    if (kTimed) clk.lap(2);
    decide(c, s, tot.lines, L, L.red, nth);
    advance(c, s, t, L, tot);
    if (kTimed) clk.lap(3);
    if (s.stopped) break;
  }
  wait_copies();
  if (!s.stopped && c.final_ && c.n > s.open) {
    // The synthetic newline after a final window's unterminated text.
    HBT_RS_EACH(tid, nth) {
      if (tid == 0) {
        L.ring[slot(s, L, s.l0)] = entry(c.n, s.prev == kCr ? 1 : 0, s.open_fc);
      }
    }
    HBT_RS_SYNC();
    decide(c, s, 1, L, L.red + 2, nth);
    s.l0 += 1;
    s.r0 = s.r0 + 1 < L.R ? s.r0 + 1 : 0;
    s.open = c.n;
  }
  HBT_RS_EACH(tid, nth) {
    if (tid == 0) finish(c, s, L, meta);
  }
  if (kTimed) {
    clk.lap(4);
#ifdef __CUDA_ARCH__
    if (threadIdx.x == 0)
      for (int k = 0; k < kPhases; ++k) atomicAdd(cyc + k, clk.acc[k]);
#else
    (void)cyc;
#endif
  }
}

}  // namespace hbt_scan
