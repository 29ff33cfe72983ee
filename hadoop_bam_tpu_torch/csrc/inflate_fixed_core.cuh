// The walk core of csrc/inflate_fixed.cu: the literal-only fixed-Huffman
// inflate of one member, decided a round at a time by the block's threads in
// parallel and exactly.  The device runs inflate_member with a block's
// threads; a host build with g++ runs the same function with the threads as
// loops (HBT_IF_EACH), which the CPU tests hold to the plain version.
//
// What it computes is ops/kernels/inflate_fixed.py (inflate_fixed_literal
// and its plain version): ok iff the first three bits are 011, the symbols
// from bit 3 are literals (8-bit codes 0-143, 9-bit codes 144-255) up to
// one EOB, the EOB ends at or before clens * 8, and the literal count is the
// member's ISIZE; the row holds the literals when ok and is zero otherwise.
// Bits past the row's C bytes read as zero.
//
// The walk is serial in form only.  The symbol at bit p depends on the 9
// bits at p alone, and every symbol is 7, 8 or 9 bits, so a segment of S
// bits is entered at one of 9 offsets: the symbol before it started before
// it.  Any symbol that ends past the member's bits rejects the member (an
// EOB there fails the end test, and any other end rejects anyway), so a
// walk stops there too.  The stream is read in rounds of nth * S bits, one
// segment a thread, double-buffered in shared memory by 4-byte cp.async
// (bytes at or past C are zeros).  A round is stored transposed, word j of
// segment k at j * nth + k, so that the threads of a warp, each in its own
// segment, read 32 banks.  Each round goes through block-synchronous steps:
//
//   1. Map.  Each thread walks its segment from each of the 9 entries and
//      records the exit offset past the segment's end (0-8) or how the path
//      stopped inside it (kGood: an EOB that ends in the member; kBad: a
//      length code or a symbol past the member's bits), and the literals on
//      the way.  Entry 0 is walked in full and marks the positions it
//      visits; every other entry is walked until it lands on a mark, and
//      from there its end and its literals are entry 0's.
//   2. Compose.  A block scan of the maps as functions on 9 entries (a stop
//      absorbs) gives each segment its true entry from the round's carried
//      one, and a block scan of the literals at the true entries gives each
//      segment the literals of the round before it.  The round's result is
//      the composition of all: the next round's entry, or the stop.
//   3. Emit.  Each thread walks its segment again from its true entry and
//      writes each literal at its output index, below min(total, ISIZE),
//      into a shared stage; the block stores the stage's whole 16-byte
//      chunks to the row and carries the partial one.
//   4. Stop at the round's stop, or once the literals pass ISIZE; then the
//      rest of the row is zeroed (all of it on a reject) and ok written.
//
// Every map entry is the serial walk's from that offset, each composition
// is exact, and the emit repeats the walk from the true entry, so the
// result is the plain version's.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define HBT_IF_HD __host__ __device__
#define HBT_IF_INLINE __forceinline__
#else
#define HBT_IF_HD
#define HBT_IF_INLINE inline
#endif

// A block-synchronous step: on the device each thread runs the body once as
// thread `tid`; on the host the body runs for every thread in turn.
#ifdef __CUDA_ARCH__
#define HBT_IF_SYNC() __syncthreads()
#define HBT_IF_EACH(tid, nth) for (int tid = threadIdx.x, tid##_once = 1; tid##_once; tid##_once = 0)
#else
#define HBT_IF_SYNC() ((void)0)
#define HBT_IF_EACH(tid, nth) for (int tid = 0; tid < (nth); ++tid)
#endif

namespace hbt_fixed {

constexpr int kEntries = 9;     // a segment's entry offsets 0-8
constexpr uint32_t kGood = 9;   // the path ends at an EOB inside the member
constexpr uint32_t kBad = 10;   // a length code, or a symbol that ends past the member's bits
constexpr int kPhases = 5;      // wait, map, compose, emit, finish (cycle stamps)
constexpr int kMinSeg = 32, kMaxSeg = 1024;  // bits a segment (a power of two)
// The identity on the 9 entries: nibble e of lo (e < 8) or hi (e = 8) is e.
constexpr uint32_t kIdLo = 0x76543210u, kIdHi = 8u;

// A round of nth segments of seg bits (words = 2^wshift 4-byte words
// each).  An input buffer holds the round's words transposed and, at
// words * nth, the next round's first word (the 9-bit reach of the last
// segment); the output stage holds ostage bytes.
struct Geometry {
  int32_t seg, nth, words, wshift, round_bits, ibuf, ostage;
};

HBT_IF_HD HBT_IF_INLINE Geometry geometry(int seg, int nth) {
  Geometry g;
  g.seg = seg;
  g.nth = nth;
  g.words = seg / 32;
  g.wshift = 0;
  while ((2 << g.wshift) <= g.words) ++g.wshift;
  g.round_bits = seg * nth;
  g.ibuf = (4 * (g.words * nth + 1) + 15) & ~15;
  // A round's literals (at most round_bits / 8 + 1) after up to 15 carried,
  // and the stage's skew (4 bytes a 32).
  const int32_t n = g.round_bits / 8 + 32;
  g.ostage = (n + (n >> 3) + 4 + 15) & ~15;
  return g;
}

HBT_IF_HD inline int64_t smem_bytes(int seg, int nth) {
  const Geometry g = geometry(seg, nth);
  const int64_t warps = (nth + 31) / 32;
  return 2 * static_cast<int64_t>(g.ibuf) + g.ostage +
         (5 * static_cast<int64_t>(g.words) + 4 * (kEntries - 1)) * nth + 12 * warps;
}

// Shared memory: the input buffers of even and odd rounds, the output stage,
// entry 0's marks of each thread (word w of thread t at w * nth + t: a bit a
// position, and the marks before the word), the ends of entries 1-8 (entry
// e of thread t at (e - 1) * nth + t) and the warps' scan totals.
struct Layout {
  uint32_t* in;    // round r's buffer at in + (r & 1) * ibuf / 4
  uint8_t* stage;  // output byte base + i at skew(i)
  uint32_t* mask;
  uint32_t* ent;   // code | own literals << 4 | (the point it met entry 0's path + 1) << 12
  uint32_t* wlo;  // per warp: its segments' composed map (entries 0-7, entry 8)
  uint32_t* whi;
  int32_t* wsum;  // per warp: its segments' literals
  uint8_t* pre;
};

HBT_IF_HD inline Layout carve(uint8_t* smem, const Geometry& g) {
  Layout L;
  const int warps = (g.nth + 31) / 32;
  L.in = reinterpret_cast<uint32_t*>(smem);
  L.stage = smem + 2 * g.ibuf;
  L.mask = reinterpret_cast<uint32_t*>(smem + 2 * g.ibuf + g.ostage);
  L.ent = L.mask + g.words * g.nth;
  L.wlo = L.ent + (kEntries - 1) * g.nth;
  L.whi = L.wlo + warps;
  L.wsum = reinterpret_cast<int32_t*>(L.whi + warps);
  L.pre = reinterpret_cast<uint8_t*>(L.wsum + warps);
  return L;
}

HBT_IF_HD HBT_IF_INLINE uint32_t* round_buf(const Layout& L, const Geometry& g, int r) {
  return L.in + (r & 1) * (g.ibuf >> 2);
}

struct Member {
  const uint8_t* row;  // the stream, 16-byte aligned
  int32_t C;           // its bytes (a multiple of 16); bytes past it read as zero
  int32_t nb;          // the bits a symbol must end within: min(clens * 8, 8 * C + 16)
  int32_t isize;
  uint8_t* out;        // the output row, 16-byte aligned
  int64_t out_stride;  // its bytes, a multiple of 16, at least isize
};

// min(clens * 8, 8 * C + 16): past 8 * C every symbol is the 7-bit EOB of
// zero bits, so the walk ends by then either way.
HBT_IF_HD HBT_IF_INLINE int32_t member_bits(int32_t clen, int64_t C) {
  const int64_t nb = static_cast<int64_t>(clen) * 8, cap = 8 * C + 16;
  return static_cast<int32_t>(nb < cap ? nb : cap);
}

// A thread's segment: its map (code of entry e in nibble e of clo, or chi
// for e = 8), entry 0's marks, literals and stop (0 if it exits; the other
// entries' ends are in Layout::ent), then its true entry (or the stop before
// it) and the round's literals before it.
struct Seg {
  uint32_t clo, chi, stop0;
  int32_t marks, lits0;
  uint32_t x;
  int32_t before;
};

// The round's carried state, the same in every thread.
struct State {
  int32_t count;  // literals before the round
  uint32_t x0;    // the entry of the round's first segment
  int32_t base;   // the output index of stage[0] (a multiple of 16)
};

// ---------------------------------------------------------------------------
// Primitives, plain on the host.

HBT_IF_HD HBT_IF_INLINE int32_t popc(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// Thread k's segment in a staged round: word j at col[j * nth], and the
// word after its last at `next` (the next segment's first, or the halo).
struct Column {
  const uint32_t* col;
  int32_t nth, words, next;
};

HBT_IF_HD HBT_IF_INLINE Column column(const uint32_t* buf, const Geometry& g, int k) {
  return Column{buf + k, g.nth, g.words, k + 1 < g.nth ? 1 : g.words * g.nth - k};
}

// The segment's word after word j.
HBT_IF_HD HBT_IF_INLINE uint32_t word_after(const Column& c, int32_t j) {
  return c.col[j + 1 < c.words ? (j + 1) * c.nth : c.next];
}

// A walk's view of its segment: words j and j + 1 in registers.  A step
// moves at most 9 bits, so the walk slides it at most one word at a time.
struct Window {
  int32_t j;
  uint32_t lo, hi;
};

HBT_IF_HD HBT_IF_INLINE Window window0(const Column& c) {
  return Window{0, c.col[0], word_after(c, 0)};
}

HBT_IF_HD HBT_IF_INLINE void slide(const Column& c, Window& w, int32_t j) {
  w.j = j;
  w.lo = w.hi;
  w.hi = word_after(c, j);
}

// The 32 stream bits from bit p of the segment (first bit in bit 0), p in
// word w.j.
HBT_IF_HD HBT_IF_INLINE uint32_t bits(const Window& w, int32_t p) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(w.lo, w.hi, p & 31);
#else
  const uint64_t two = static_cast<uint64_t>(w.hi) << 32 | w.lo;
  return static_cast<uint32_t>(two >> (p & 31));
#endif
}

// The symbol at those bits, by the fixed code's canonical ranges (code
// value r of its 9 bits, most significant first): below 0x60 a 7-bit symbol
// 256-279 (the EOB below 4), 0x60-0x17F an 8-bit literal 0-143,
// 0x180-0x18F an 8-bit length symbol 280-287, from 0x190 a 9-bit literal
// 144-255.  The first 5 stream bits decide which: bit u of kStopMask is set
// for the first bits u of a 7-bit symbol or a length symbol, of kNineMask
// for those of a 9-bit literal.
constexpr uint32_t kStopMask = 0x01110119u, kNineMask = 0x88888880u;

HBT_IF_HD HBT_IF_INLINE bool is_stop(uint32_t w) { return (kStopMask >> (w & 31u)) & 1u; }
HBT_IF_HD HBT_IF_INLINE int32_t literal_bits(uint32_t w) {
  return 8 + static_cast<int32_t>((kNineMask >> (w & 31u)) & 1u);
}

// The literal at those bits.
HBT_IF_HD HBT_IF_INLINE uint32_t literal_of(uint32_t w) {
#ifdef __CUDA_ARCH__
  const uint32_t r = __brev(w) >> 23;
#else
  uint32_t r = 0;
  for (int k = 0; k < 9; ++k) r |= ((w >> k) & 1u) << (8 - k);
#endif
  return r < 0x190u ? (r >> 1) - 0x30u : r - 0x100u;
}

// How a path ends at the symbol at bits w from bit p: an EOB (7 zero bits)
// that ends within nb, or else a reject.
HBT_IF_HD HBT_IF_INLINE uint32_t stop_of(uint32_t w, int32_t p, int32_t nb) {
  return (w & 127u) == 0 && p + 7 <= nb ? kGood : kBad;
}

// Entry x of a map (lo, hi); a stop maps to itself.
HBT_IF_HD HBT_IF_INLINE uint32_t apply(uint32_t lo, uint32_t hi, uint32_t x) {
  return x < 8u ? (lo >> (4 * x)) & 15u : x == 8u ? hi : x;
}

// The map f, then g.
HBT_IF_HD HBT_IF_INLINE void compose(uint32_t flo, uint32_t fhi, uint32_t glo, uint32_t ghi,
                                     uint32_t& hlo, uint32_t& hhi) {
  uint32_t lo = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) lo |= apply(glo, ghi, (flo >> (4 * e)) & 15u) << (4 * e);
  hlo = lo;
  hhi = apply(glo, ghi, fhi);
}

// Thread k's literals on the way from entry x of its segment: an entry that
// met entry 0's path at q adds entry 0's literals from q on (its marks at
// and after q, less its stop).
HBT_IF_HD inline int32_t literals_at(const Layout& L, int nth, int k, const Seg& sg,
                                     uint32_t x) {
  if (x == 0) return sg.lits0;
  const uint32_t r = L.ent[(x - 1) * nth + k];
  int32_t lits = static_cast<int32_t>((r >> 4) & 255u);
  if (r >> 12) {
    const int32_t q = static_cast<int32_t>(r >> 12) - 1, a = (q >> 5) * nth + k;
    const int32_t rank = L.pre[a] + popc(L.mask[a] & ((1u << (q & 31)) - 1u));
    lits += sg.marks - rank - (sg.stop0 ? 1 : 0);
  }
  return lits;
}

// 4 bytes from device memory to shared memory without a register round
// trip (cp.async; every copy of the thread lands at wait_copies()); a plain
// copy on the host.
HBT_IF_HD HBT_IF_INLINE void copy4_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 4);
#endif
}

HBT_IF_HD HBT_IF_INLINE void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

HBT_IF_HD HBT_IF_INLINE void store16(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

// The stage's place of output byte base + i: 4 bytes of skew every 32, so
// that the threads of a warp, each writing about a segment's literals past
// its neighbour's, write to other banks.  A 16-byte chunk at i = 16c stays
// whole, at 16c + 4 * (c / 2).
HBT_IF_HD HBT_IF_INLINE int32_t skew(int32_t i) { return i + ((i >> 5) << 2); }

// Chunk c of the stage to dst (16-byte aligned).
HBT_IF_HD HBT_IF_INLINE void chunk16(uint8_t* dst, const uint8_t* stage, int32_t c) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(stage + skew(16 * c));
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
#else
  memcpy(dst, w, 16);
#endif
}

HBT_IF_HD HBT_IF_INLINE void zero16(uint8_t* dst) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
#else
  memset(dst, 0, 16);
#endif
}

// ---------------------------------------------------------------------------
// Rounds.  Round r covers bits [r * R, (r + 1) * R), words r * R / 32 on.

// The rounds a member can need: its walk stops at or before bit nb.
HBT_IF_HD HBT_IF_INLINE int rounds(const Member& m, const Geometry& g) {
  return m.nb > 0 ? m.nb / g.round_bits + 1 : 1;
}

// Stage round r into its buffer, transposed, and the next round's first
// word after it: a word a cp.async, consecutive threads on consecutive
// words; zeros at and past C (a multiple of 16).
HBT_IF_HD inline void stage_round(const Member& m, const Geometry& g, const Layout& L, int r,
                                  int tid, int nth) {
  uint32_t* dst = round_buf(L, g, r);
  const int64_t q0 = static_cast<int64_t>(r) * (g.round_bits >> 3);
  const int n = g.words * nth;
  for (int i = tid; i <= n; i += nth) {
    const int64_t q = q0 + 4 * i;
    uint32_t* d = i < n ? dst + (i & (g.words - 1)) * nth + (i >> g.wshift) : dst + n;
    if (q < m.C) {
      copy4_async(d, m.row + q);
    } else {
      *d = 0;
    }
  }
}

// 1. Map: thread k's segment of round r from each of its 9 entries (bit
// positions relative to the segment's start).  Entries 1-8 share one loop,
// so that a thread goes on to its next entry as soon as one ends, whatever
// the other threads of its warp are at: in a loop of its own, each entry
// would hold the warp for its longest lane.
HBT_IF_HD inline void map_segment(const Member& m, const Geometry& g, const Layout& L, int r,
                                  int k, Seg& sg) {
  const Column c = column(round_buf(L, g, r), g, k);
  const int32_t S = g.seg, nb = m.nb - (r * g.round_bits + k * S);
  uint32_t* mask = L.mask + k;
  uint8_t* pre = L.pre + k;
  uint32_t* ent = L.ent + k;
  const int nth = g.nth;
  const Window start = window0(c);
  // Entry 0 in full: its marks a word at a time, with the marks before it.
  Window v = start;
  uint32_t word = 0, stop0 = 0;
  int32_t marks = 0, before_word = 0, p = 0;
  for (;;) {  // p < S
    if ((p >> 5) != v.j) {  // the next word
      mask[v.j * nth] = word;
      pre[v.j * nth] = static_cast<uint8_t>(before_word);
      before_word = marks;
      word = 0;
      slide(c, v, p >> 5);
    }
    word |= 1u << (p & 31);
    ++marks;
    const uint32_t w = bits(v, p);
    const int32_t np = p + literal_bits(w);
    if (is_stop(w) || np > nb) {
      stop0 = stop_of(w, p, nb);
      break;
    }
    p = np;
    if (p >= S) break;
  }
  mask[v.j * nth] = word;
  pre[v.j * nth] = static_cast<uint8_t>(before_word);
  for (int32_t z = v.j + 1; z < g.words; ++z) mask[z * nth] = 0;  // no marks past its end
  const uint32_t code0 = stop0 ? stop0 : static_cast<uint32_t>(p - S);
  sg.stop0 = stop0;
  sg.marks = marks;
  sg.lits0 = marks - (stop0 ? 1 : 0);
  // Entries 1-8, each until it ends or lands on entry 0's path (q < S).
  const uint32_t m0 = mask[0];
  uint32_t mw = m0;
  uint32_t* slot = ent;
  int32_t e = 1, q = 1, lits = 0;
  v = start;
  for (;;) {
    if ((q >> 5) != v.j) {
      slide(c, v, q >> 5);
      mw = mask[v.j * nth];
    }
    const uint32_t w = bits(v, q);
    const int32_t nq = q + literal_bits(w);
    uint32_t end;
    if ((mw >> (q & 31)) & 1u) {  // on entry 0's path: its end from here
      end = code0 | static_cast<uint32_t>(q + 1) << 12;
    } else if (is_stop(w) || nq > nb) {
      end = stop_of(w, q, nb);
    } else if (nq >= S) {
      end = static_cast<uint32_t>(nq - S);
      ++lits;
    } else {
      q = nq;
      ++lits;
      continue;
    }
    *slot = end | static_cast<uint32_t>(lits) << 4;
    slot += nth;
    if (++e == kEntries) break;
    q = e;
    lits = 0;
    v = start;
    mw = m0;
  }
  uint32_t clo = code0;
  for (int x = 1; x < 8; ++x) clo |= (ent[(x - 1) * nth] & 15u) << (4 * x);
  sg.clo = clo;
  sg.chi = ent[7 * nth] & 15u;
}

// 2a. Each segment's true entry (sg.x) from the round's entry x0; returns
// the round's end: the next round's entry, or kGood / kBad.  On the device
// every thread calls it once, after its map.
#ifdef __CUDA_ARCH__
__device__ inline uint32_t entries(const Layout& L, int nth, uint32_t x0, Seg& sg) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5, nw = nth >> 5;
  uint32_t lo = sg.clo, hi = sg.chi;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t plo = __shfl_up_sync(0xffffffffu, lo, d);
    const uint32_t phi = __shfl_up_sync(0xffffffffu, hi, d);
    if (lane >= d) compose(plo, phi, lo, hi, lo, hi);
  }
  uint32_t elo = __shfl_up_sync(0xffffffffu, lo, 1), ehi = __shfl_up_sync(0xffffffffu, hi, 1);
  if (lane == 0) {
    elo = kIdLo;
    ehi = kIdHi;
  }
  if (lane == 31) {
    L.wlo[wid] = lo;
    L.whi[wid] = hi;
  }
  __syncthreads();
  uint32_t x = x0, xin = x0;
  for (int w = 0; w < nw; ++w) {
    if (w == wid) xin = x;
    x = apply(L.wlo[w], L.whi[w], x);
  }
  sg.x = apply(elo, ehi, xin);
  return x;
}
#else
// The same scan with the warps' lanes as loops: Kogge-Stone within each
// warp of up to 32 segments, the warps' compositions in order.
inline uint32_t entries(const Layout& L, int nth, uint32_t x0, Seg* segs) {
  uint32_t x = x0;
  for (int w0 = 0; w0 < nth; w0 += 32) {
    const int nl = nth - w0 < 32 ? nth - w0 : 32;
    uint32_t lo[32], hi[32], plo[32], phi[32];
    for (int l = 0; l < nl; ++l) {
      lo[l] = segs[w0 + l].clo;
      hi[l] = segs[w0 + l].chi;
    }
    for (int d = 1; d < 32; d <<= 1) {
      memcpy(plo, lo, sizeof(lo));
      memcpy(phi, hi, sizeof(hi));
      for (int l = d; l < nl; ++l) compose(plo[l - d], phi[l - d], lo[l], hi[l], lo[l], hi[l]);
    }
    for (int l = 0; l < nl; ++l) {
      segs[w0 + l].x = l ? apply(lo[l - 1], hi[l - 1], x) : x;
    }
    L.wlo[w0 / 32] = lo[nl - 1];
    L.whi[w0 / 32] = hi[nl - 1];
    x = apply(lo[nl - 1], hi[nl - 1], x);
  }
  return x;
}
#endif

// 2b. The round's literals before each segment (sg.before) at its true
// entry; returns the round's literals.
#ifdef __CUDA_ARCH__
__device__ inline int32_t literals_before(const Layout& L, int nth, Seg& sg) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5, nw = nth >> 5;
  const int32_t c = sg.x < static_cast<uint32_t>(kEntries) ? literals_at(L, nth, tid, sg, sg.x) : 0;
  int32_t inc = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) L.wsum[wid] = inc;
  __syncthreads();
  int32_t before = inc - c, total = 0;
  for (int w = 0; w < nw; ++w) {
    const int32_t v = L.wsum[w];
    if (w < wid) before += v;
    total += v;
  }
  sg.before = before;
  return total;
}
#else
inline int32_t literals_before(const Layout& L, int nth, Seg* segs) {
  int32_t total = 0;
  for (int k = 0; k < nth; ++k) {
    segs[k].before = total;
    total += segs[k].x < static_cast<uint32_t>(kEntries) ? literals_at(L, nth, k, segs[k], segs[k].x)
                                                         : 0;
  }
  return total;
}
#endif

// 3a. Emit: thread k's literals from its true entry, output index j at
// stage[skew(j - base)], for j below lim.
HBT_IF_HD inline void emit_segment(const Member& m, const Geometry& g, const Layout& L,
                                   const State& st, int r, int k, const Seg& sg, int32_t lim) {
  if (sg.x >= static_cast<uint32_t>(kEntries)) return;
  const Column c = column(round_buf(L, g, r), g, k);
  const int32_t S = g.seg, nb = m.nb - (r * g.round_bits + k * S);
  int32_t j = st.count + sg.before;
  Window v = window0(c);
  for (int32_t p = static_cast<int32_t>(sg.x);;) {  // p < S
    if ((p >> 5) != v.j) slide(c, v, p >> 5);
    const uint32_t w = bits(v, p);
    const int32_t np = p + literal_bits(w);
    if (is_stop(w) || np > nb) break;
    if (j < lim) L.stage[skew(j - st.base)] = static_cast<uint8_t>(literal_of(w));
    ++j;
    if (np >= S) break;
    p = np;
  }
}

// 3b. The stage's whole 16-byte chunks below lim to the row, thread-strided;
// thread 0 then carries the partial chunk to the stage's start.
HBT_IF_HD inline void flush(const Member& m, const Layout& L, const State& st, int32_t lim,
                            int tid, int nth) {
  const int32_t chunks = lim > st.base ? ((lim & ~15) - st.base) >> 4 : 0;
  for (int32_t c = tid; c < chunks; c += nth) chunk16(m.out + st.base + 16 * c, L.stage, c);
  if (tid == 0 && chunks > 0) chunk16(L.stage, L.stage, chunks);
}

// 4. The rest of the row: after the last chunk and the partial one when ok,
// all of it otherwise.
HBT_IF_HD inline void finish(const Member& m, const Layout& L, bool ok, int tid, int nth) {
  int64_t z = 0;
  if (ok) {
    const int32_t tail = m.isize & 15;
    z = (static_cast<int64_t>(m.isize) + 15) & ~int64_t(15);
    if (tid == 0 && tail) {
      alignas(16) uint8_t chunk[16];
      memcpy(chunk, L.stage, 16);
      memset(chunk + tail, 0, 16 - tail);
      store16(m.out + (m.isize & ~15), chunk);
    }
  }
  for (int64_t c = z + 16 * tid; c < m.out_stride; c += 16 * static_cast<int64_t>(nth))
    zero16(m.out + c);
}

// Cycle stamps of the phases (device, thread 0, when timed).
struct Clock {
  unsigned long long t, acc[kPhases];
  HBT_IF_HD HBT_IF_INLINE void start() {
#ifdef __CUDA_ARCH__
    t = clock64();
#endif
    for (int k = 0; k < kPhases; ++k) acc[k] = 0;
  }
  HBT_IF_HD HBT_IF_INLINE void lap(int k) {
#ifdef __CUDA_ARCH__
    const unsigned long long now = clock64();
    acc[k] += now - t;
    t = now;
#else
    (void)k;
#endif
  }
};

// One member, by the block; returns ok (the same in every thread).  segs:
// on the host, one Seg a thread (the device keeps each in registers); cyc:
// the phases' cycles summed over blocks, when kTimed.
template <bool kTimed>
HBT_IF_HD inline bool inflate_member(const Member& m, const Geometry& g, const Layout& L,
                                     Seg* segs, unsigned long long* cyc) {
  const int nth = g.nth;
#ifdef __CUDA_ARCH__
  Seg mine;
#define HBT_IF_SEG(tid) Seg& sg = mine
#else
#define HBT_IF_SEG(tid) Seg& sg = segs[tid]
#endif
  Clock clk;
  if (kTimed) clk.start();
  bool ok = false;
  State st{0, 3, 0};  // the walk starts at bit 3 of segment 0
  const int nr = rounds(m, g);
  if (m.C > 0 && (m.row[0] & 7) == 3) {  // bfinal 1, btype 01
    HBT_IF_EACH(tid, nth) stage_round(m, g, L, 0, tid, nth);
    for (int r = 0; r < nr; ++r) {
      wait_copies();
      HBT_IF_SYNC();
      HBT_IF_EACH(tid, nth) {
        if (r + 1 < nr) stage_round(m, g, L, r + 1, tid, nth);
      }
      if (kTimed) clk.lap(0);
      HBT_IF_EACH(tid, nth) {
        HBT_IF_SEG(tid);
        map_segment(m, g, L, r, tid, sg);
      }
      if (kTimed) clk.lap(1);
#ifdef __CUDA_ARCH__
      const uint32_t xe = entries(L, nth, st.x0, mine);
      const int32_t total = literals_before(L, nth, mine);
#else
      const uint32_t xe = entries(L, nth, st.x0, segs);
      const int32_t total = literals_before(L, nth, segs);
#endif
      if (kTimed) clk.lap(2);
      const int32_t count = st.count + total;
      if (xe == kBad || (xe == kGood && count != m.isize)) break;
      const int32_t lim = count < m.isize ? count : m.isize;
      HBT_IF_EACH(tid, nth) {
        HBT_IF_SEG(tid);
        emit_segment(m, g, L, st, r, tid, sg, lim);
      }
      HBT_IF_SYNC();
      HBT_IF_EACH(tid, nth) flush(m, L, st, lim, tid, nth);
      if (kTimed) clk.lap(3);
      if (count > m.isize) break;
      if (xe == kGood) {
        ok = true;
        break;
      }
      st.count = count;
      st.x0 = xe;
      st.base = lim & ~15;
    }
  }
#undef HBT_IF_SEG
  wait_copies();
  HBT_IF_SYNC();
  HBT_IF_EACH(tid, nth) finish(m, L, ok, tid, nth);
  if (kTimed) {
    clk.lap(4);
#ifdef __CUDA_ARCH__
    if (threadIdx.x == 0)
      for (int k = 0; k < kPhases; ++k) atomicAdd(cyc + k, clk.acc[k]);
#else
    (void)cyc;
#endif
  }
  return ok;
}

}  // namespace hbt_fixed
