// The walk of csrc/deflate.cu: the greedy LZ77 and fixed-Huffman bits of one
// member, decided by the 32 lanes of one warp (the device), or by a host
// build with g++ that runs the 32 lanes in lockstep, which the CPU tests
// hold to the plain version.
//
// The function is the reference's (hadoop_bam_tpu/ops/pallas/
// deflate_lanes.py), sequential per member.  A scan step at cur (not in a
// match), when cur + 4 <= plen: the little-endian word w at cur, its hash
// h = (w * 0x9E3779B1) >> (32 - hb), candidates c1 = h1[h] - 1 and
// c2 = h2[h] - 1, then h2[h] = h1[h] and h1[h] = cur + 1; a candidate
// matches when it is >= 0, at most 32 KiB back and its word equals w (c1
// first).  A match runs to min(LCP, 258, plen - cur); no position inside it
// enters the heads.  Otherwise (also when cur + 4 > plen) the byte at cur is
// a literal.  Bits: 1,1,0, RFC 1951 fixed codes, the 7-bit end of block.
//
// A window decides 32 positions at once, exactly:
//
//   - Lane L takes p = cur + L.  Lanes with p + 4 > plen neither hash nor
//     insert; they (and only they, at a member's end) are literals without
//     a scan step.
//   - Candidates.  Each lane ORs its bit into a shared-memory slot of its
//     hash and reads the slot back: the lanes of its group.  With two or
//     more earlier ones, c1 and c2 are the nearest two; with one, that lane
//     and the old h1 - 1; with none, the old h1 - 1 and h2 - 1.  That is the table as the sequential walk would see it if every
//     earlier lane was a scan step that found no match, which holds for
//     every lane up to the first one that matches.
//   - F, the first lane with a match (one ballot): lanes before F are
//     literals, F inserts itself and starts a copy, the lanes after F are
//     dropped (neither inserted nor emitted).  With no match every live lane
//     commits.
//   - Heads.  In each hash group of the committed lanes the last one writes
//     h1 (its p + 1) and h2 (the second-to-last lane's p + 1, or the old h1
//     when the group has one lane).  Groups own disjoint slots.
//   - Extension.  The copy's length is min(LCP, 258, plen - p_F), which the
//     reference's 4-byte steps compute; the warp compares 32 words a step
//     (at most three steps) and one ballot finds the first difference.  An
//     overlapping source reads the input, as in the reference.
//   - Bits.  A literal's code is 8 bits, or 9 from byte 144 on, so a
//     lane's offset in the window is 8 L plus a popcount of a ballot; the
//     copy (length, distance and their extra bits, at most 31 bits) follows
//     the literals.  Two shuffles gather each four literals' codes (at most
//     36 bits) on lane 4k, which ORs them into at most three words of a
//     ring in shared memory (two 128-byte stretches).  A window's bits go
//     into the ring during the next window, beside its loads; a stretch
//     that lies wholly behind them goes to the member's row, four bytes a
//     lane, and is cleared for reuse.
//
// The tables of the fixed codes are computed by formula (len_index,
// dist_index and the bases); the static_assert below holds the formulas
// to RFC 1951's tables, which tests/test_torch_deflate.py holds to the
// reference's.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define HBT_DEFLATE_HD __host__ __device__
#define HBT_DEFLATE_INLINE __forceinline__
#else
#define HBT_DEFLATE_HD
#define HBT_DEFLATE_INLINE inline
#endif

#ifdef __CUDA_ARCH__
#define HBT_DEFLATE_SYNC() __syncwarp()
#else
#define HBT_DEFLATE_SYNC() ((void)0)
#endif

namespace hbt_deflate {

constexpr int kLanes = 32;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMinMatch = 4;
constexpr int kMaxMatch = 258;
constexpr int kMaxDist = 1 << 15;
constexpr uint32_t kHashMul = 0x9E3779B1u;
constexpr int kRingWords = 64;             // two stretches of 128 bytes
constexpr int kStretchBits = 1024;
// Bytes past a member's end that a word read may touch; their values decide
// nothing (every comparison is capped at plen).
constexpr int kReadPast = 8;

// RFC 1951, 3.2.5.
constexpr uint16_t kLenBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
    31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t kLenExtra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
    2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t kDistBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
    193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
    12289, 16385, 24577};
constexpr uint8_t kDistExtra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// floor(log2 x) for 0 < x < 2^16, four selects.
HBT_DEFLATE_HD constexpr int log2_16(uint32_t x) {
  int n = x >= (1u << 8) ? 8 : 0;
  n += (x >> n) >= (1u << 4) ? 4 : 0;
  n += (x >> n) >= (1u << 2) ? 2 : 0;
  n += (x >> n) >= (1u << 1) ? 1 : 0;
  return n;
}

// Length code index (symbol - 257) of a length 3..258.
HBT_DEFLATE_HD constexpr int len_index(int len) {
  return len == kMaxMatch ? 28
         : len - 3 < 8    ? len - 3
                          : 4 * (log2_16(len - 3) - 1) + (((len - 3) >> (log2_16(len - 3) - 2)) & 3);
}
HBT_DEFLATE_HD constexpr int len_base(int li) {
  return li == 28 ? kMaxMatch : li < 8 ? li + 3 : ((4 + (li & 3)) << (li / 4 - 1)) + 3;
}
HBT_DEFLATE_HD constexpr int len_extra(int li) { return li < 8 || li == 28 ? 0 : li / 4 - 1; }

// Distance code of a distance 1..32768.
HBT_DEFLATE_HD constexpr int dist_index(int dist) {
  return dist - 1 < 4 ? dist - 1
                      : 2 * log2_16(dist - 1) + (((dist - 1) >> (log2_16(dist - 1) - 1)) & 1);
}
HBT_DEFLATE_HD constexpr int dist_base(int di) {
  return di < 4 ? di + 1 : ((2 + (di & 1)) << (di / 2 - 1)) + 1;
}
HBT_DEFLATE_HD constexpr int dist_extra(int di) { return di < 4 ? 0 : di / 2 - 1; }

constexpr bool formulas_match_the_tables() {
  for (int i = 0; i < 29; ++i)
    if (len_base(i) != kLenBase[i] || len_extra(i) != kLenExtra[i]) return false;
  for (int i = 0; i < 30; ++i)
    if (dist_base(i) != kDistBase[i] || dist_extra(i) != kDistExtra[i]) return false;
  for (int len = 3; len <= kMaxMatch; ++len) {
    const int li = len_index(len);
    if (len < len_base(li) || (li < 28 && len >= len_base(li + 1))) return false;
  }
  for (int d = 1; d <= kMaxDist; ++d) {
    const int di = dist_index(d);
    if (d < dist_base(di) || (di < 29 && d >= dist_base(di + 1))) return false;
  }
  return true;
}
static_assert(formulas_match_the_tables(), "length/distance formulas differ from RFC 1951");

// ---------------------------------------------------------------------------
// Primitives, plain on the host.

HBT_DEFLATE_HD HBT_DEFLATE_INLINE int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Index of the highest set bit; -1 for 0.
HBT_DEFLATE_HD HBT_DEFLATE_INLINE int top(uint32_t x) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(static_cast<int>(x));
#else
  return x ? 31 - __builtin_clz(x) : -1;
#endif
}

// Index of the lowest set bit, x != 0.
HBT_DEFLATE_HD HBT_DEFLATE_INLINE int low(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs(static_cast<int>(x)) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// An MSB-first Huffman code of n bits as the LSB-first stream pattern.
HBT_DEFLATE_HD HBT_DEFLATE_INLINE uint32_t rev(uint32_t code, int n) {
#ifdef __CUDA_ARCH__
  return __brev(code) >> (32 - n);
#else
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((code >> i) & 1u) << (n - 1 - i);
  return r;
#endif
}

// Little-endian 32 bits at byte b of the staged words (any alignment).
HBT_DEFLATE_HD HBT_DEFLATE_INLINE uint32_t word_at(const uint32_t* s32, int b) {
  const int w = b >> 2;
#ifdef __CUDA_ARCH__
  return __funnelshift_r(s32[w], s32[w + 1], (b & 3) * 8);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(s32[w + 1]) << 32 | s32[w]) >> ((b & 3) * 8));
#endif
}

// *p |= v (atomically) where `on`.  On the device a predicated reduction,
// not a branch around an atomic.
HBT_DEFLATE_HD HBT_DEFLATE_INLINE void or_word(bool on, uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q red.shared.or.b32 [%0], %1;\n\t}"
      ::"r"(a), "r"(v), "r"(on ? 1u : 0u) : "memory");
#else
  if (on) *p |= v;
#endif
}

// OR up to 36 bits into the ring at absolute bit `at` (at most three
// words) where `on`.
HBT_DEFLATE_HD HBT_DEFLATE_INLINE void put_bits(bool on, uint32_t* ring, int32_t at, uint64_t v) {
  const int s = at & 31;
  const int w = (at >> 5) & (kRingWords - 1);
  const uint64_t hi = (v >> 1) >> (31 - s);  // v >> (32 - s), also for s = 0
  or_word(on, ring + w, static_cast<uint32_t>(v << s));
  or_word(on && hi != 0, ring + ((w + 1) & (kRingWords - 1)), static_cast<uint32_t>(hi));
  or_word(on && (hi >> 32) != 0, ring + ((w + 2) & (kRingWords - 1)),
          static_cast<uint32_t>(hi >> 32));
}

// The fixed-code pattern of a literal byte, and its length (8 or 9).
HBT_DEFLATE_HD HBT_DEFLATE_INLINE uint32_t literal_bits(uint32_t v) {
  return v < 144 ? rev(0x30 + v, 8) : rev(0x190 + (v - 144), 9);
}

// The pattern of a copy (length 4..258, distance 1..32768): length code,
// its extra bits, distance code, its extra bits; *n gets its length (<= 31).
HBT_DEFLATE_HD HBT_DEFLATE_INLINE uint32_t copy_bits(int len, int dist, int* n) {
  const int li = len_index(len);
  const int ln = li <= 22 ? 7 : 8;
  const uint32_t lcode = li <= 22 ? static_cast<uint32_t>(li + 1)
                                  : static_cast<uint32_t>(0xC0 + (li - 23));
  const int e1 = len_extra(li);
  const int di = dist_index(dist);
  const int e2 = dist_extra(di);
  *n = ln + e1 + 5 + e2;
  return rev(lcode, ln) | (static_cast<uint32_t>(len - len_base(li)) << ln) |
         (rev(static_cast<uint32_t>(di), 5) << (ln + e1)) |
         (static_cast<uint32_t>(dist - dist_base(di)) << (ln + e1 + 5));
}

// ---------------------------------------------------------------------------
// The warp: one lane's registers on the device, all 32 lanes on the host,
// which runs every step for lanes 0..31 before the next step starts.

struct Lane {
  int id;
  int32_t p;     // cur + id
  uint32_t w;    // the word at p
  uint32_t key;  // hash of w (0 where the lane does not hash)
  uint32_t grp;  // the hashing lanes of my hash
  uint32_t o12;  // the heads of key before this window: h1 | h2 << 16
  int32_t mpos;  // the matching candidate
  uint32_t x;    // extension: XOR of the two words at my offset
  uint32_t nxt;  // a later lane's value (take_down)
  uint32_t lit;  // my literal's pattern in the window whose bits are pending
  uint32_t bits; // that pattern with the next lane's
  bool hashes, matches, commit, hi9;
};

struct Warp {
#ifdef __CUDA_ARCH__
  Lane l;
#else
  Lane l[kLanes];
#endif
};

HBT_DEFLATE_HD HBT_DEFLATE_INLINE void init_lanes(Warp& q, int lane) {
#ifdef __CUDA_ARCH__
  q.l.id = lane;
#else
  for (int j = 0; j < kLanes; ++j) q.l[j].id = j;
  (void)lane;
#endif
}

template <class F>
HBT_DEFLATE_HD HBT_DEFLATE_INLINE void each(Warp& q, F f) {
#ifdef __CUDA_ARCH__
  f(q.l);
#else
  for (int j = 0; j < kLanes; ++j) f(q.l[j]);
#endif
}

template <class F>
HBT_DEFLATE_HD HBT_DEFLATE_INLINE uint32_t ballot(const Warp& q, F pred) {
#ifdef __CUDA_ARCH__
  return __ballot_sync(kFull, pred(q.l));
#else
  uint32_t m = 0;
  for (int j = 0; j < kLanes; ++j) m |= static_cast<uint32_t>(pred(q.l[j]) ? 1 : 0) << j;
  return m;
#endif
}

// Lane.nxt = `get` of lane id + d, 0 past lane 31.
template <class G>
HBT_DEFLATE_HD HBT_DEFLATE_INLINE void take_down(Warp& q, int d, G get) {
#ifdef __CUDA_ARCH__
  const uint32_t v = __shfl_down_sync(kFull, get(q.l), d);
  q.l.nxt = q.l.id + d < kLanes ? v : 0u;
#else
  uint32_t v[kLanes];
  for (int j = 0; j < kLanes; ++j) v[j] = j + d < kLanes ? get(q.l[j + d]) : 0u;
  for (int j = 0; j < kLanes; ++j) q.l[j].nxt = v[j];
#endif
}

template <class F>
HBT_DEFLATE_HD HBT_DEFLATE_INLINE uint32_t from_lane(const Warp& q, int src, F get) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(kFull, get(q.l), src);
#else
  return get(q.l[src]);
#endif
}

// ---------------------------------------------------------------------------
// One member.

struct Member {
  const uint32_t* s32;  // staged words; the member starts at byte `lead`,
  int lead;             // kReadPast readable bytes follow it
  int32_t plen;
  int hb;               // hash width, 8..11
  uint32_t* heads;      // 2^hb slots, zero: h1 | h2 << 16 (position + 1, 0 = empty)
  uint32_t* groups;     // 2^hb slots, zero: a window's lanes of each hash
  uint32_t* ring;       // kRingWords, zero
  uint8_t* out;         // the member's row (zero)
};

struct Counts {
  int32_t literals, copies, windows;
};

// A decided window whose bits are not in the ring yet: they go in while
// the next window's loads are in flight.  Lane.lit holds the literals'
// patterns.
struct Pending {
  int32_t at;     // bit offset of the window's first code
  uint32_t hi9;   // the literal lanes whose code has 9 bits
  int nlit;       // literals: lanes 0..nlit-1
  bool hit;       // a copy follows them
  uint32_t cpat;  // its pattern
};

// Lanes 4k OR in the patterns of lanes 4k..4k+3 (at most 36 bits) and
// lane nlit the copy's, so at most nine lanes write, each at most three ring
// words.
HBT_DEFLATE_HD HBT_DEFLATE_INLINE void emit(Warp& q, const Member& m, const Pending& e) {
  take_down(q, 1, [](const Lane& L) { return L.lit; });
  each(q, [&](Lane& L) { L.bits = L.lit | L.nxt << (8 + ((e.hi9 >> L.id) & 1u)); });
  take_down(q, 2, [](const Lane& L) { return L.bits; });
  each(q, [&](Lane& L) {
    const int32_t at = e.at + 8 * L.id + popc(e.hi9 & ((1u << L.id) - 1u));
    const bool quad = (L.id & 3) == 0 && L.id < e.nlit;
    const bool copy = L.id == e.nlit && e.hit;
    const uint64_t v =
        copy ? e.cpat : L.bits | static_cast<uint64_t>(L.nxt) << (16 + popc((e.hi9 >> L.id) & 3u));
    put_bits(quad || copy, m.ring, at, v);
  });
}

// Bytes [from, to) of the stream from the ring to the row; lane L takes
// bytes 4L..4L+3 of each 128-byte stretch and clears its ring word.  `from`
// is a stretch's first byte; bytes of the last stretch past `to` stay in
// the ring (zero).
HBT_DEFLATE_HD HBT_DEFLATE_INLINE void flush(Warp& q, const Member& m, int32_t from,
                                             int32_t to) {
  each(q, [&](Lane& L) {
    for (int32_t s = from; s < to; s += 4 * kLanes) {
      const int32_t b = s + 4 * L.id;
      uint32_t* rw = m.ring + ((b >> 2) & (kRingWords - 1));
      const uint32_t v = *rw;
      *rw = 0;
      if (b + 4 <= to) {
        for (int k = 0; k < 4; ++k) m.out[b + k] = static_cast<uint8_t>(v >> (8 * k));
      } else {
        for (int k = 0; k < 4; ++k)
          if (b + k < to) m.out[b + k] = static_cast<uint8_t>(v >> (8 * k));
      }
    }
  });
  HBT_DEFLATE_SYNC();
}

// Length of the copy from mpos at p: min(LCP, cap) where the first 4 bytes
// are known equal; 32 words a step.
HBT_DEFLATE_HD HBT_DEFLATE_INLINE int32_t extend(Warp& q, const Member& m, int32_t p,
                                                 int32_t mpos, int32_t cap) {
  for (int32_t base = kMinMatch;; base += 4 * kLanes) {
    each(q, [&](Lane& L) {
      const int32_t off = base + 4 * L.id;
      const int32_t o = off < cap ? off : 0;  // loads in range, no branch
      const uint32_t x = word_at(m.s32, m.lead + p + o) ^ word_at(m.s32, m.lead + mpos + o);
      L.x = off < cap ? x : 1u;
    });
    const uint32_t bad = ballot(q, [](const Lane& L) { return L.x != 0; });
    if (bad) {
      const int f = low(bad);
      const uint32_t xf = from_lane(q, f, [](const Lane& L) { return L.x; });
      const int32_t lcp = base + 4 * f + (low(xf) >> 3);
      return lcp < cap ? lcp : cap;
    }
  }
}

// Compress one member into m.out; returns its byte length.  All lanes of
// the warp call it together.  *c gets the token counts (on every lane).
HBT_DEFLATE_HD inline int32_t deflate_member(Warp& q, const Member& m, Counts* c) {
  const int shift = 32 - m.hb;
  int32_t cur = 0;
  int32_t bits = 3;  // BFINAL = 1, BTYPE = 01 (fixed Huffman)
  int32_t flushed = 0;
  Counts n{0, 0, 0};
  Pending e{bits, 0u, 0, false, 0u};
  each(q, [&](Lane& L) {
    L.lit = 0;
    or_word(L.id == 0, m.ring, 3u);
  });
  while (cur < m.plen) {
    // 1. Words, hashes and the heads as they stand.
    each(q, [&](Lane& L) {
      L.p = cur + L.id;
      L.hashes = L.p + kMinMatch <= m.plen;
      L.w = L.p < m.plen ? word_at(m.s32, m.lead + L.p) : 0u;
      L.key = L.hashes ? (L.w * kHashMul) >> shift : 0u;
      L.o12 = L.hashes ? m.heads[L.key] : 0u;
      L.hi9 = (L.w & 0xFFu) >= 144;
    });
    emit(q, m, e);  // the previous window's bits, beside this window's loads
    // Hash groups: each hashing lane ORs its bit into its hash's slot, reads
    // the slot back and, once every lane has read, clears it.
    each(q, [&](Lane& L) {
      or_word(L.hashes, m.groups + L.key, 1u << L.id);
    });
    HBT_DEFLATE_SYNC();
    each(q, [&](Lane& L) { L.grp = L.hashes ? m.groups[L.key] : 0u; });
    HBT_DEFLATE_SYNC();
    each(q, [&](Lane& L) {
      if (L.hashes) m.groups[L.key] = 0;
    });
    // 2. Candidates and the match test.
    each(q, [&](Lane& L) {
      const uint32_t before = L.grp & ((1u << L.id) - 1u);
      const int32_t o1 = static_cast<int32_t>(L.o12 & 0xFFFFu) - 1;
      const int32_t o2 = static_cast<int32_t>(L.o12 >> 16) - 1;
      const int t1 = top(before);
      const int t2 = top(before & ~(1u << (t1 & 31)));
      const int32_t c1 = t1 >= 0 ? cur + t1 : o1;
      const int32_t c2 = t2 >= 0 ? cur + t2 : t1 >= 0 ? o1 : o2;
      // Both words are loaded whatever the checks say (no branch).
      const uint32_t w1 = word_at(m.s32, m.lead + (c1 > 0 ? c1 : 0));
      const uint32_t w2 = word_at(m.s32, m.lead + (c2 > 0 ? c2 : 0));
      const bool m1 = c1 >= 0 && L.p - c1 <= kMaxDist && w1 == L.w;
      const bool m2 = c2 >= 0 && L.p - c2 <= kMaxDist && w2 == L.w;
      L.matches = L.hashes && (m1 || m2);
      L.mpos = m1 ? c1 : c2;
    });
    const uint32_t hit = ballot(q, [](const Lane& L) { return L.matches; });
    const int32_t live = m.plen - cur < kLanes ? m.plen - cur : kLanes;
    const int nlit = hit ? low(hit) : live;
    // 3. Heads: the last committed lane of each hash group.
    each(q, [&](Lane& L) { L.commit = L.hashes && L.id <= nlit; });
    const uint32_t ins = ballot(q, [](const Lane& L) { return L.commit; });
    each(q, [&](Lane& L) {
      const uint32_t k = L.grp & ins;
      const int t2 = top(k & ((1u << L.id) - 1u));
      const uint32_t h2 = t2 >= 0 ? static_cast<uint32_t>(cur + t2 + 1) : (L.o12 & 0xFFFFu);
      if (L.commit && L.id == top(k)) m.heads[L.key] = static_cast<uint32_t>(L.p + 1) | h2 << 16;
    });
    // 4. The copy, if any.
    int32_t mlen = 0, dist = 0;
    if (hit) {
      const int32_t pf = cur + nlit;
      const int32_t mpos = static_cast<int32_t>(
          from_lane(q, nlit, [](const Lane& L) { return static_cast<uint32_t>(L.mpos); }));
      const int32_t cap = m.plen - pf < kMaxMatch ? m.plen - pf : kMaxMatch;
      mlen = extend(q, m, pf, mpos, cap);
      dist = pf - mpos;
    }
    // 5. Bits: literals 0..nlit-1, then the copy; they are emitted with
    //    the next window.
    const uint32_t lits = nlit >= kLanes ? kFull : (1u << nlit) - 1u;
    const uint32_t hi9 = ballot(q, [](const Lane& L) { return L.hi9; }) & lits;
    const int32_t lit_bits = 8 * nlit + popc(hi9);
    int cbits = 0;
    const uint32_t cpat = hit ? copy_bits(mlen, dist, &cbits) : 0u;
    each(q, [&](Lane& L) { L.lit = L.id < nlit ? literal_bits(L.w & 0xFFu) : 0u; });
    e = Pending{bits, hi9, nlit, hit != 0, cpat};
    const int32_t emitted = bits;  // every earlier window's bits are in the ring
    bits += lit_bits + cbits;
    cur = hit ? cur + nlit + mlen : cur + live;
    n.literals += nlit;
    n.copies += hit ? 1 : 0;
    n.windows += 1;
    HBT_DEFLATE_SYNC();
    // 6. Stretches wholly behind the emitted bits go out.
    const int32_t done = (emitted / kStretchBits) * (kStretchBits / 8);
    if (done > flushed) {
      flush(q, m, flushed, done);
      flushed = done;
    }
  }
  emit(q, m, e);
  HBT_DEFLATE_SYNC();
  bits += 7;  // end of block: code 256 is seven zero bits
  const int32_t clen = (bits + 7) >> 3;
  flush(q, m, flushed, clen);
  *c = n;
  return clen;
}

}  // namespace hbt_deflate
