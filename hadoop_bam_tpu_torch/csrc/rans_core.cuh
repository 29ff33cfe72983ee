// The decoder core of csrc/rans.cu: one rANS 4x8 stream (CRAM 3.0, order 0
// or order 1), decoded by four lanes of one warp (the device), or by a host
// build with g++ that runs the four lanes in lockstep, which the CPU tests
// hold to the plain version.
//
// The wave model is the plain version's (ops/kernels/rans.py _decode_one):
// wave t decodes one byte with state j = t & 3, and order 1's remainder
// tail (t >= 4 * (n >> 2)) uses state 3 alone.  A step is
//
//   m = R & 4095;  s = sym[m];  x = F[s] * (R >> 12) + m - C[s]
//
// followed by up to two renorm reads x = x << 8 | byte that bring x back to
// at least L = 2^23.  A group is four waves, one a lane:
//
//   - Lane j owns state j.  The four lookups and updates of a group are
//     independent; only the renorm bytes are shared: lane j's bytes follow
//     those of lanes 0 .. j-1.  Each lane votes whether it reads one byte
//     (x < 2^23) and two (x < 2^15); the two ballots give each lane its
//     offset (a popcount of the lower lanes' votes) and the group its byte
//     count.  The warp runs one instruction for all four lanes, so a
//     group costs about what one state's step costs a lone thread.
//   - Split slot tables.  A table is three arrays of 16-bit entries, F[sym],
//     the bias m - C[sym] and sym, so a step is three independent shared
//     loads at one index 2m and one multiply-add.  Slots past a table's
//     total hold symbol 0 with C = 0; F = 4096 (one symbol) and F = 0 both
//     fit.  The renorm's funnel shift gives 2m of the next step directly.
//   - Exact 32-bit states.  The header's states are u32 and F <= 4096, so
//     F * (R >> 12) + bias <= 4096 * (2^20 - 1) + 4095 = 2^32 - 1; a renorm
//     shifts only a state below 2^23 (by one byte) or below 2^15 (by two),
//     so it stays below 2^31.  One 32-bit multiply-add a state.
//   - Branch-free renorm.  The new state is x << 8c OR'd with the c bytes
//     at the lane's offset: one byte permute of the 8-byte window at the
//     cursor and one funnel shift.  It is still below L exactly when
//     x < 2^7, so each lane keeps the least x it saw.
//   - Verdicts by accumulation.  A state left below L, a missing order-1
//     context and a cursor past clen are looked at once per kCheck groups,
//     so the loop takes no branch on a fresh value inside a block; the
//     groups after a failed verdict write bytes nobody reads (the caller
//     decodes such a stream again).
//   - A payload ring.  The stream's payload (16-aligned, padded by pack()
//     with at least kSlack readable bytes) is copied into a kRing-byte ring
//     in shared memory in kChunk-byte chunks, kRingChunks ahead of the
//     cursor, by one-dimensional bulk copies (cp.async.bulk, completion on
//     an mbarrier a slot); the ring's first 16 bytes are mirrored past its
//     end, so the window is three aligned loads at the cursor, in parallel
//     with the group's table loads.  The host build copies with memcpy and
//     counts every read of a chunk that is not ready or already overwritten
//     as a fault.
//
// The plain version's verdicts: a renorm read at or past clen, a state still
// below L after two reads, an absent order-1 context.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define HBT_RANS_HD __host__ __device__
#define HBT_RANS_INLINE __forceinline__
#define HBT_RANS_UNROLL _Pragma("unroll")
#else
#define HBT_RANS_HD
#define HBT_RANS_INLINE inline
#define HBT_RANS_UNROLL
#endif
#define HBT_RANS_UNLIKELY(x) __builtin_expect(!!(x), 0)

namespace hbt_rans {

constexpr uint32_t kL = 1u << 23;
constexpr int kSlots = 4096;
constexpr int kLanes = 4;     // lanes a stream, one state each
constexpr int kMetaCols = 9;  // pay_off, clen, out_off, n_out, order, R0..R3
constexpr uint32_t kChunk = 1024;
constexpr uint32_t kRingChunks = 8;
constexpr uint32_t kRing = kChunk * kRingChunks;
constexpr uint32_t kMirror = 16;  // the ring's first bytes, again past its end
constexpr uint32_t kCheck = 16;   // groups between two looks at the verdicts
// Bytes past a stream's payload (rounded up to 16) that a decode may read:
// between two looks a block reads at most 8 bytes a group and the window
// 12 bytes from the word at the cursor; the look stops at cursor > clen.
constexpr uint32_t kSlack = 256;
static_assert(8 * kCheck + 12 <= kSlack, "kSlack does not cover a block of groups");
static_assert(8 * kCheck + 12 <= kChunk, "a block of groups must fit one chunk ahead");
constexpr int kTabBytes = kSlots * 6;  // u16 F, then u16 bias, then u16 sym, a slot each
constexpr int kTabWords = kTabBytes / 4;
constexpr int kMaxStage = 9;  // tables in shared memory, at most
// Shared memory: the ring and its mirror, its barriers, order 1's context
// map, the tables.
constexpr uint32_t kBarOff = kRing + kMirror;
constexpr uint32_t kPtrOff = kBarOff + 8 * kRingChunks;
constexpr uint32_t kTabOff = kPtrOff + 8 * 256;
static_assert(kTabOff % 16 == 0, "tables must be 16-aligned");

HBT_RANS_HD constexpr uint32_t smem_bytes(int stage) {
  return kTabOff + static_cast<uint32_t>(stage) * kTabBytes;
}

// ---------------------------------------------------------------------------
// Primitives, plain on the host.

// Bytes of (hi:lo) picked by sel's nibbles (each below 8 here, where the
// device's prmt and the plain version agree).
HBT_RANS_HD HBT_RANS_INLINE uint32_t prmt(uint32_t lo, uint32_t hi, uint32_t sel) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
#else
  const uint64_t v = static_cast<uint64_t>(hi) << 32 | lo;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<uint32_t>((v >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
#endif
}

// The high word of (hi:lo) << sh, sh < 32.
HBT_RANS_HD HBT_RANS_INLINE uint32_t fshl(uint32_t lo, uint32_t hi, uint32_t sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(lo, hi, sh);
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32 | lo) << sh) >> 32);
#endif
}

// The low word of (hi:lo) >> sh, sh < 32.
HBT_RANS_HD HBT_RANS_INLINE uint32_t fshr(uint32_t lo, uint32_t hi, uint32_t sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(hi) << 32 | lo) >> sh);
#endif
}

HBT_RANS_HD HBT_RANS_INLINE uint32_t popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return static_cast<uint32_t>(__builtin_popcount(x));
#endif
}

HBT_RANS_HD HBT_RANS_INLINE uint32_t ld16(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint16_t*>(p);
#else
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
#endif
}

HBT_RANS_HD HBT_RANS_INLINE uint32_t ld32(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

#ifdef __CUDA_ARCH__
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

// ---------------------------------------------------------------------------
// Tables.

// The stream's slabs: pack() gives them consecutive indices (an order-0
// row of cmap holds its one slab everywhere).
struct Slabs {
  int32_t first;
  int32_t count;
};

HBT_RANS_HD HBT_RANS_INLINE Slabs stream_slabs(const int32_t* cm, int order) {
  if (order == 0) return Slabs{cm[0], 1};
  Slabs s{0x7fffffff, 0};
  for (int c = 0; c < 256; ++c) {
    const int32_t v = cm[c];
    s.first = v >= 0 && v < s.first ? v : s.first;
    s.count += v >= 0;
  }
  return s;
}

// Table k of the stream: in shared memory (tabs) for k < stage, else in
// the global spill area at its slab.
HBT_RANS_HD HBT_RANS_INLINE uint8_t* table_of(int32_t k, Slabs s, int stage, uint8_t* tabs,
                                              uint8_t* spill) {
  return k < stage ? tabs + static_cast<int64_t>(k) * kTabBytes
                   : spill + static_cast<int64_t>(s.first + k) * kTabBytes;
}

// Fill the stream's tables from the dense ones (lk: slot -> symbol, fc:
// C << 16 | F per symbol), slot-strided over nt threads.
HBT_RANS_HD HBT_RANS_INLINE void fill_tables(const uint8_t* lookup, const uint32_t* fc,
                                             Slabs s, int stage, uint8_t* tabs, uint8_t* spill,
                                             int tid, int nt) {
  const int64_t total = static_cast<int64_t>(s.count) * kSlots;
  for (int64_t i = tid; i < total; i += nt) {
    const int32_t k = static_cast<int32_t>(i >> 12);
    const uint32_t m = static_cast<uint32_t>(i & (kSlots - 1));
    const int64_t slab = s.first + k;
    const uint32_t sym = lookup[slab * kSlots + m];
    const uint32_t e = fc[slab * 256 + sym];
    uint16_t* t = reinterpret_cast<uint16_t*>(table_of(k, s, stage, tabs, spill));
    t[m] = static_cast<uint16_t>(e & 0xFFFFu);
    t[kSlots + m] = static_cast<uint16_t>((m - (e >> 16)) & 4095u);
    t[2 * kSlots + m] = static_cast<uint16_t>(sym);
  }
}

// Order 1's context map: the table's address, | 2 where the context is
// absent (then the address is table 0's, a readable one).
HBT_RANS_HD HBT_RANS_INLINE void fill_ptrs(const int32_t* cm, Slabs s, int stage, uint8_t* tabs,
                                           uint8_t* spill, uint64_t* ptrs, int tid, int nt) {
  for (int c = tid; c < 256; c += nt) {
    const int32_t slab = cm[c];
    ptrs[c] = slab < 0 ? reinterpret_cast<uintptr_t>(tabs) | 2u
                       : reinterpret_cast<uintptr_t>(table_of(slab - s.first, s, stage, tabs,
                                                              spill));
  }
}

// ---------------------------------------------------------------------------
// The payload ring.  Every lane keeps the same counters; the leader (lane
// 0) starts the copies, every lane waits.

struct Ring {
  uint8_t* buf;        // kRing + kMirror bytes: chunk k at (k % kRingChunks) * kChunk
  uint64_t* bars;      // one mbarrier a slot
  const uint8_t* src;  // the stream's payload, 16-aligned
  uint32_t n_chunks;   // of the region: round_up(clen, 16) + kSlack bytes
  uint32_t region;
  uint32_t asked, ready;  // chunks asked for, chunks waited for
  uint32_t svc;            // the cursor at which service() runs next
  uint32_t fault;          // host: reads of chunks not ready or overwritten
  uint32_t mirrored;       // host: the chunk whose first bytes the mirror holds
};

// The ring's barriers (the device's; the host build has none).
HBT_RANS_HD HBT_RANS_INLINE void init_bars(uint64_t* bars) {
#ifdef __CUDA_ARCH__
  for (uint32_t k = 0; k < kRingChunks; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + k)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#else
  (void)bars;
#endif
}

HBT_RANS_HD HBT_RANS_INLINE Ring open_ring(uint8_t* buf, uint64_t* bars, const uint8_t* src,
                                           uint32_t clen) {
  Ring g;
  g.buf = buf;
  g.bars = bars;
  g.src = src;
  g.region = ((clen + 15u) & ~15u) + kSlack;
  g.n_chunks = (g.region + kChunk - 1) / kChunk;
  g.asked = g.ready = g.svc = g.fault = 0;
  g.mirrored = ~0u;
  return g;
}

// Ask for the next chunk: a bulk copy into its slot (and, for slot 0, of
// its first bytes into the mirror), completing on the slot's barrier.
HBT_RANS_HD HBT_RANS_INLINE void request(Ring& g, bool leader) {
  const uint32_t k = g.asked++;
  const uint32_t off = k * kChunk;
  const uint32_t n = g.region - off < kChunk ? g.region - off : kChunk;
  const uint32_t slot = k % kRingChunks;
  uint8_t* dst = g.buf + slot * kChunk;
  if (!leader) return;
#ifdef __CUDA_ARCH__
  const uint32_t bar = smem_addr(g.bars + slot);
  const uint32_t bytes = n + (slot == 0 ? kMirror : 0u);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(g.src + off), "r"(n), "r"(bar)
      : "memory");
  if (slot == 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_addr(g.buf + kRing)),
        "l"(g.src + off), "r"(kMirror), "r"(bar)
        : "memory");
#else
  memcpy(dst, g.src + off, n);
  if (slot == 0) {
    memcpy(g.buf + kRing, g.src + off, kMirror);
    g.mirrored = k;
  }
#endif
}

// Wait for the oldest chunk not yet waited for.
HBT_RANS_HD HBT_RANS_INLINE void await(Ring& g) {
  const uint32_t k = g.ready++;
#ifdef __CUDA_ARCH__
  const uint32_t bar = smem_addr(g.bars + k % kRingChunks);
  const uint32_t parity = (k / kRingChunks) & 1u;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "RANS_WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra RANS_WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
#else
  (void)k;
#endif
}

// Ask for the first ring's worth of chunks (while the tables are built).
HBT_RANS_HD HBT_RANS_INLINE void prime(Ring& g, bool leader) {
  while (g.asked < g.n_chunks && g.asked < kRingChunks) request(g, leader);
}

// Keep chunks cur .. cur + kRingChunks - 1 asked for (cur holds the cursor
// p) and cur, cur + 1 arrived: a block of groups reads less than one chunk
// past p.
HBT_RANS_HD HBT_RANS_INLINE void service(Ring& g, uint32_t p, bool leader) {
  const uint32_t cur = p / kChunk;
  const uint32_t want = cur + kRingChunks < g.n_chunks ? cur + kRingChunks : g.n_chunks;
  const uint32_t need = cur + 2 < g.n_chunks ? cur + 2 : g.n_chunks;
  if (g.asked < want) {
#ifdef __CUDA_ARCH__
    // The slots about to be refilled were read through the generic proxy.
    __syncwarp((1u << kLanes) - 1);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
    while (g.asked < want) request(g, leader);
  }
  while (g.ready < need) await(g);
  g.svc = (cur + 1) * kChunk;
}

// Before the block's shared memory is given up: no copy may still land.
HBT_RANS_HD HBT_RANS_INLINE void drain(Ring& g) {
  while (g.ready < g.asked) await(g);
}

// The 8 bytes at the cursor p, low byte first: three aligned words from the
// ring (the mirror covers the wrap) and two funnel shifts.
HBT_RANS_HD HBT_RANS_INLINE void window(Ring& g, uint32_t p, uint32_t& lo, uint32_t& hi) {
  const uint32_t a = p & (kRing - 4);
#ifndef __CUDA_ARCH__
  for (uint32_t q = p & ~3u; q <= (p & ~3u) + 11; q += 11) {
    const uint32_t k = q / kChunk;
    g.fault += k >= g.ready || g.asked > k + kRingChunks;
  }
  if (a + 12 > kRing) g.fault += g.mirrored != ((p & ~3u) + 11) / kChunk;
#endif
  const uint32_t w0 = ld32(g.buf + a), w1 = ld32(g.buf + a + 4), w2 = ld32(g.buf + a + 8);
  const uint32_t sh = (p << 3) & 24u;
  lo = fshr(w0, w1, sh);
  hi = fshr(w1, w2, sh);
}

// ---------------------------------------------------------------------------
// The walk.

struct Lane {
  uint32_t lane;   // 0..3: the state it owns
  uint32_t below;  // the vote bits of the lanes below it
  uint32_t r;      // its state
  uint32_t idx;    // 2 * (r & 4095): its slot's byte offset in a table array
  uint32_t x;      // the state before renorm
  uint32_t sym;    // the symbol of the last step
  uint32_t p0, p1;  // the step reads one byte, two bytes
  uint32_t vmin;   // the least x of its steps (below 2^7: a failed renorm)
  uint32_t miss;   // order 1: it met an absent context
  const uint8_t* tab;  // order 1: the table of its context
  uint8_t* out;        // where its next byte goes
};

// The lanes of one stream: this thread's on the device, all four on the
// host, which runs them in lockstep.
struct Lanes {
#ifdef __CUDA_ARCH__
  Lane l;
#else
  Lane l[kLanes];
#endif
};

template <class F>
HBT_RANS_HD HBT_RANS_INLINE void each(Lanes& q, F f) {
#ifdef __CUDA_ARCH__
  f(q.l);
#else
  for (int j = 0; j < kLanes; ++j) f(q.l[j]);
#endif
}

// Bits 0..3: the lanes that read a byte; bits 4..7: the lanes that read two.
HBT_RANS_HD HBT_RANS_INLINE uint32_t votes(const Lanes& q) {
#ifdef __CUDA_ARCH__
  constexpr uint32_t kMask = (1u << kLanes) - 1;
  return (__ballot_sync(kMask, q.l.p1) << 4) + __ballot_sync(kMask, q.l.p0);
#else
  uint32_t v = 0;
  for (int j = 0; j < kLanes; ++j) v |= q.l[j].p0 << j | q.l[j].p1 << (j + 4);
  return v;
#endif
}

HBT_RANS_HD HBT_RANS_INLINE bool any_bad(const Lanes& q) {
#ifdef __CUDA_ARCH__
  return __any_sync((1u << kLanes) - 1, q.l.vmin < (1u << 7) || q.l.miss);
#else
  bool bad = false;
  for (int j = 0; j < kLanes; ++j) bad |= q.l[j].vmin < (1u << 7) || q.l[j].miss;
  return bad;
#endif
}

// The step before renorm, for lanes in act (a bit mask); the others keep
// their state and read nothing.
HBT_RANS_HD HBT_RANS_INLINE void look(Lane& L, const uint8_t* tab, uint32_t act) {
  const uint32_t on = act == 15u ? 1u : (act >> L.lane) & 1u;
  const uint32_t f = ld16(tab + L.idx), b = ld16(tab + 2 * kSlots + L.idx);
  L.sym = ld16(tab + 4 * kSlots + L.idx);
  const uint32_t x = f * (L.r >> 12) + b;
  L.x = on ? x : L.r;
  L.p0 = on & (x < kL);
  L.p1 = on & (x < (1u << 15));
  L.vmin = on && x < L.vmin ? x : L.vmin;
}

// The renorm: the c bytes at the lane's offset o in the window, taken as
// the top bytes of one permute, shifted in under x.  One bit more of the
// same shift is the next slot's offset, 2 * (r & 4095).
HBT_RANS_HD HBT_RANS_INLINE void renorm(Lane& L, uint32_t v, uint32_t lo, uint32_t hi) {
  const uint32_t o = popc(v & L.below);
  const uint32_t s8 = L.p1 ? 16u : (L.p0 ? 8u : 0u);
  const uint32_t bytes = prmt(lo, hi, o * 0x1100u + 0x0100u);
  L.r = fshl(bytes, L.x, s8);
  L.idx = fshl(bytes, L.x, s8 + 1) & (2 * kSlots - 2);
}

struct Walk {
  Ring g;
  uint32_t p;  // the cursor
  bool leader;
};

// One group: every lane's step (through tab, or with kCtx each lane's
// context table), then the shared renorm.
template <bool kCtx>
HBT_RANS_HD HBT_RANS_INLINE void group(Lanes& q, Walk& w, const uint8_t* tab, uint32_t act) {
  each(q, [&](Lane& L) { look(L, kCtx ? L.tab : tab, act); });
  const uint32_t v = votes(q);
  uint32_t lo, hi;
  window(w.g, w.p, lo, hi);
  each(q, [&](Lane& L) { renorm(L, v, lo, hi); });
  w.p += popc(v);
}

// The look between blocks: keep the ring ahead, and true when the walk must
// stop (a failed verdict).
HBT_RANS_HD HBT_RANS_INLINE bool stop(Lanes& q, Walk& w, uint32_t clen) {
  if (HBT_RANS_UNLIKELY(w.p >= w.g.svc)) service(w.g, w.p, w.leader);
  return any_bad(q) | (w.p > clen);
}

// Order 0: one table, output in wave order, lane j's byte at 4g + j.
HBT_RANS_HD HBT_RANS_INLINE bool decode0(Lanes& q, Walk& w, const uint8_t* tab, uint8_t* out,
                                         uint32_t n, uint32_t clen) {
  const uint32_t groups = n >> 2;
  uint32_t gi = 0;
  each(q, [&](Lane& L) { L.out = out + L.lane; });
  for (; gi + kCheck <= groups; gi += kCheck) {
    if (stop(q, w, clen)) return false;
    HBT_RANS_UNROLL
    for (uint32_t u = 0; u < kCheck; ++u) {
      group<false>(q, w, tab, 15u);
      each(q, [&](Lane& L) { L.out[4 * u] = static_cast<uint8_t>(L.sym); });
    }
    each(q, [&](Lane& L) { L.out += 4 * kCheck; });
  }
  for (; gi < groups; ++gi) {
    if (stop(q, w, clen)) return false;
    group<false>(q, w, tab, 15u);
    each(q, [&](Lane& L) {
      *L.out = static_cast<uint8_t>(L.sym);
      L.out += 4;
    });
  }
  const uint32_t rem = n & 3;
  if (rem) {
    if (stop(q, w, clen)) return false;
    group<false>(q, w, tab, (1u << rem) - 1);
    each(q, [&](Lane& L) {
      if (L.lane < rem) out[4 * groups + L.lane] = static_cast<uint8_t>(L.sym);
    });
  }
  return !(any_bad(q) | (w.p > clen));
}

// Lane L's table: the context map's entry for its last symbol.
HBT_RANS_HD HBT_RANS_INLINE void context(Lane& L, const uint64_t* ptrs, uint32_t on) {
  const uint64_t p = ptrs[L.sym];
  L.tab = reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(p & ~uint64_t(3)));
  L.miss |= on & static_cast<uint32_t>(p >> 1) & 1u;
}

// Order 1: a table per context (the state's previous symbol, 0 first); lane
// j fills quarter j of the output, lane 3 then the n % 4 tail.
HBT_RANS_HD HBT_RANS_INLINE bool decode1(Lanes& q, Walk& w, const uint64_t* ptrs, uint8_t* out,
                                         uint32_t n, uint32_t clen) {
  const uint32_t q4 = n >> 2;
  each(q, [&](Lane& L) { L.out = out + L.lane * q4; });
  for (uint32_t gi = 0; gi < q4; ++gi) {
    if ((gi & (kCheck - 1)) == 0 && stop(q, w, clen)) return false;
    each(q, [&](Lane& L) { context(L, ptrs, 1u); });
    group<true>(q, w, nullptr, 15u);
    each(q, [&](Lane& L) { *L.out++ = static_cast<uint8_t>(L.sym); });
  }
  for (uint32_t t = 4 * q4; t < n; ++t) {
    if (stop(q, w, clen)) return false;
    each(q, [&](Lane& L) { context(L, ptrs, L.lane == 3); });
    group<true>(q, w, nullptr, 8u);
    each(q, [&](Lane& L) {
      if (L.lane == 3) out[t] = static_cast<uint8_t>(L.sym);
    });
  }
  return !(any_bad(q) | (w.p > clen));
}

// The walk of one stream after its tables are built: true for ok.  The
// ring must be open and primed; it is drained before the return.  lane0 is
// the lane number of q's first lane (the device's lane; 0 on the host).
HBT_RANS_HD HBT_RANS_INLINE bool decode_stream(Ring& g, uint32_t lane0, const int64_t* mt,
                                               const uint8_t* tab0, const uint64_t* ptrs,
                                               uint8_t* out) {
  Walk w{g, 0u, lane0 == 0};
  service(w.g, 0, w.leader);
  Lanes q;
  uint32_t lane = lane0;
  each(q, [&](Lane& L) {
    L.lane = lane++;
    L.below = ((1u << L.lane) - 1) * 0x11u;
    L.r = static_cast<uint32_t>(mt[5 + L.lane]);
    L.idx = (L.r << 1) & (2 * kSlots - 2);
    L.sym = 0;  // order 1's first context
    L.vmin = ~0u;
    L.miss = 0;
    L.tab = tab0;
  });
  const uint32_t clen = static_cast<uint32_t>(mt[1]);
  const uint32_t n = static_cast<uint32_t>(mt[3]);
  const bool ok = mt[4] == 0 ? decode0(q, w, tab0, out, n, clen)
                             : decode1(q, w, ptrs, out, n, clen);
  drain(w.g);
  g = w.g;
  return ok;
}

}  // namespace hbt_rans
