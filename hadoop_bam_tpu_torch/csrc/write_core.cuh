// The cores of csrc/write.cu, the part writer's two device passes: the
// per-member CRC32 and the sorted record gather with the duplicate-flag
// patch.  The device runs them with a block's threads; a host build with g++
// runs the same functions with the threads as loops (HBT_W_EACH), which the
// CPU tests hold to the plain versions, to zlib and to the reference.
//
// CRC32 (crc_member): one block a member.  Positions are counted from the
// 16-byte boundary at or below the member's first byte (h bytes before
// it), so that a round of R = nth * w bytes is staged into shared memory by
// 16-byte cp.async, neighbouring threads on neighbouring chunks.  In each
// round thread t folds its own w bytes, [jR + tw, jR + (t + 1)w), with
// slicing-by-4 tables held in shared memory, into its register g_t.  The
// CRC here is the linear one (register 0, no final inversion), f, for
// which f(A || B) = A^|B|(f(A)) ^ f(B): A^n is n zero bytes fed to the
// register, a linear map, so a constant n applies by table lookups.  So:
//
//   * zero bytes before the data change nothing: the h bytes before the
//     member read as zeros;
//   * zlib's CRC is f of the member with its first 4 bytes complemented,
//     inverted (a member of 1-3 bytes: f, inverted, ^ A^L(~0));
//   * before folding its piece of round j > 0, a thread applies A^(R - w)
//     to g_t (four 256-entry lookups), so that g_t ends relative to the end
//     of its own last piece;
//   * the thread tE that holds the member's last byte folds its last piece
//     (rE <= w bytes) apart, into `last`.  Every other piece ends w bytes
//     after the one before it, in the order tE (its pieces before the last
//     round), tE + 1, ..., nth - 1, 0, ..., tE - 1; numbered u = nth - 1 -
//     that order's index, the block combines X = sum A^(u w)(g) by a tree:
//     level k XORs A^(2^k w) of node u + 2^k into node u (eight 16-entry
//     lookups), across warp shuffles and then across the warps;
//   * the CRC is A^rE(X) ^ last: the last, shorter slice's own shift,
//     rE zero bytes fed to X.
//
// Gather (gather_tile): each block owns a tile of T output bytes and each
// thread whole 16-byte output chunks of it.  tile_first[b] (written by a
// pass of one thread a record) is the record holding the tile's first byte;
// a thread takes a run of consecutive chunks, finds its first record by a
// binary search of the destination ends between its tile's first record
// and the next tile's, and takes each chunk's bytes record by record: the
// source bytes arrive as aligned 16-byte loads (two at most) and are
// re-aligned by funnel shifts, the duplicate flag is ORed into bytes 18 and
// 19 in registers, and the chunk goes out as one
// aligned 16-byte store (bytewise past the stream's last byte).  No load
// touches a byte outside [stream, stream + numel): a 16-byte block that
// crosses either end is read a byte at a time.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define HBT_W_HD __host__ __device__
#define HBT_W_INLINE __forceinline__
#else
#define HBT_W_HD
#define HBT_W_INLINE inline
#endif

// A block-synchronous step: on the device each thread runs the body once as
// thread `tid`; on the host the body runs for every thread in turn.
#ifdef __CUDA_ARCH__
#define HBT_W_SYNC() __syncthreads()
#define HBT_W_EACH(tid, nth) for (int tid = threadIdx.x, tid##_once = 1; tid##_once; tid##_once = 0)
#else
#define HBT_W_SYNC() ((void)0)
#define HBT_W_EACH(tid, nth) for (int tid = 0; tid < (nth); ++tid)
#endif

// A hook on every read of the stream, n bytes at p: a host build may define
// it to check that no byte outside the stream is read.
#ifndef HBT_W_READ
#define HBT_W_READ(p, n) ((void)0)
#endif

namespace hbt_write {

// ---------------------------------------------------------------------------
// Primitives, plain on the host.

HBT_W_HD HBT_W_INLINE uint32_t funnel_r(uint32_t lo, uint32_t hi, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, s);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(hi) << 32 | lo) >> (s & 31));
#endif
}

HBT_W_HD HBT_W_INLINE void load16(uint32_t v[4], const uint8_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
#else
  memcpy(v, p, 16);
#endif
}

HBT_W_HD HBT_W_INLINE void store16(uint8_t* p, const uint32_t v[4]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
#else
  memcpy(p, v, 16);
#endif
}

HBT_W_HD HBT_W_INLINE uint32_t load32(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

// 16 bytes from device memory to shared memory without a register round
// trip (cp.async; every copy of the thread lands at wait_copies()); a plain
// copy on the host.  Both addresses 16-byte aligned.
HBT_W_HD HBT_W_INLINE void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

HBT_W_HD HBT_W_INLINE void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// ---------------------------------------------------------------------------
// CRC32.

// The constants, as 32-bit words (ops/kernels/crc32.py builds them): the
// slicing tables T0-T3 (T0 bytewise), the round shift A^(R - w) as four
// 256-entry tables (byte m of the register), then for each tree level k the
// shift A^(2^k w) as eight 16-entry tables (nibble j of the register).
constexpr int kRoundAt = 1024, kLevelAt = 2048, kLevelWords = 128;

HBT_W_HD HBT_W_INLINE int levels_of(int nth) {
  int k = 0;
  while ((1 << k) < nth) ++k;
  return k;
}

HBT_W_HD HBT_W_INLINE int consts_words(int nth) { return kLevelAt + kLevelWords * levels_of(nth); }

// A round: nth pieces of w bytes (w = 16 * 2^m).  Piece t is staged at
// t * pitch of its buffer; a pitch of an odd number of 16-byte chunks keeps
// a warp's 16-byte shared loads, one piece a thread, off each other's banks.
struct CrcGeometry {
  int32_t nth, w, wshift, pitch, buf;
  int64_t R;
};

HBT_W_HD HBT_W_INLINE CrcGeometry crc_geometry(int nth, int w) {
  CrcGeometry g;
  g.nth = nth;
  g.w = w;
  g.wshift = 0;
  while ((16 << g.wshift) < w) ++g.wshift;
  g.pitch = (w >> 4) & 1 ? w : w + 16;
  g.buf = nth * g.pitch;
  g.R = static_cast<int64_t>(nth) * w;
  return g;
}

HBT_W_HD HBT_W_INLINE int64_t crc_smem_bytes(int nth, int w) {
  const CrcGeometry g = crc_geometry(nth, w);
  const int64_t cw = (4 * static_cast<int64_t>(consts_words(nth)) + 15) & ~int64_t(15);
  return cw + 2 * static_cast<int64_t>(g.buf) + 4 * static_cast<int64_t>(nth) + 4 * 8 + 16;
}

// Shared memory: the constants, the even and odd rounds' buffers, the tree's
// nodes (a word a thread), the warps' results and the combined X.
struct CrcLayout {
  uint32_t* c;    // the constants
  uint8_t* in;    // round j's buffer at in + (j & 1) * buf
  uint32_t* node;
  uint32_t* wsum;
  uint32_t* x;
};

HBT_W_HD HBT_W_INLINE CrcLayout crc_carve(uint8_t* smem, const CrcGeometry& g) {
  CrcLayout L;
  const int64_t cw = (4 * static_cast<int64_t>(consts_words(g.nth)) + 15) & ~int64_t(15);
  L.c = reinterpret_cast<uint32_t*>(smem);
  L.in = smem + cw;
  L.node = reinterpret_cast<uint32_t*>(L.in + 2 * static_cast<int64_t>(g.buf));
  L.wsum = L.node + g.nth;
  L.x = L.wsum + 8;
  return L;
}

// The constants into shared memory, thread tid of nth.
HBT_W_HD inline void load_consts(const CrcLayout& L, const uint32_t* consts, int words, int tid,
                                 int nth) {
  for (int i = tid; i < words; i += nth) L.c[i] = consts[i];
}

// The register after a 32-bit word (4 bytes, the first in bits 0-7).
HBT_W_HD HBT_W_INLINE uint32_t step_word(const uint32_t* T, uint32_t c, uint32_t x) {
  c ^= x;
  return T[768 + (c & 0xFFu)] ^ T[512 + ((c >> 8) & 0xFFu)] ^ T[256 + ((c >> 16) & 0xFFu)] ^
         T[c >> 24];
}

HBT_W_HD HBT_W_INLINE uint32_t step_byte(const uint32_t* T, uint32_t c, uint32_t b) {
  return (c >> 8) ^ T[(c ^ b) & 0xFFu];
}

// A^n(c): n zero bytes fed to the register.
HBT_W_HD inline uint32_t shift_bytes(const uint32_t* T, uint32_t c, int32_t n) {
  for (; n >= 4; n -= 4) c = step_word(T, c, 0);
  for (; n > 0; --n) c = step_byte(T, c, 0);
  return c;
}

// A^(R - w)(c), the round's shift.
HBT_W_HD HBT_W_INLINE uint32_t round_shift(const uint32_t* C, uint32_t c) {
  const uint32_t* t = C + kRoundAt;
  return t[c & 0xFFu] ^ t[256 + ((c >> 8) & 0xFFu)] ^ t[512 + ((c >> 16) & 0xFFu)] ^
         t[768 + (c >> 24)];
}

// A^(2^k w)(c), tree level k's shift.
HBT_W_HD HBT_W_INLINE uint32_t level_shift(const uint32_t* C, int k, uint32_t c) {
  const uint32_t* t = C + kLevelAt + kLevelWords * k;
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r ^= t[16 * j + ((c >> (4 * j)) & 15u)];
  return r;
}

// A member's bytes at base-relative position p: zeros before h, the first
// four complemented when inv.
HBT_W_HD HBT_W_INLINE uint32_t head_byte(uint32_t b, int64_t p, int32_t h, bool inv) {
  if (p < h) return 0;
  return inv && p < h + 4 ? b ^ 0xFFu : b;
}

HBT_W_HD HBT_W_INLINE uint32_t head_word(uint32_t x, int64_t p, int32_t h, bool inv) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) r |= head_byte((x >> (8 * i)) & 0xFFu, p + i, h, inv) << (8 * i);
  return r;
}

// Fold n bytes of a staged piece (16-byte aligned in shared memory) that
// starts at base-relative position ps into register c.
HBT_W_HD inline uint32_t fold(const uint32_t* T, const uint8_t* piece, int64_t ps, int32_t n,
                              uint32_t c, int32_t h, bool inv) {
  int32_t o = 0;
  if (ps < h + 4) {  // the member's first bytes: round 0, piece 0 (or 1 when w = 16)
    for (; o + 4 <= n && ps + o < h + 4; o += 4)
      c = step_word(T, c, head_word(load32(piece + o), ps + o, h, inv));
    if (ps + o < h + 4)
      for (; o < n; ++o) c = step_byte(T, c, head_byte(piece[o], ps + o, h, inv));
  }
  for (; o + 4 <= n && (o & 15); o += 4) c = step_word(T, c, load32(piece + o));
  for (; o + 16 <= n; o += 16) {
    uint32_t v[4];
    load16(v, piece + o);
    c = step_word(T, c, v[0]);
    c = step_word(T, c, v[1]);
    c = step_word(T, c, v[2]);
    c = step_word(T, c, v[3]);
  }
  for (; o + 4 <= n; o += 4) c = step_word(T, c, load32(piece + o));
  for (; o < n; ++o) c = step_byte(T, c, piece[o]);
  return c;
}

// One member: stream[off .. off + len) of a stream of numel bytes.
struct CrcMember {
  const uint8_t* stream;
  int64_t numel;
  int64_t off;
  int64_t len;
  uint32_t* out;
};

// Where the member lies in rounds: its first byte h bytes past base (a
// 16-byte boundary), its end at base-relative E, J rounds, the last byte in
// piece tE of the last round, rE bytes of it.
struct CrcPlan {
  uintptr_t base;
  int32_t h, tE, rE, J;
  int64_t E;
};

HBT_W_HD HBT_W_INLINE CrcPlan crc_plan(const CrcMember& m, const CrcGeometry& g) {
  CrcPlan p;
  const uintptr_t a = reinterpret_cast<uintptr_t>(m.stream) + static_cast<uintptr_t>(m.off);
  p.base = a & ~static_cast<uintptr_t>(15);
  p.h = static_cast<int32_t>(a - p.base);
  p.E = p.h + m.len;
  p.J = static_cast<int32_t>((p.E + g.R - 1) / g.R);
  const int64_t last = (p.J - 1) * g.R;
  p.tE = static_cast<int32_t>((p.E - 1 - last) >> (g.wshift + 4));
  p.rE = static_cast<int32_t>(p.E - last - static_cast<int64_t>(p.tE) * g.w);
  return p;
}

// Stage round j, thread tid of nth: 16-byte chunk c of the round (at
// base-relative jR + 16c) to piece c / (w / 16) of the round's buffer.
// Chunks at or past the member's end are not read; a chunk that crosses
// either end of the stream is read a byte at a time (the member's bytes).
HBT_W_HD inline void crc_stage(const CrcMember& m, const CrcGeometry& g, const CrcLayout& L,
                               const CrcPlan& p, int32_t j, int tid, int nth) {
  uint8_t* buf = L.in + (j & 1) * static_cast<int64_t>(g.buf);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(m.stream);
  const uintptr_t hi = lo + static_cast<uintptr_t>(m.numel);
  const int32_t chunks = static_cast<int32_t>(g.R >> 4), per = g.w >> 4;
  for (int32_t c = tid; c < chunks; c += nth) {
    const int64_t q = j * g.R + 16 * static_cast<int64_t>(c);
    if (q >= p.E) break;
    uint8_t* d = buf + (c >> g.wshift) * g.pitch + ((c & (per - 1)) << 4);
    const uintptr_t a = p.base + static_cast<uintptr_t>(q);
    if (a >= lo && a + 16 <= hi) {
      HBT_W_READ(a, 16);
      copy16_async(d, reinterpret_cast<const uint8_t*>(a));
    } else {
      for (int b = 0; b < 16; ++b) {
        const int64_t at = q + b;
        if (at >= p.h && at < p.E) HBT_W_READ(a + b, 1);
        d[b] = at >= p.h && at < p.E ? *reinterpret_cast<const uint8_t*>(a + b) : 0;
      }
    }
  }
}

// Thread tid's node in the tree: u = (tE - 1 - tid) mod nth.
HBT_W_HD HBT_W_INLINE int node_of(int tid, int tE, int nth) {
  const int u = tE - 1 - tid;
  return u < 0 ? u + nth : u;
}

// The combined X = sum over u of A^(u w)(node u), thread 0's on the device.
#ifdef __CUDA_ARCH__
__device__ inline uint32_t tree(const CrcGeometry& g, const CrcLayout& L, uint32_t v, int tE) {
  const int tid = threadIdx.x, nth = g.nth, lane = tid & 31, warp = tid >> 5;
  L.node[node_of(tid, tE, nth)] = v;
  __syncthreads();
  v = L.node[tid];
  const int in_warp = nth < 32 ? nth : 32;
  int k = 0;
  for (; (1 << k) < in_warp; ++k) {
    const uint32_t o = __shfl_down_sync(0xFFFFFFFFu, v, 1 << k);
    if ((lane & ((2 << k) - 1)) == 0) v ^= level_shift(L.c, k, o);
  }
  if (nth > 32) {
    if (lane == 0) L.wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      const int nw = nth >> 5;
      v = lane < nw ? L.wsum[lane] : 0u;
      for (int s = 0; (1 << s) < nw; ++s, ++k) {
        const uint32_t o = __shfl_down_sync(0xFFFFFFFFu, v, 1 << s);
        if ((lane & ((2 << s) - 1)) == 0) v ^= level_shift(L.c, k, o);
      }
    }
  }
  return v;
}
#else
// The same tree with the threads as loops: node u + 2^k joins node u at
// level k, as the shuffles do within a warp and warp 0 across the warps
// (nodes past nth are zero).  At most 512 threads.
inline uint32_t tree(const CrcGeometry& g, const CrcLayout& L, const uint32_t* acc, int tE) {
  const int nth = g.nth;
  int n = 1;
  while (n < nth) n <<= 1;
  uint32_t v[512];
  for (int u = 0; u < n; ++u) v[u] = 0;
  for (int t = 0; t < nth; ++t) v[node_of(t, tE, nth)] = acc[t];
  for (int k = 0; (1 << k) < n; ++k)
    for (int u = 0; u + (1 << k) < n; u += 2 << k) v[u] ^= level_shift(L.c, k, v[u + (1 << k)]);
  return v[0];
}
#endif

// One member's CRC32 (zlib's) to *m.out, by the block.  acc: on the host,
// one register a thread (the device keeps each in a register).
HBT_W_HD inline void crc_member(const CrcMember& m, const CrcGeometry& g, const CrcLayout& L,
                                uint32_t* acc) {
  const int nth = g.nth;
  if (m.len == 0) {
    HBT_W_EACH(tid, nth) {
      if (tid == 0) *m.out = 0;
    }
    return;
  }
  const CrcPlan p = crc_plan(m, g);
  const bool inv = m.len >= 4;
#ifdef __CUDA_ARCH__
  uint32_t mine = 0;
#define HBT_W_ACC(tid) mine
  (void)acc;
#else
  for (int t = 0; t < nth; ++t) acc[t] = 0;
#define HBT_W_ACC(tid) acc[tid]
#endif
  uint32_t last = 0;  // the last piece's f (thread tE's)
  HBT_W_EACH(tid, nth) crc_stage(m, g, L, p, 0, tid, nth);
  for (int32_t j = 0; j < p.J; ++j) {
    wait_copies();
    HBT_W_SYNC();
    HBT_W_EACH(tid, nth) {
      if (j + 1 < p.J) crc_stage(m, g, L, p, j + 1, tid, nth);
    }
    HBT_W_EACH(tid, nth) {
      const int64_t ps = j * g.R + static_cast<int64_t>(tid) * g.w;
      const uint8_t* piece = L.in + (j & 1) * static_cast<int64_t>(g.buf) + tid * g.pitch;
      if (j + 1 == p.J && tid == p.tE) {
        last = fold(L.c, piece, ps, p.rE, 0, p.h, inv);
      } else if (ps < p.E) {
        uint32_t& a = HBT_W_ACC(tid);
        a = fold(L.c, piece, ps, g.w, j ? round_shift(L.c, a) : a, p.h, inv);
      }
    }
  }
#ifdef __CUDA_ARCH__
  const uint32_t X = tree(g, L, mine, p.tE);
  if (threadIdx.x == 0) *L.x = X;
  __syncthreads();
#else
  *L.x = tree(g, L, acc, p.tE);
#endif
#undef HBT_W_ACC
  HBT_W_EACH(tid, nth) {
    if (tid == p.tE) {
      uint32_t crc = shift_bytes(L.c, *L.x, p.rE) ^ last;
      if (!inv) crc ^= shift_bytes(L.c, 0xFFFFFFFFu, static_cast<int32_t>(m.len));
      *m.out = crc ^ 0xFFFFFFFFu;
    }
  }
  HBT_W_SYNC();
}

// ---------------------------------------------------------------------------
// Gather.

struct GatherArgs {
  const uint8_t* stream;
  int64_t numel;
  const int64_t* src;      // record r's first byte in the stream
  const int32_t* lens;     // its bytes
  const int32_t* dst_end;  // the output's bytes up to the end of record r
  const uint8_t* dup;      // null, or 1 where record r's flag is patched
  int64_t n;
  uint32_t lo, hi;         // the patch: ORed into bytes 18 and 19
  uint8_t* out;            // 16-byte aligned
  int64_t total;
  const int32_t* tile_first;
  int32_t tile;            // bytes a tile, a multiple of 16
  int64_t tiles;
};

// Record r's tiles: tile_first[b] = r for every tile b whose first byte lies
// in r (a record of 0 bytes holds none).
HBT_W_HD inline void tile_first_of(const GatherArgs& a, int32_t* tile_first, int64_t r) {
  const int64_t de = a.dst_end[r], ds = de - a.lens[r];
  for (int64_t b = (ds + a.tile - 1) / a.tile; b * a.tile < de; ++b)
    tile_first[b] = static_cast<int32_t>(r);
}

// The first record in [lo, hi] whose destination ends past pos.
HBT_W_HD HBT_W_INLINE int64_t first_past(const int32_t* dst_end, int64_t lo, int64_t hi,
                                          int64_t pos) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (dst_end[mid] > pos) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// The 16 bytes of block [q, q + 16) that lie in [need_lo, need_hi), the
// rest zero: one aligned 16-byte load when the block lies in the stream,
// else a byte at a time.
HBT_W_HD HBT_W_INLINE void source_block(uint32_t v[4], uintptr_t q, uintptr_t need_lo,
                                        uintptr_t need_hi, uintptr_t lo, uintptr_t hi) {
  if (q >= lo && q + 16 <= hi) {
    HBT_W_READ(q, 16);
    load16(v, reinterpret_cast<const uint8_t*>(q));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = 0;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const uintptr_t at = q + b;
    if (at >= need_lo && at < need_hi) {
      HBT_W_READ(at, 1);
      v[b >> 2] |= static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(at)) << (8 * (b & 3));
    }
  }
}

// Bytes [a0, b0) of a 16-byte chunk as a mask on word j.
HBT_W_HD HBT_W_INLINE uint32_t byte_mask(int32_t a0, int32_t b0, int j) {
  const int32_t s = a0 - 4 * j, e = b0 - 4 * j;
  const uint32_t upto = e >= 4 ? 0xFFFFFFFFu : e <= 0 ? 0u : (1u << (8 * e)) - 1u;
  const uint32_t from = s <= 0 ? 0xFFFFFFFFu : s >= 4 ? 0u : ~((1u << (8 * s)) - 1u);
  return upto & from;
}

// Output chunk [p, p + 16) (p a multiple of 16 below total), from the
// records of [r, r_hi]: r, the thread's record so far, moves to the
// chunk's last record.
HBT_W_HD inline void gather_chunk(const GatherArgs& a, int64_t p, int64_t& r, int64_t r_hi) {
  uint32_t acc[4] = {0, 0, 0, 0};
  const uintptr_t lo = reinterpret_cast<uintptr_t>(a.stream);
  const uintptr_t hi = lo + static_cast<uintptr_t>(a.numel);
  const int64_t cend = p + 16 < a.total ? p + 16 : a.total;
  int64_t pos = p;
  if (a.dst_end[r] <= pos) r = first_past(a.dst_end, r + 1, r_hi, pos);
  for (;;) {
    const int64_t de = a.dst_end[r];
    const int32_t ln = a.lens[r];
    const int64_t ds = de - ln;
    const int32_t a0 = static_cast<int32_t>(pos - p);
    const int32_t b0 = static_cast<int32_t>((de < cend ? de : cend) - p);
    // Output byte k of the chunk comes from virtual source byte vabs + k.
    const uintptr_t vabs = lo + static_cast<uintptr_t>(a.src[r] + (pos - ds)) - a0;
    const uintptr_t q0 = vabs & ~static_cast<uintptr_t>(15);
    const uint32_t d = static_cast<uint32_t>(vabs - q0);
    uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (static_cast<uint32_t>(a0) + d < 16u)
      source_block(v, q0, vabs + a0, vabs + b0, lo, hi);
    if (static_cast<uint32_t>(b0) + d > 16u)
      source_block(v + 4, q0 + 16, vabs + a0, vabs + b0, lo, hi);
    const uint32_t e = d >> 2, sh = 8 * (d & 3);
    uint32_t s[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      s[i] = e & 2 ? (e & 1 ? v[i + 3] : v[i + 2]) : (e & 1 ? v[i + 1] : v[i]);
    if (a0 == 0 && b0 == 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = funnel_r(s[j], s[j + 1], sh);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] |= funnel_r(s[j], s[j + 1], sh) & byte_mask(a0, b0, j);
    }
    if (a.dup != nullptr && a.dup[r] != 0) {
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int64_t k = ds + 18 + f - p;
        if (ln > 18 + f && k >= a0 && k < b0) {
          const uint32_t bit = (f ? a.hi : a.lo) << (8 * (k & 3));
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] |= j == (k >> 2) ? bit : 0u;
        }
      }
    }
    pos = p + b0;
    if (pos >= cend) break;
    ++r;
    if (a.dst_end[r] <= pos) r = first_past(a.dst_end, r, r_hi, pos);
  }
  if (cend == p + 16) {
    store16(a.out + p, acc);
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (p + b < cend) a.out[p + b] = static_cast<uint8_t>(acc[b >> 2] >> (8 * (b & 3)));
  }
}

// Tile b, thread tid of nth: a run of k consecutive chunks (k = the
// tile's chunks over nth, rounded up) from the tile's records [r_lo, r_hi]
// (from the tile map), each chunk starting at the record the one before
// ended in.
HBT_W_HD inline void gather_tile(const GatherArgs& a, int64_t b, int tid, int nth) {
  const int64_t r_hi = b + 1 < a.tiles ? a.tile_first[b + 1] : a.n - 1;
  const int64_t t0 = b * a.tile, t1 = t0 + a.tile < a.total ? t0 + a.tile : a.total;
  const int64_t k = ((a.tile >> 4) + nth - 1) / nth;
  const int64_t p0 = t0 + 16 * k * tid, p1 = p0 + 16 * k < t1 ? p0 + 16 * k : t1;
  int64_t r = a.tile_first[b];
  for (int64_t p = p0; p < p1; p += 16) gather_chunk(a, p, r, r_hi);
}

}  // namespace hbt_write
