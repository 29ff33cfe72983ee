// The decoder core of csrc/inflate.cu: one raw DEFLATE member, decoded by
// one warp (the device) or one thread (a host build with g++, which the CPU
// tests use to hold this core to zlib).
//
// Everything a lane does goes through the functions below with its lane
// number and the lane count (32 on the device, 1 on the host); HBT_SYNC()
// is __syncwarp() on the device and nothing on the host.  Lane 0 runs the
// serial part, step(): the bit window, block headers, code-length
// decoding, symbol decoding through the root tables, literals and short
// copies, and every verdict.  step() stops whenever the warp has work and
// leaves it in Shared::cmd:
//
//   kCmdBuildCl / kCmdBuildLd  build a block's tables (build());
//   kCmdStored                 copy a stored block's payload;
//   kCmdExec                   end a round: apply its copy tokens in order,
//                              then write its output to `out`;
//   kCmdDone                   the member's verdict.
//
// Tables.  Each code gets a root table of 2^bits packed entries (10 bits
// for literal/length codes, 8 for distance codes, 7 for the code-length
// code): entry = code length | extra bits << 4 | kind << 8 | value << 16,
// kind one of literal, copy (value = base length or distance), EOB,
// invalid, or long.  Entry idx is the canonical walk of idx's bits (walk()),
// so a lookup gives exactly what the bit-by-bit walk gives; where only a
// code longer than the root can match, the entry is "long" and the decoder
// resumes the walk past the root's bits (walk_long()).  Unused codes of an
// accepted incomplete set (zlib's lone length-1 code), and the fixed codes
// of literal/length symbols 286-287 and distance symbols 30-31, are
// "invalid" and reject the member.
//
// zlib's verdicts, each kept: a bad BTYPE, bad stored LEN/NLEN, an
// over-subscribed code, an incomplete code other than a lone length-1
// literal/length or distance code, an incomplete code-length code, more
// than 286/30 codes, a missing end-of-block code, a repeat with nothing to
// repeat or past the code count, an invalid symbol, a distance before the
// member start, output past isize, reading past clen, and n_out != isize
// after the final block.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define HBT_HD __host__ __device__
#define HBT_INLINE __forceinline__
#define HBT_UNROLL _Pragma("unroll")
#else
#define HBT_HD
#define HBT_INLINE inline
#define HBT_UNROLL
#endif

// A branch the hot loops rarely take, laid out of their straight line.  Any
// branch on freshly loaded data stalls a lone warp about as long as a
// dependent shared-memory load, so the hot loops take as few as they can.
#define HBT_UNLIKELY(x) __builtin_expect(!!(x), 0)

#ifdef __CUDA_ARCH__
#define HBT_SYNC() __syncwarp()
#else
#define HBT_SYNC() ((void)0)
#endif

namespace hbt_inflate {

constexpr int kMaxBits = 15;
constexpr int kMaxLCodes = 286;
constexpr int kMaxDCodes = 30;
constexpr int kFixLCodes = 288;
constexpr int kLitRoot = 10;
constexpr int kDistRoot = 8;
constexpr int kClRoot = 7;
constexpr int kTokens = 128;  // LZ77 copies a kCmdExec carries at most
// The member's last kWin output bytes, a ring in shared memory; older ones are
// in `out` already.  A round of decoding writes at most kWin bytes.
constexpr int32_t kWin = 16384;
constexpr int32_t kWinMask = kWin - 1;

// Entry kinds and alphabets.
constexpr uint32_t kLit = 0, kCopy = 1, kEob = 2, kBad = 3, kLong = 4;
constexpr int kAlphaCl = 0, kAlphaLit = 1, kAlphaDist = 2;
// Copy token flags: it reads an earlier copy of its round, so it waits for
// them; it is short (len <= 32 and len <= dist: one step of the warp).
constexpr uint32_t kAfter = 1u << 31;
constexpr uint32_t kShort = 1u << 30;
// Warp commands.
constexpr int kCmdExec = 0, kCmdStored = 1, kCmdBuildCl = 2, kCmdBuildLd = 3, kCmdDone = 4;
// step()'s states.
constexpr int kHeader = 0, kClLengths = 1, kCheckLd = 2, kCodes = 3, kFinal = 4;

// ---------------------------------------------------------------------------
// Warp primitives, plain on the host.

HBT_HD HBT_INLINE void copy16(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

HBT_HD HBT_INLINE void add_count(int32_t* p) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, 1);
#else
  ++*p;
#endif
}

// The lanes of this lane's chunk holding the same value (the host: itself).
HBT_HD HBT_INLINE uint32_t peers_of(int v) {
#ifdef __CUDA_ARCH__
  return __match_any_sync(0xffffffffu, v);
#else
  (void)v;
  return 1u;
#endif
}

HBT_HD HBT_INLINE int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// ---------------------------------------------------------------------------
// Symbols and tables.

HBT_HD HBT_INLINE uint32_t entry(uint32_t kind, uint32_t len, uint32_t extra, uint32_t value) {
  return len | extra << 4 | kind << 8 | value << 16;
}

// RFC 1951 3.2.5: base and extra bits of length symbols 257-285 and
// distance symbols 0-29, by formula (the tables kLenBase/kLenExtra and
// kDistBase/kDistExtra of zlib and of the reference).
HBT_HD HBT_INLINE uint32_t symbol_entry(int alpha, int sym, int len) {
  if (alpha == kAlphaCl) return entry(kLit, len, 0, sym);
  if (alpha == kAlphaLit) {
    if (sym < 256) return entry(kLit, len, 0, sym);
    if (sym == 256) return entry(kEob, len, 0, 0);
    const int c = sym - 257;
    if (c < 8) return entry(kCopy, len, 0, c + 3);
    if (c < 28) {
      const int x = (c - 4) >> 2;
      return entry(kCopy, len, x, ((((c - 4) & 3) | 4) << x) + 3);
    }
    if (c == 28) return entry(kCopy, len, 0, 258);
    return entry(kBad, len, 0, 0);
  }
  if (sym < 4) return entry(kCopy, len, 0, sym + 1);
  if (sym < kMaxDCodes) {
    const int x = (sym - 2) >> 1;
    return entry(kCopy, len, x, (((sym & 1) | 2) << x) + 1);
  }
  return entry(kBad, len, 0, 0);
}

// The order of the code-length code's lengths: 16, 17, 18, 0, 8, 7, 9, 6,
// 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15.
HBT_HD HBT_INLINE int clc_order(int k) {
  if (k < 3) return 16 + k;
  if (k == 3) return 0;
  const int j = k - 4;
  return (j & 1) ? 7 - (j >> 1) : 8 + (j >> 1);
}

// Canonical Huffman code: count[len] codes of each length and the symbols
// in canonical order; offs[] is build()'s placement cursor.
struct Huffman {
  int32_t count[kMaxBits + 1];
  int32_t root_first;  // walk()'s first and index past the root table's bits
  int32_t root_index;
  int16_t offs[kMaxBits + 1];
  int16_t symbol[kFixLCodes];
};

// The canonical walk over b's low bits, one bit a length, from length
// `from` up to maxlen; `miss` when no code of those lengths matches.  code,
// first and index are the walk's state on entry (0, 0, 0 from length 1).
HBT_HD HBT_INLINE uint32_t walk(uint64_t b, const Huffman* h, int alpha, int from, int code,
                                int first, int index, int maxlen, uint32_t miss) {
  for (int len = from; len <= maxlen; ++len) {
    code |= static_cast<int>(b & 1u);
    b >>= 1;
    const int c = h->count[len];
    if (code - c < first) return symbol_entry(alpha, h->symbol[index + (code - first)], len);
    index += c;
    first += c;
    first <<= 1;
    code <<= 1;
  }
  return miss;
}

// The low n bits of x reversed.
HBT_HD HBT_INLINE uint32_t reverse_bits(uint32_t x, int n) {
#ifdef __CUDA_ARCH__
  return __brev(x) >> (32 - n);
#else
  uint32_t r = 0;
  for (int k = 0; k < n; ++k) r |= ((x >> k) & 1u) << (n - 1 - k);
  return r;
#endif
}

// walk() of a code longer than the root table's `bits`, resumed where the
// root left off: the first `bits` bits matched no code.
HBT_HD HBT_INLINE uint32_t walk_long(uint64_t b, const Huffman* h, int alpha, int bits) {
  const int code = static_cast<int>(reverse_bits(static_cast<uint32_t>(b) & ((1u << bits) - 1u),
                                                 bits));
  return walk(b >> bits, h, alpha, bits + 1, code << 1, h->root_first, h->root_index, kMaxBits,
              entry(kBad, 0, 0, 0));
}

// zlib's table rules over length[0 .. n), built by the lanes together:
// the histogram with shared atomics, the canonical order with match-any
// ranks (32 symbols a round), the root table on a stride.  Returns 0 for a
// complete set (or an all-zero one, which fails only when a code is used),
// > 0 for an incomplete set, < 0 for an over-subscribed one (then the
// table is not filled).  Every lane returns the same verdict.
HBT_HD HBT_INLINE int build(Huffman* h, uint32_t* root, int bits, const int16_t* length, int n,
                            int alpha, int lane, int nlanes) {
  for (int k = lane; k <= kMaxBits; k += nlanes) h->count[k] = 0;
  HBT_SYNC();
  for (int s = lane; s < n; s += nlanes) add_count(&h->count[length[s]]);
  HBT_SYNC();
  int left = 1;
  for (int len = 1; len <= kMaxBits && left >= 0; ++len) left = (left << 1) - h->count[len];
  const int verdict = h->count[0] == n ? 0 : left;
  if (verdict < 0) return verdict;
  for (int len = 1 + lane; len <= kMaxBits; len += nlanes) {
    int o = 0;
    for (int l = 1; l < len; ++l) o += h->count[l];
    h->offs[len] = static_cast<int16_t>(o);
  }
  HBT_SYNC();
  for (int base = 0; base < n; base += nlanes) {
    const int s = base + lane;
    const int len = s < n ? length[s] : 0;
    const uint32_t peers = peers_of(len);
    const int rank = popc(peers & ((1u << lane) - 1u));
    if (len) h->symbol[h->offs[len] + rank] = static_cast<int16_t>(s);
    HBT_SYNC();
    if (len && rank == 0) h->offs[len] = static_cast<int16_t>(h->offs[len] + popc(peers));
    HBT_SYNC();
  }
  if (lane == 0) {
    int first = 0, index = 0;
    for (int len = 1; len <= bits; ++len) {
      index += h->count[len];
      first = (first + h->count[len]) << 1;
    }
    h->root_first = first;
    h->root_index = index;
  }
  bool longer = false;
  for (int len = bits + 1; len <= kMaxBits; ++len) longer |= h->count[len] != 0;
  const uint32_t miss = entry(longer ? kLong : kBad, 0, 0, 0);
  for (int idx = lane; idx < (1 << bits); idx += nlanes)
    root[idx] = walk(static_cast<uint64_t>(idx), h, alpha, 1, 0, 0, 0, bits, miss);
  HBT_SYNC();
  return verdict;
}

// The one incomplete set zlib accepts: a single code, of length 1.
HBT_HD HBT_INLINE bool lone_code(const Huffman* h, int n) {
  return n - h->count[0] == 1 && h->count[1] == 1;
}

// ---------------------------------------------------------------------------
// Bit window: the next nb bits of the stream in (lo, hi), LSB first, nb in
// 65..128 after refill(), so four literal codes or a whole length/distance
// pair (<= 48 bits) come from lo without a refill in between.  refill()
// appends one aligned 8-byte word when nb <= 64: a branch once per 64 bits,
// where a branch on freshly decoded data stalls a lone warp.
// The member is read in place through a ring of kRing words in shared
// memory, which asynchronous copies (cp.async) fill kAhead words ahead of
// use: a load into a register would stall the decoder at the first move of
// that register, for as long as device memory takes.  Bytes past clen read
// as 0; reading past clen is detected from the bits consumed.

constexpr int kRing = 32;
constexpr int kAhead = 16;

// Copy 8 bytes from global to shared memory without holding a register, as
// one group of asynchronous copies (an empty group when !copy).
HBT_HD HBT_INLINE void fetch8(bool copy, uint64_t* dst, const uint64_t* src) {
#ifdef __CUDA_ARCH__
  if (copy) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
#else
  if (copy) memcpy(dst, src, 8);
#endif
}

// Until at most the last kPending groups are in flight.
template <int kPending>
HBT_HD HBT_INLINE void fetch_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
#endif
}

struct Reader {
  const uint64_t* words;  // the member's first byte, rounded down to 8
  uint64_t* ring;         // word k at ring[k % kRing]
  int64_t end_bits;       // bit position (from words) just past the member
  int32_t last;           // the last word holding member bytes (-1: none)
  uint64_t last_mask;
  uint64_t lo, hi;  // the next nb bits; bits past nb are 0
  int32_t nb;
  int32_t q;  // the next word to append; words q .. q + kAhead - 1 requested

  // One group a word, empty past the member, so that the waits count words.
  HBT_HD HBT_INLINE void request(int32_t k) {
    fetch8(k <= last, ring + (k & (kRing - 1)), words + (k <= last ? k : 0));
  }
  HBT_HD HBT_INLINE void refill() {
    if (nb > 64) return;
    fetch_wait<kAhead - 1>();  // word q has landed
    uint64_t v = ring[q & (kRing - 1)];
    v = q < last ? v : q == last ? v & last_mask : 0ull;
    lo |= nb < 64 ? v << (nb & 63) : 0ull;
    hi |= nb > 0 ? v >> ((64 - nb) & 63) : 0ull;
    nb += 64;
    ++q;
    request(q + kAhead - 1);
  }
  HBT_HD HBT_INLINE void seek(int64_t bit) {
    fetch_wait<0>();  // no copy of an earlier position in flight
    q = static_cast<int32_t>(bit >> 6);
    for (int k = 0; k < kAhead; ++k) request(q + k);
    lo = hi = 0;
    nb = 0;
    refill();
    refill();
    skip(static_cast<int>(bit & 63));
  }
  HBT_HD HBT_INLINE void init(const uint8_t* src, int32_t clen, uint64_t* ring_words) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const int32_t lead = static_cast<int32_t>(a & 7);
    words = reinterpret_cast<const uint64_t*>(a - lead);
    ring = ring_words;
    const int64_t end = static_cast<int64_t>(lead) + (clen > 0 ? clen : 0);
    end_bits = end * 8;
    last = static_cast<int32_t>((end - 1) >> 3);
    const int valid = static_cast<int>(end - 8 * static_cast<int64_t>(last));  // 1..8
    last_mask = valid >= 8 ? ~0ull : (1ull << (8 * valid)) - 1ull;
    if (end == lead) last = -1;
    seek(8 * static_cast<int64_t>(lead));
  }
  // The next 64 bits, all valid.
  HBT_HD HBT_INLINE uint64_t peek() {
    refill();
    return lo;
  }
  // k < 64, k <= nb.
  HBT_HD HBT_INLINE void skip(int k) {
    lo = (lo >> k) | ((hi << 1) << (63 - k));
    hi >>= k;
    nb -= k;
  }
  // k <= 32.
  HBT_HD HBT_INLINE uint32_t take(int k) {
    const uint32_t v = static_cast<uint32_t>(peek() & ((1ull << k) - 1ull));
    skip(k);
    return v;
  }
  HBT_HD HBT_INLINE int64_t pos() const { return static_cast<int64_t>(q) * 64 - nb; }
  HBT_HD HBT_INLINE bool overrun() const { return pos() > end_bits; }
};

// ---------------------------------------------------------------------------
// Shared state of one member's warp, and lane 0's decoder.

struct Cmd {
  int32_t kind;
  int32_t n;      // copies (kCmdExec), payload bytes (kCmdStored), n_out (kCmdDone)
  int32_t dst;    // kCmdExec: the round's first byte; kCmdStored: output offset; kCmdDone: ok
  int32_t end;    // kCmdExec: the round's end (the ring holds [end - kWin, end))
  int32_t nlen;   // kCmdBuildLd: literal/length codes
  int32_t ndist;  // kCmdBuildLd: distance codes
  const uint8_t* src;  // kCmdStored: the payload
};

struct Shared {
  uint32_t lit[1 << kLitRoot];
  uint32_t dist[1 << kDistRoot];  // also the code-length code's root table
  Huffman lh;                     // also the code-length code
  Huffman dh;
  int16_t lengths[kFixLCodes + kMaxDCodes + 2];
  uint32_t tok_pos[kTokens];
  uint32_t tok_info[kTokens];  // kAfter | kShort | length << 16 | distance
  uint64_t ring[kRing];        // the member's stream, Reader's ring
  int32_t verdict[2];          // build()'s, literal/length and distance
  uint8_t sink[8];             // stores step() discards
  Cmd cmd;
};

struct Core {
  Reader in;
  uint8_t* ring;  // output byte p at ring[p & kWinMask]
  uint8_t* gout;  // the member's place in out
  int32_t isize;
  int32_t o;        // bytes produced
  int32_t flushed;  // bytes in out: the current round's first
  int32_t state;
  bool last;
  bool fixed;  // the tables hold the fixed codes
};

HBT_HD HBT_INLINE void init(Core& c, Shared* sh, const uint8_t* src, int32_t clen,
                            int32_t isize, uint8_t* ring, uint8_t* gout) {
  c.in.init(src, clen, sh->ring);
  c.ring = ring;
  c.gout = gout;
  c.isize = isize;
  c.o = 0;
  c.flushed = 0;
  c.state = clen > 0 ? kHeader : kFinal;
  c.last = false;
  c.fixed = false;
}

HBT_HD HBT_INLINE void done(Core& c, Cmd& cmd, bool ok) {
  cmd.kind = kCmdDone;
  cmd.n = c.o;
  cmd.dst = ok && c.last && c.o == c.isize;
  c.state = kFinal;
}

// Ends the round: the warp applies its tokens and writes it to out.
HBT_HD HBT_INLINE void end_round(Core& c, Cmd& cmd, int32_t o, int nt) {
  cmd.kind = kCmdExec;
  cmd.n = nt;
  cmd.dst = c.flushed;
  cmd.end = o;
  c.o = o;
  c.flushed = o;
}

// Lane 0: decode until the warp has work, and leave it in sh->cmd.
HBT_HD HBT_INLINE void step(Core& c, Shared* sh) {
  Cmd& cmd = sh->cmd;
  Reader& in = c.in;
  for (;;) {
    if (c.state == kFinal) return done(c, cmd, true);
    if (c.state == kHeader) {
      if (c.last) return done(c, cmd, true);
      c.last = in.take(1) != 0;
      const uint32_t type = in.take(2);
      if (type == 0) {
        in.skip(in.nb & 7);  // to a byte boundary
        const uint32_t len = in.take(16);
        const uint32_t nlen = in.take(16);
        if (len != (~nlen & 0xffffu) || in.overrun()) return done(c, cmd, false);
        if (static_cast<int32_t>(len) > c.isize - c.o) return done(c, cmd, false);
        const int64_t at = in.pos();
        if (at + 8 * static_cast<int64_t>(len) > in.end_bits) return done(c, cmd, false);
        cmd.kind = kCmdStored;
        cmd.n = static_cast<int32_t>(len);
        cmd.dst = c.o;
        cmd.src = reinterpret_cast<const uint8_t*>(in.words) + at / 8;
        in.seek(at + 8 * static_cast<int64_t>(len));
        c.o += static_cast<int32_t>(len);
        c.flushed = c.o;  // the warp writes the payload to out and the ring
        return;
      }
      if (type == 1) {
        c.state = kCodes;
        if (c.fixed) continue;
        for (int s = 0; s < kFixLCodes; ++s)
          sh->lengths[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
        for (int s = 0; s < kMaxDCodes; ++s) sh->lengths[kFixLCodes + s] = 5;
        c.fixed = true;
        cmd.kind = kCmdBuildLd;
        cmd.nlen = kFixLCodes;
        cmd.ndist = kMaxDCodes;
        return;  // the fixed codes' verdicts are not read
      }
      if (type == 2) {
        const int nlen = static_cast<int>(in.take(5)) + 257;
        const int ndist = static_cast<int>(in.take(5)) + 1;
        const int ncode = static_cast<int>(in.take(4)) + 4;
        if (nlen > kMaxLCodes || ndist > kMaxDCodes) return done(c, cmd, false);
        for (int k = 0; k < 19; ++k) sh->lengths[k] = 0;
        for (int k = 0; k < ncode; ++k) sh->lengths[clc_order(k)] = static_cast<int16_t>(in.take(3));
        c.fixed = false;
        c.state = kClLengths;
        cmd.kind = kCmdBuildCl;
        cmd.nlen = nlen;
        cmd.ndist = ndist;
        return;
      }
      return done(c, cmd, false);
    }
    if (c.state == kClLengths) {
      if (sh->verdict[0] != 0) return done(c, cmd, false);
      const int nlen = cmd.nlen, total = cmd.nlen + cmd.ndist;
      int index = 0;
      while (index < total) {
        const uint32_t e = sh->dist[in.peek() & ((1u << kClRoot) - 1u)];
        if (((e >> 8) & 7) == kBad) return done(c, cmd, false);
        in.skip(e & 15);
        const int sym = static_cast<int>(e >> 16);
        if (sym < 16) {
          sh->lengths[index++] = static_cast<int16_t>(sym);
          continue;
        }
        int16_t len = 0;
        int rep;
        if (sym == 16) {
          if (index == 0) return done(c, cmd, false);
          len = sh->lengths[index - 1];
          rep = 3 + static_cast<int>(in.take(2));
        } else if (sym == 17) {
          rep = 3 + static_cast<int>(in.take(3));
        } else {
          rep = 11 + static_cast<int>(in.take(7));
        }
        if (index + rep > total) return done(c, cmd, false);
        while (rep--) sh->lengths[index++] = len;
      }
      if (in.overrun() || sh->lengths[256] == 0) return done(c, cmd, false);
      c.state = kCheckLd;
      cmd.kind = kCmdBuildLd;
      cmd.nlen = nlen;
      return;
    }
    if (c.state == kCheckLd) {
      const int vl = sh->verdict[0], vd = sh->verdict[1];
      if (vl < 0 || (vl > 0 && !lone_code(&sh->lh, cmd.nlen))) return done(c, cmd, false);
      if (vd < 0 || (vd > 0 && !lone_code(&sh->dh, cmd.ndist))) return done(c, cmd, false);
      c.state = kCodes;
      continue;
    }
    // kCodes: literals and short copies go straight to the ring, other
    // copies to the tokens.  A copy reads only final bytes when its source
    // lies outside [first_pending, copy_end), the span of the round's tokens.
    int nt = 0;
    int32_t o = c.o;
    int32_t first_pending = o;
    int32_t copy_end = o;
    const uint32_t* lit = sh->lit;
    uint8_t* const ring = c.ring;
    const uint8_t* const gout = c.gout;
    const int32_t isize = c.isize;
    // The round's output ends at `limit`: isize, or kWin bytes on.
    const int32_t limit = static_cast<int32_t>(
        static_cast<int64_t>(isize) < static_cast<int64_t>(o) + kWin ? isize : o + kWin);
    constexpr uint32_t kLitMask = (1u << kLitRoot) - 1u;
    for (;;) {
      // Literal runs, four a pass and one branch a pass (a branch on freshly
      // loaded data stalls a lone warp): four codes of
      // <= 15 bits chain through one 64-bit peek, each literal is kept while
      // every symbol before it was a literal that fit, and the pass repeats
      // only when all four were.
      uint32_t e;
      for (;;) {
        const uint64_t b = in.peek();
        const uint32_t e1 = lit[b & kLitMask];
        const int s1 = e1 & 15;
        const uint32_t e2 = lit[(b >> s1) & kLitMask];
        const int s2 = s1 + (e2 & 15);
        const uint32_t e3 = lit[(b >> s2) & kLitMask];
        const int s3 = s2 + (e3 & 15);
        const uint32_t e4 = lit[(b >> s3) & kLitMask];
        const int s4 = s3 + (e4 & 15);
        const int32_t room = limit - o;
        const bool k1 = ((e1 & 0x700u) == 0) & (room > 0);
        const bool k2 = k1 & ((e2 & 0x700u) == 0) & (room > 1);
        const bool k3 = k2 & ((e3 & 0x700u) == 0) & (room > 2);
        const bool k4 = k3 & ((e4 & 0x700u) == 0) & (room > 3);
        if (k1) ring[o & kWinMask] = static_cast<uint8_t>(e1 >> 16);
        if (k2) ring[(o + 1) & kWinMask] = static_cast<uint8_t>(e2 >> 16);
        if (k3) ring[(o + 2) & kWinMask] = static_cast<uint8_t>(e3 >> 16);
        if (k4) ring[(o + 3) & kWinMask] = static_cast<uint8_t>(e4 >> 16);
        in.skip(k4 ? s4 : k3 ? s3 : k2 ? s2 : k1 ? s1 : 0);
        o += static_cast<int32_t>(k1) + k2 + k3 + k4;
        if (HBT_UNLIKELY(!k4)) {
          e = k1 ? (k2 ? (k3 ? e4 : e3) : e2) : e1;
          break;
        }
      }
      // One symbol, e (looked up from in.lo: the skip above only dropped the
      // literals kept, and a refill only appends): anything but a literal.
      const uint64_t b = in.peek();
      if (HBT_UNLIKELY((e & 0x700u) != kCopy << 8)) {
        if ((e & 0x700u) == kLong << 8) e = walk_long(b, &sh->lh, kAlphaLit, kLitRoot);
        const uint32_t kind = (e >> 8) & 7;
        if (kind == kLit) {
          if (o >= isize) break;
          if (o >= limit) return end_round(c, cmd, o, nt);  // decoded again next round
          ring[o++ & kWinMask] = static_cast<uint8_t>(e >> 16);
          in.skip(e & 15);
          continue;
        }
        if (kind == kEob) {
          in.skip(e & 15);
          if (in.overrun()) {
            c.o = o;
            return done(c, cmd, false);
          }
          c.state = kHeader;
          return end_round(c, cmd, o, nt);
        }
        if (kind != kCopy) break;
      }
      // A length/distance pair: <= 48 bits, all in b.
      const int ll = e & 15, lx = (e >> 4) & 15;
      const int len = static_cast<int>(e >> 16) + static_cast<int>((b >> ll) & ((1u << lx) - 1u));
      const uint64_t bd = b >> (ll + lx);
      uint32_t d = sh->dist[bd & ((1u << kDistRoot) - 1u)];
      int dl = d & 15, dx = (d >> 4) & 15;
      int dist = static_cast<int>(d >> 16) + static_cast<int>((bd >> dl) & ((1u << dx) - 1u));
      if (HBT_UNLIKELY(((d & 0x700u) != kCopy << 8) | (dist > o) | (len > limit - o))) {
        if ((d & 0x700u) == kLong << 8) {
          d = walk_long(bd, &sh->dh, kAlphaDist, kDistRoot);
          dl = d & 15;
          dx = (d >> 4) & 15;
          dist = static_cast<int>(d >> 16) + static_cast<int>((bd >> dl) & ((1u << dx) - 1u));
        }
        if (((d & 0x700u) != kCopy << 8) | (dist > o) | (len > isize - o)) break;
        if (len > limit - o) return end_round(c, cmd, o, nt);  // decoded again next round
      }
      // A short copy (one warp step, its source before its target) is done
      // here, byte loads before byte stores; the warp applies the others as
      // tokens.  A short copy that reads a pending token ends the round
      // first, and is decoded again in the next.
      const int32_t from = o - dist;
      const bool alone = (nt == 0) | (from + (dist < len ? dist : len) <= first_pending) |
                         (from >= copy_end);
      const bool inline_copy = (len <= 8) & (dist >= len);
      if (HBT_UNLIKELY(inline_copy & !alone)) return end_round(c, cmd, o, nt);
      in.skip(ll + lx + dl + dx);
      // The ring holds [o - kWin, o); older bytes are in out.  Loads past len
      // are harmless, and stores past it go to a sink: no branch a byte.
      uint8_t v[8];
      HBT_UNROLL
      for (int k = 0; k < 8; ++k) v[k] = ring[(from + k) & kWinMask];
      if (HBT_UNLIKELY(inline_copy & (dist > kWin))) {
        HBT_UNROLL
        for (int k = 0; k < 8; ++k)
          if (k < len) v[k] = gout[from + k];
      }
      HBT_UNROLL
      for (int k = 0; k < 8; ++k)
        *(inline_copy & (k < len) ? ring + ((o + k) & kWinMask) : sh->sink + k) = v[k];
      sh->tok_pos[nt] = static_cast<uint32_t>(o);
      sh->tok_info[nt] = (alone ? 0u : kAfter) | (len <= 32 && len <= dist ? kShort : 0u) |
                         static_cast<uint32_t>(len) << 16 | static_cast<uint32_t>(dist);
      first_pending = inline_copy | (nt > 0) ? first_pending : o;
      o += len;
      copy_end = inline_copy ? copy_end : o;
      nt += inline_copy ? 0 : 1;
      if (HBT_UNLIKELY(nt == kTokens)) return end_round(c, cmd, o, nt);
    }
    c.o = o;
    return done(c, cmd, false);
  }
}

// All lanes: src[0 .. n) to dst[0 .. n), where src and dst agree modulo 16:
// bytes up to dst's first 16-byte boundary, 16-byte stores, the tail.
HBT_HD HBT_INLINE void copy_out(uint8_t* dst, const uint8_t* src, int32_t n, int lane,
                                int nlanes) {
  int32_t head = static_cast<int32_t>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
  if (head > n) head = n;
  for (int32_t k = lane; k < head; k += nlanes) dst[k] = src[k];
  const int32_t nvec = (n - head) >> 4;
  for (int32_t v = lane; v < nvec; v += nlanes) copy16(dst + head + 16 * v, src + head + 16 * v);
  for (int32_t k = head + 16 * nvec + lane; k < n; k += nlanes) dst[k] = src[k];
}

// Output byte q while the ring holds [top - kWin, top).
HBT_HD HBT_INLINE uint8_t out_byte(const uint8_t* ring, const uint8_t* gout, int32_t q,
                                   int32_t top) {
  return q >= top - kWin ? ring[q & kWinMask] : gout[q];
}

// All lanes: the warp's part of a command.
HBT_HD HBT_INLINE void run(const Cmd& cmd, Shared* sh, uint8_t* ring, uint8_t* gout, int lane,
                           int nlanes) {
  if (cmd.kind == kCmdExec) {
    const uint32_t* pos = sh->tok_pos;
    const uint32_t* info = sh->tok_info;
    const int32_t top = cmd.end;
    for (int t = 0; t < cmd.n;) {
      const uint32_t i0 = info[t];
      if (i0 & kAfter) HBT_SYNC();  // it reads an earlier copy of the round
      if (t + 4 <= cmd.n) {
        // Four short copies whose last three read no copy of the round: all
        // loads first, then the stores.
        const uint32_t i1 = info[t + 1], i2 = info[t + 2], i3 = info[t + 3];
        if ((i0 & i1 & i2 & i3 & kShort) && !((i1 | i2 | i3) & kAfter)) {
          const int32_t p0 = pos[t], p1 = pos[t + 1], p2 = pos[t + 2], p3 = pos[t + 3];
          const int32_t f0 = p0 - static_cast<int32_t>(i0 & 0xffffu);
          const int32_t f1 = p1 - static_cast<int32_t>(i1 & 0xffffu);
          const int32_t f2 = p2 - static_cast<int32_t>(i2 & 0xffffu);
          const int32_t f3 = p3 - static_cast<int32_t>(i3 & 0xffffu);
          const int l0 = (i0 >> 16) & 0x1ff, l1 = (i1 >> 16) & 0x1ff;
          const int l2 = (i2 >> 16) & 0x1ff, l3 = (i3 >> 16) & 0x1ff;
          for (int k = lane; k < 32; k += nlanes) {
            const uint8_t v0 = k < l0 ? out_byte(ring, gout, f0 + k, top) : 0;
            const uint8_t v1 = k < l1 ? out_byte(ring, gout, f1 + k, top) : 0;
            const uint8_t v2 = k < l2 ? out_byte(ring, gout, f2 + k, top) : 0;
            const uint8_t v3 = k < l3 ? out_byte(ring, gout, f3 + k, top) : 0;
            if (k < l0) ring[(p0 + k) & kWinMask] = v0;
            if (k < l1) ring[(p1 + k) & kWinMask] = v1;
            if (k < l2) ring[(p2 + k) & kWinMask] = v2;
            if (k < l3) ring[(p3 + k) & kWinMask] = v3;
          }
          t += 4;
          continue;
        }
      }
      const int len = static_cast<int>((i0 >> 16) & 0x1ffu);
      const int dist = static_cast<int>(i0 & 0xffffu);
      const int32_t p = pos[t], from = p - dist;
      // out[p + k] = out[p - dist + (k mod dist)]: every source byte lies
      // before p, so overlapping copies are exact.
      if (dist >= len) {
        for (int k = lane; k < len; k += nlanes)
          ring[(p + k) & kWinMask] = out_byte(ring, gout, from + k, top);
      } else {
        const int step = nlanes % dist;
        int j = lane % dist;
        for (int k = lane; k < len; k += nlanes) {
          ring[(p + k) & kWinMask] = out_byte(ring, gout, from + j, top);
          j += step;
          if (j >= dist) j -= dist;
        }
      }
      ++t;
    }
    // The round to out, in pieces that do not wrap the ring.
    HBT_SYNC();
    for (int32_t a = cmd.dst; a < cmd.end;) {
      const int32_t b = (a | kWinMask) + 1 < cmd.end ? (a | kWinMask) + 1 : cmd.end;
      copy_out(gout + a, ring + (a & kWinMask), b - a, lane, nlanes);
      a = b;
    }
  } else if (cmd.kind == kCmdStored) {
    // Straight to out, and its last kWin bytes to the ring.
    for (int32_t k = lane; k < cmd.n; k += nlanes) {
      const uint8_t v = cmd.src[k];
      gout[cmd.dst + k] = v;
      if (k >= cmd.n - kWin) ring[(cmd.dst + k) & kWinMask] = v;
    }
  } else if (cmd.kind == kCmdBuildCl) {
    const int v = build(&sh->lh, sh->dist, kClRoot, sh->lengths, 19, kAlphaCl, lane, nlanes);
    if (lane == 0) sh->verdict[0] = v;
  } else if (cmd.kind == kCmdBuildLd) {
    const int vl = build(&sh->lh, sh->lit, kLitRoot, sh->lengths, cmd.nlen, kAlphaLit, lane,
                         nlanes);
    const int vd = build(&sh->dh, sh->dist, kDistRoot, sh->lengths + cmd.nlen, cmd.ndist,
                         kAlphaDist, lane, nlanes);
    if (lane == 0) {
      sh->verdict[0] = vl;
      sh->verdict[1] = vd;
    }
  }
}

struct Result {
  int32_t n_out;
  bool ok;
};

// One member, by all lanes: its output goes to gout[0 .. n_out), through
// `ring` (kWin bytes, at the same address as gout modulo 16).
HBT_HD HBT_INLINE Result run_member(Shared* sh, uint8_t* ring, uint8_t* gout, const uint8_t* src,
                                    int32_t clen, int32_t isize, int lane, int nlanes) {
  Core c;
  if (lane == 0) init(c, sh, src, clen, isize, ring, gout);
  for (;;) {
    if (lane == 0) step(c, sh);
    HBT_SYNC();
    const Cmd cmd = sh->cmd;
    if (cmd.kind == kCmdDone) {
      if (lane == 0) fetch_wait<0>();  // no copy may land in the next CTA's ring
      return Result{cmd.n, cmd.dst != 0};
    }
    run(cmd, sh, ring, gout, lane, nlanes);
    HBT_SYNC();
  }
}

}  // namespace hbt_inflate
