// The lane walk of csrc/inflate_probe.cu: one lane's T waves of the
// lockstep-walk probe, with the words under its cursor kept in a per-lane
// ring in shared memory, filled ahead by 4-byte asynchronous copies.  The
// device runs walk_lane with a thread a lane; a host build with g++ runs the
// same function for each lane in turn, the copies landing where the
// harness's HBT_PR_COPY / HBT_PR_COMMIT / HBT_PR_WAIT say, which the CPU
// tests hold to the plain version.
//
// What it computes is ops/kernels/inflate_probe.py (walk_plain): from an
// int32 cursor c over an int32 stream column (a word outside [0, R) reads
// as 0), each wave takes the 32-bit window at c (widx = c >> 5, arithmetic,
// shifted by c & 31 over the next word), classifies its low 15 bits into a
// length L of 1-15 (the smallest L whose range compare holds, else 15),
// adds L + (window & 7) to c and the window to a checksum, both wrapping as
// int32.
//
// A wave advances the cursor by 1-22 bits, so the word under it moves by at
// most one a wave and the words a lane will read are known many waves
// ahead.  The lane keeps 64 bits of the stream from its cursor on in two
// registers (lo, the window, and hi), three words from the one holding the
// bit after hi (u0, u1, u2), and reads the word after those (x) from its
// ring of K words, slot s at ring[s * stride] (stride = the block's lanes,
// so a warp's lanes read 32 consecutive banks).  Waves run in blocks of W:
// at a block's start the lane issues one group of copies that fills its
// ring up to K words past its read position (S(W) copies, those it has no
// room for going to a spare slot, so that no branch is taken), then waits
// until at most D of its groups are in flight.  A block reads at most S(W - 1) + 1 ring words
// and moves the read position by at most S(W), where S(m) = (31 + 22m) / 32
// is the most words m waves can cross, so K > S(W - 1) + D * S(W) means
// every word a block reads landed in a group issued D blocks earlier, and
// no copy overwrites a slot before it is read.  A wave is then
//
//   x = ring[read slot];  next = window(u0, u1, c)  (the 32 bits after hi);
//   adv = L(lo) + (lo & 7);  acc += lo;  c += adv;
//   lo = window(lo, hi, adv);  hi = window(hi, next, adv);
//   if (the cursor crossed a word) { u0 <- u1 <- u2 <- x; read slot += 1 }
//
// so that the dependent chain is the length class and one funnel shift:
// the 64 bits shift down by adv and take adv bits of next in at the top.
// next, the words and the ring read depend on the cursor, but what they
// feed is needed a wave or more later, and the copies are off the chain too.
// L + (rev & 7) is one byte of a 32 KiB table over the 15 bits, built by
// the block at launch from class_mask.
//
// The ring follows word indices from a base set when the lane syncs; a
// block that could carry the cursor past INT32_MAX (where widx jumps from
// 2^26 - 1 to -2^26) runs its waves on the words read directly instead, and
// the next block syncs anew.  Every wave is a wave: none is skipped, also
// where both words read 0.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define HBT_PR_HD __host__ __device__
#define HBT_PR_INLINE __forceinline__
#else
#define HBT_PR_HD
#define HBT_PR_INLINE inline
#endif

// The asynchronous copies: 4 bytes from device memory into a ring slot
// (zeros when src_bytes is 0), one group of them closed, and a wait until
// at most n groups of this thread are in flight.  A host build may define
// its own before including this file; else a host copy lands at once.
#ifdef __CUDA_ARCH__
#define HBT_PR_COPY(dst, src, src_bytes)                                                   \
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(                      \
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),                  \
               "l"(src), "r"(src_bytes)                                                    \
               : "memory")
#define HBT_PR_COMMIT() asm volatile("cp.async.commit_group;" ::: "memory")
#define HBT_PR_WAIT(n) asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory")
#elif !defined(HBT_PR_COPY)
#define HBT_PR_COPY(dst, src, src_bytes) \
  (*(dst) = (src_bytes) != 0 ? static_cast<uint32_t>(*(src)) : 0u)
#define HBT_PR_COMMIT() ((void)0)
#define HBT_PR_WAIT(n) ((void)0)
#endif

namespace hbt_probe {

constexpr int kLanes = 128;          // the stream's columns
constexpr int kTableBytes = 1 << 15;  // the length-class table, a byte per 15-bit window
constexpr int kMaxAdv = 22;          // the most a wave advances the cursor: L 15, win & 7 = 7

// The most word boundaries m waves can cross.
HBT_PR_HD constexpr int crossings(int m) { return (31 + kMaxAdv * m) / 32; }

HBT_PR_HD HBT_PR_INLINE uint32_t funnel_r(uint32_t lo, uint32_t hi, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, s);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(hi) << 32 | lo) >> (s & 31));
#endif
}

HBT_PR_HD HBT_PR_INLINE uint32_t clz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return static_cast<uint32_t>(__clz(static_cast<int>(x)));
#else
  return static_cast<uint32_t>(__builtin_clz(x));
#endif
}

// The length class's compares for the 15-bit window rev as bits: bit 31 - L
// holds (rev >> (15 - L)) < ((rev >> 7) & 0x7F) + L for L = 1..14, and bit
// 16 (L = 15) is always set, so the count of leading zeros is the smallest L
// whose compare holds, else 15.  The compares are independent of each other.
HBT_PR_HD HBT_PR_INLINE uint32_t class_mask(uint32_t rev) {
  const uint32_t bar = (rev >> 7) & 0x7F;
  uint32_t m = 1u << 16;
#pragma unroll
  for (int L = 1; L <= 14; ++L) m |= static_cast<uint32_t>((rev >> (15 - L)) < bar + L) << (31 - L);
  return m;
}

// Thread tid of nth's share of the table: four entries a 32-bit word.  The
// compares shift rev right by at least 1 bit, so rev and rev + 1 (rev even)
// share their length class.
HBT_PR_HD HBT_PR_INLINE void build_table(uint8_t* tab, int tid, int nth) {
  uint32_t* words = reinterpret_cast<uint32_t*>(tab);
  for (int i = tid; i < kTableBytes / 4; i += nth) {
    const uint32_t rev = 4u * static_cast<uint32_t>(i), low = rev & 7;
    const uint32_t l0 = clz32(class_mask(rev)), l2 = clz32(class_mask(rev + 2));
    words[i] = (l0 + low) | (l0 + low + 1) << 8 | (l2 + low + 2) << 16 | (l2 + low + 3) << 24;
  }
}

// One lane's T waves from cursor c; col is the lane's column (word w at
// col[w * kLanes]), ring its slot 0 (slot s at ring[s * stride]; K slots
// and a spare one, slot K, which copies that are not needed write and
// nothing reads), tab the table.  Waves in blocks of W, at most D groups of
// copies in flight when a block starts.
template <int K, int W, int D>
HBT_PR_HD HBT_PR_INLINE void walk_lane(const int32_t* col, int R, uint32_t c, int T,
                                       const uint8_t* tab, uint32_t* ring, int stride,
                                       int32_t* cur_out, int32_t* acc_out) {
  static_assert(K > crossings(W - 1) + D * crossings(W), "a block may read a word not landed");
  const auto word = [&](int w) -> uint32_t {
    return static_cast<uint32_t>(w) < static_cast<uint32_t>(R)
               ? static_cast<uint32_t>(col[static_cast<long long>(w) * kLanes])
               : 0u;
  };
  const auto advance = [&](uint32_t win) -> uint32_t { return tab[win & 0x7FFF]; };
  // lo and hi hold the stream's bits from the cursor on (lo is the window),
  // u0, u1, u2 three words from the one holding the bit after hi.
  uint32_t acc = 0, lo = 0, hi = 0, u0 = 0, u1 = 0, u2 = 0;
  // The ring follows word base + i at slot i % K; nr is the next word to
  // read, nf the next to fill.
  int base = 0;
  uint32_t nr = 0, nf = 0;
  // Copy word base + nf into its slot if the ring has room for it, else
  // into the spare slot (zeros), without a branch.
  const auto copy_next = [&]() {
    const bool fits = nf < nr + K;
    const int w = base + static_cast<int>(nf);
    const bool inside = fits && static_cast<uint32_t>(w) < static_cast<uint32_t>(R);
    const int32_t* src = inside ? col + static_cast<long long>(w) * kLanes : col;
    HBT_PR_COPY(&ring[(fits ? nf % K : K) * stride], src, inside ? 4u : 0u);
    nf += fits ? 1u : 0u;
  };
  const auto wave = [&]() {
    const uint32_t x = ring[(nr % K) * stride];
    const uint32_t room = 31 - (c & 31);
    const uint32_t next = funnel_r(u0, u1, c);  // the 32 bits after hi
    const uint32_t adv = advance(lo);
    acc += lo;
    c += adv;
    const uint32_t window = funnel_r(lo, hi, adv);
    hi = funnel_r(hi, next, adv);
    lo = window;
    const bool step = adv > room;
    u0 = step ? u1 : u0;
    u1 = step ? u2 : u1;
    u2 = step ? x : u2;
    nr += step ? 1u : 0u;
  };
  // A block's copies: the ring was full when the last block started and
  // that block read at most crossings(W) words, so as many copies fill it.
  const auto fill = [&]() {
#pragma unroll
    for (int i = 0; i < crossings(W); ++i) copy_next();
    HBT_PR_COMMIT();
    HBT_PR_WAIT(D);
  };
  bool synced = false;
  for (int left = T; left > 0;) {
    if (static_cast<int>(c) > 0x7FFFFFFF - kMaxAdv * W) {
      // The cursor may wrap in this block: its waves read the words directly.
      const int n = left < W ? left : W;
      for (int i = 0; i < n; ++i) {
        const int widx = static_cast<int>(c) >> 5;
        const uint32_t v = funnel_r(word(widx), word(widx + 1), c);
        acc += v;
        c += advance(v);
      }
      left -= n;
      synced = false;
      continue;
    }
    if (!synced) {
      HBT_PR_WAIT(0);
      const int widx = static_cast<int>(c) >> 5;
      const uint32_t w1 = word(widx + 1);
      u0 = word(widx + 2);
      u1 = word(widx + 3);
      u2 = word(widx + 4);
      lo = funnel_r(word(widx), w1, c);
      hi = funnel_r(w1, u0, c);
      base = widx + 5;
      nr = nf = 0;
      for (int i = 0; i < K; ++i) copy_next();
      HBT_PR_COMMIT();
      HBT_PR_WAIT(0);
      synced = true;
    }
    if (left < W) {
      fill();
      for (int i = 0; i < left; ++i) wave();
      break;
    }
    // Whole blocks that cannot carry the cursor past INT32_MAX.
    const uint32_t safe = (static_cast<uint32_t>(0x7FFFFFFF - kMaxAdv * W) - c) / (kMaxAdv * W) + 1;
    const int blocks = static_cast<uint32_t>(left / W) < safe ? left / W : static_cast<int>(safe);
    for (int b = 0; b < blocks; ++b) {
      fill();
#pragma unroll
      for (int i = 0; i < W; ++i) wave();
    }
    left -= blocks * W;
  }
  HBT_PR_WAIT(0);
  *cur_out = static_cast<int32_t>(c);
  *acc_out = static_cast<int32_t>(acc);
}

}  // namespace hbt_probe
