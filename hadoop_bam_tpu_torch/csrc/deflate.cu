// Greedy LZ77 + fixed-Huffman DEFLATE of BGZF member payloads for Hopper
// (sm_90a): one CTA per member.
//
// Replaces the TPU kernel hadoop_bam_tpu/ops/pallas/deflate_lanes.py
// (_kernel_factory and _launch, pl.pallas_call at :328) together with the
// XLA programs that finish its work there: the ragged token compaction
// (_compact_tokens, :373) and the fixed-Huffman bit pack
// (_emit_tokens_fixed, :412).  The TPU kernel walks 128 members in
// lockstep, one per vector lane, reads "4 bytes at my cursor" as one-hot
// row selects over a transposed word layout, streams int32 tokens to HBM
// chunk by chunk and packs the bits afterwards with a per-output-bit
// searchsorted.  None of that carries over: here each member gets its own
// CTA, and one thread walks it and writes the DEFLATE bits as it decides
// each token, so no token array exists.
//
// Per member (the sequential function the lockstep waves compute):
//   1. the CTA stages the payload into shared memory with 16-byte loads and
//      zeroes the two hash-head generations h1/h2 (2^hb int32 slots each);
//   2. thread 0 walks the payload.  Scan step at cur (not in a match):
//      wa = LE word at cur; if cur + 4 <= plen, h = (wa * 0x9E3779B1) >>
//      (32 - hb), candidates c1 = h1[h] - 1 and c2 = h2[h] - 1, then
//      h2[h] = h1[h], h1[h] = cur + 1; a candidate matches when it is >= 0,
//      at most 32 KiB back and its word equals wa (c1 first).  A match
//      extends 0-4 bytes per step (leading equal bytes of the next words,
//      capped by plen and 258) until a step adds fewer than 4; then the copy
//      (mlen, cur - mpos) is emitted and cur jumps past it.  No position
//      inside a match enters the hash heads.  Otherwise the literal byte is
//      emitted.
//   3. bits: BFINAL=1, BTYPE=01, RFC 1951 fixed codes (literal 8/9 bits,
//      length 7/8 bits + extra, 5-bit distance + extra), EOB; meta
//      clens[i] = ceil(bits / 8), ok[i] = (cur == plen).
// Bytes at or past plen read as 0; they never change a decision (every
// comparison is capped at plen).
//
// Bound on this card: bytes (payload in, compressed bytes out) over
// 3.35 TB/s.  This first design is far from it: the walk is one dependent
// chain of shared-memory loads per input byte on one thread per member, and
// latency is hidden only by the members in flight (about 74 KiB of shared
// memory per full-size member, so three CTAs per SM).  Splitting a member's
// match search across a warp is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 4;
constexpr int kMaxMatch = 258;
constexpr int kMaxDist = 1 << 15;
constexpr int kThreads = 128;

__constant__ uint16_t kLenBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
    31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ uint8_t kLenExtra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
    2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ uint16_t kDistBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
    193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
    12289, 16385, 24577};
__constant__ uint8_t kDistExtra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// LSB-first bit writer straight into the member's output row.
struct BitSink {
  uint8_t* out;
  int32_t pos;  // bytes written
  uint64_t acc;
  int n;  // bits pending in acc, < 32 between calls

  // k <= 31.
  __device__ void put(uint32_t bits, int k) {
    acc |= static_cast<uint64_t>(bits) << n;
    n += k;
    if (n >= 32) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[pos + j] = static_cast<uint8_t>(acc >> (8 * j));
      pos += 4;
      acc >>= 32;
      n -= 32;
    }
  }
  __device__ int32_t finish() {
    while (n > 0) {
      out[pos++] = static_cast<uint8_t>(acc);
      acc >>= 8;
      n -= 8;
    }
    return pos;
  }
};

// Little-endian 32 bits at staged byte p (any alignment).
__device__ __forceinline__ uint32_t word_at(const uint32_t* s32, int p) {
  const int w = p >> 2;
  return __funnelshift_r(s32[w], s32[w + 1], (p & 3) * 8);
}

// MSB-first Huffman code of n bits as the LSB-first stream pattern.
__device__ __forceinline__ uint32_t rev(uint32_t code, int n) {
  return __brev(code) >> (32 - n);
}

__device__ __forceinline__ void put_literal(BitSink& bs, uint32_t v) {
  if (v < 144) bs.put(rev(0x30 + v, 8), 8);
  else bs.put(rev(0x190 + (v - 144), 9), 9);
}

// Length 4..258, distance 1..32768: one pattern of at most 31 bits.
__device__ __forceinline__ void put_copy(BitSink& bs, int len, int dist) {
  int li;
  if (len == kMaxMatch) {
    li = 28;
  } else {
    const int l = len - 3;
    const int nb = 31 - __clz(l);
    li = l < 8 ? l : 4 * (nb - 1) + ((l >> (nb - 2)) & 3);
  }
  const int ln = li <= 22 ? 7 : 8;
  const uint32_t lcode = li <= 22 ? static_cast<uint32_t>(li + 1)
                                  : static_cast<uint32_t>(0xC0 + (li - 23));
  const int e1 = kLenExtra[li];
  const int d = dist - 1;
  const int db = 31 - __clz(d | 1);
  const int di = d < 4 ? d : 2 * db + ((d >> (db - 1)) & 1);
  const int e2 = kDistExtra[di];
  const uint32_t bits = rev(lcode, ln)
                        | (static_cast<uint32_t>(len - kLenBase[li]) << ln)
                        | (rev(static_cast<uint32_t>(di), 5) << (ln + e1))
                        | (static_cast<uint32_t>(dist - kDistBase[di]) << (ln + e1 + 5));
  bs.put(bits, ln + e1 + 5 + e2);
}

__global__ void __launch_bounds__(kThreads)
deflate_members_kernel(const uint8_t* __restrict__ stream, int64_t n_stream,
                       const int64_t* __restrict__ offs,
                       const int32_t* __restrict__ lens, int hb,
                       int64_t out_stride, uint8_t* __restrict__ comp,
                       int32_t* __restrict__ clens, int32_t* __restrict__ ok) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int H = 1 << hb;
  int32_t* h1 = reinterpret_cast<int32_t*>(smem);
  int32_t* h2 = h1 + H;
  uint8_t* staged = smem + 8 * H;  // 16-byte aligned: H >= 256

  const int64_t i = blockIdx.x;
  const int32_t plen = lens[i];

  // 1. Stage [offs, offs + plen) with 16-byte loads from the aligned base;
  //    vectors that reach outside the stream fall back to byte loads.
  const uintptr_t lo = reinterpret_cast<uintptr_t>(stream);
  const uintptr_t hi = lo + static_cast<uintptr_t>(n_stream);
  const uintptr_t src = lo + static_cast<uintptr_t>(offs[i]);
  const uintptr_t base = src & ~uintptr_t(15);
  const int lead = static_cast<int>(src - base);
  const int nvec = plen > 0 ? (lead + plen + 15) / 16 : 0;
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    h1[k] = 0;
    h2[k] = 0;
  }
  uint4* vdst = reinterpret_cast<uint4*>(staged);
  for (int k = threadIdx.x; k < nvec; k += blockDim.x) {
    const uintptr_t a = base + 16 * static_cast<uintptr_t>(k);
    if (a >= lo && a + 16 <= hi) {
      vdst[k] = *reinterpret_cast<const uint4*>(a);
    } else {
      for (int j = 0; j < 16; ++j) {
        const uintptr_t b = a + j;
        staged[16 * k + j] = (b >= lo && b < hi) ? *reinterpret_cast<const uint8_t*>(b) : 0;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int j = 0; j < 8; ++j) staged[lead + plen + j] = 0;

  // 2. Walk and emit.
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(staged);
  BitSink bs{comp + i * out_stride, 0, 0ull, 0};
  bs.put(3, 3);  // BFINAL = 1, BTYPE = 01 (fixed Huffman)
  const int shift = 32 - hb;
  int32_t cur = 0;
  while (cur < plen) {
    const int p = lead + cur;
    const uint32_t wa = word_at(s32, p);
    if (cur + kMinMatch <= plen) {
      const uint32_t h = (wa * 0x9E3779B1u) >> shift;
      const int32_t s1 = h1[h];
      const int32_t s2 = h2[h];
      h2[h] = s1;
      h1[h] = cur + 1;
      const int32_t c1 = s1 - 1;
      const int32_t c2 = s2 - 1;
      int32_t mpos = -1;
      if (c1 >= 0 && cur - c1 <= kMaxDist && word_at(s32, lead + c1) == wa) {
        mpos = c1;
      } else if (c2 >= 0 && cur - c2 <= kMaxDist && word_at(s32, lead + c2) == wa) {
        mpos = c2;
      }
      if (mpos >= 0) {
        int32_t mlen = kMinMatch;
        for (;;) {
          const uint32_t x = word_at(s32, p + mlen) ^ word_at(s32, lead + mpos + mlen);
          const int nm = x == 0 ? 4 : (__ffs(static_cast<int>(x)) - 1) >> 3;
          const int add = max(min(nm, min(plen - (cur + mlen), kMaxMatch - mlen)), 0);
          mlen += add;
          if (add < 4) break;
        }
        put_copy(bs, mlen, cur - mpos);
        cur += mlen;
        continue;
      }
    }
    put_literal(bs, wa & 0xFFu);
    cur += 1;
  }
  bs.put(0, 7);  // end of block: code 256 is seven zero bits

  // 3. Meta.
  clens[i] = bs.finish();
  ok[i] = cur == plen ? 1 : 0;
}

}  // namespace

extern "C" {

// Compress n members.  Member i's payload is stream[offs[i] .. + lens[i])
// of a stream of n_stream bytes; its DEFLATE member goes to
// comp[i * out_stride ..], which the caller zeroes, and meta to clens[i],
// ok[i].  stage_bytes >= 16 * ceil((15 + max lens + 16) / 16); hb is the
// hash-head width (8..11).  Returns the CUDA error code of the launch.
int hbt_deflate_members(const void* stream, long long n_stream,
                        const void* offs, const void* lens, long long n,
                        int hb, int stage_bytes, long long out_stride,
                        void* comp, void* clens, void* ok, void* cuda_stream) {
  if (n <= 0) return 0;
  const int smem = 8 * (1 << hb) + stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      deflate_members_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  deflate_members_kernel<<<static_cast<unsigned>(n), kThreads, smem,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream), static_cast<int64_t>(n_stream),
      static_cast<const int64_t*>(offs), static_cast<const int32_t*>(lens), hb,
      static_cast<int64_t>(out_stride), static_cast<uint8_t*>(comp),
      static_cast<int32_t*>(clens), static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
