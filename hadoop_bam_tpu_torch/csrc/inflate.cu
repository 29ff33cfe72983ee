// BGZF member inflate for Hopper (sm_90a): one CTA per member.
//
// Replaces the TPU kernel hadoop_bam_tpu/ops/pallas/inflate_lanes.py
// (_kernel_factory, _launch and the host replay _apply_far_copies).  The
// TPU kernel walks 128 members in lockstep, one per vector lane, streams
// its output through a 32 KiB ring in VMEM and defers far LZ77 copies to a
// host pass.  None of that carries over: here every member gets its own
// CTA of one warp, the grid is the split's member count (one launch per
// split), and the member's whole output lives in device memory, so LZ77
// copies read straight back from it and no ring or far-copy ledger exists.
//
// Per member:
//   1. the warp stages the member's compressed DEFLATE bytes into shared
//      memory with coalesced 16-byte loads (a BGZF member is < 64 KiB);
//   2. lane 0 decodes the bit stream serially: stored, fixed and dynamic
//      blocks, canonical Huffman tables rebuilt in shared memory for each
//      block with zlib's completeness rules (the TPU kernel's _kraft_ok:
//      over-subscribed and incomplete sets are rejected, except a lone
//      length-1 code for the literal/length and distance alphabets);
//   3. lane 0 writes meta[i] = {n_out, ok}.
//
// ok = 0 on a bad BTYPE, bad stored LEN/NLEN, an over-subscribed or
// incomplete code, a missing end-of-block code, a repeat with nothing to
// repeat or past the code count, a distance before the member start, output
// past isize, reading past clen, or n_out != isize at the final block.
// The caller re-decodes such members on the host (a member tier-down),
// which is also the verdict zlib gives.
//
// Caps not kept: the TPU kernel's max_blocks=12, its VMEM budget and its
// max_far far-copy budget.  They existed only for the lockstep geometry and
// only ever turned valid members into tier-downs.
//
// Bound on this card: (compressed bytes + output bytes) / 3.35 TB/s.  The
// kernel is far from it: it is latency-bound on the serial bit walk of one
// thread per member, and it hides that latency only by keeping many
// members in flight (one 32-thread CTA per member, up to the shared-memory
// limit per SM).  Warp-parallel decoding is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBits = 15;
constexpr int kMaxLCodes = 286;
constexpr int kMaxDCodes = 30;
constexpr int kFixLCodes = 288;

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
__constant__ uint8_t kClcOrder[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// Canonical Huffman decoding table: count[len] codes of each length and the
// symbols in canonical order.
struct Huffman {
  int16_t count[kMaxBits + 1];
  int16_t symbol[kFixLCodes];
};

// LSB-first bit reader over the staged member.  Bytes past clen read as 0;
// reading past clen is detected from the bits consumed, not the bits loaded.
struct BitReader {
  const uint8_t* in;
  int32_t n;    // clen
  int32_t pos;  // next byte to load
  uint64_t buf;
  int32_t cnt;  // valid bits in buf

  __device__ void fill() {
    while (cnt <= 56) {
      const uint64_t b = pos < n ? in[pos] : 0u;
      ++pos;
      buf |= b << cnt;
      cnt += 8;
    }
  }
  // Callers fill() first; k <= 16.
  __device__ uint32_t take(int k) {
    const uint32_t v = static_cast<uint32_t>(buf & ((1ull << k) - 1ull));
    buf >>= k;
    cnt -= k;
    return v;
  }
  __device__ bool overrun() const {
    return static_cast<int64_t>(pos) * 8 - cnt > static_cast<int64_t>(n) * 8;
  }
};

// zlib's table rules.  Returns 0 for a complete set (or an all-zero one,
// which only fails when a code is used), > 0 for an incomplete set, < 0 for
// an over-subscribed set.
__device__ int construct(Huffman* h, const int16_t* length, int n) {
  for (int len = 0; len <= kMaxBits; ++len) h->count[len] = 0;
  for (int s = 0; s < n; ++s) h->count[length[s]]++;
  if (h->count[0] == n) return 0;
  int left = 1;
  for (int len = 1; len <= kMaxBits; ++len) {
    left <<= 1;
    left -= h->count[len];
    if (left < 0) return left;
  }
  int16_t offs[kMaxBits + 1];
  offs[1] = 0;
  for (int len = 1; len < kMaxBits; ++len) offs[len + 1] = offs[len] + h->count[len];
  for (int s = 0; s < n; ++s)
    if (length[s] != 0) h->symbol[offs[length[s]]++] = static_cast<int16_t>(s);
  return left;
}

// The one incomplete set zlib accepts: a single code, of length 1.
__device__ bool lone_code(const Huffman* h, int n) {
  return n - h->count[0] == 1 && h->count[1] == 1;
}

// Canonical decode of one symbol; the reader holds >= 15 bits.  Returns -1
// when no code matches.
__device__ int decode(BitReader& s, const Huffman* h) {
  int code = 0, first = 0, index = 0;
  uint64_t b = s.buf;
  for (int len = 1; len <= kMaxBits; ++len) {
    code |= static_cast<int>(b & 1u);
    b >>= 1;
    const int c = h->count[len];
    if (code - c < first) {
      s.take(len);
      return h->symbol[index + (code - first)];
    }
    index += c;
    first += c;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

// Literal/length + distance codes of one Huffman block into out[*n_out..).
__device__ bool codes(BitReader& s, const Huffman* lencode,
                      const Huffman* distcode, uint8_t* out, int32_t* n_out,
                      int32_t isize) {
  int32_t o = *n_out;
  for (;;) {
    s.fill();
    int sym = decode(s, lencode);
    if (sym < 0) return false;
    if (sym < 256) {
      if (o >= isize) return false;
      out[o++] = static_cast<uint8_t>(sym);
      continue;
    }
    if (sym == 256) break;
    sym -= 257;
    if (sym >= 29) return false;
    const int len = kLenBase[sym] + static_cast<int>(s.take(kLenExtra[sym]));
    const int dsym = decode(s, distcode);
    if (dsym < 0 || dsym >= kMaxDCodes) return false;
    s.fill();
    const int dist = kDistBase[dsym] + static_cast<int>(s.take(kDistExtra[dsym]));
    if (dist > o) return false;
    if (o + len > isize) return false;
    uint8_t* dst = out + o;
    const uint8_t* src = dst - dist;
    int k = 0;
    if (dist >= 8) {
      // Sources of an 8-byte chunk all precede its destination, so the
      // loads of one chunk are independent and can be in flight together.
      for (; k + 8 <= len; k += 8) {
        uint8_t t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = src[k + j];
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[k + j] = t[j];
      }
    }
    for (; k < len; ++k) dst[k] = src[k];
    o += len;
  }
  *n_out = o;
  return !s.overrun();
}

__global__ void inflate_members_kernel(const uint8_t* __restrict__ comp,
                                       const int64_t* __restrict__ comp_off,
                                       const int32_t* __restrict__ clens,
                                       const int64_t* __restrict__ out_off,
                                       const int32_t* __restrict__ isizes,
                                       uint8_t* out, int32_t* meta) {
  extern __shared__ __align__(16) uint8_t staged[];
  __shared__ Huffman lencode;
  __shared__ Huffman distcode;
  __shared__ int16_t lengths[kMaxLCodes + kMaxDCodes];

  const int64_t i = blockIdx.x;
  const int32_t clen = clens[i];
  const int32_t isize = isizes[i];

  // 1. Stage: 16-byte aligned loads covering [comp_off, comp_off + clen).
  //    The caller pads the compressed buffer so the aligned tail stays in
  //    bounds.
  const uint8_t* src = comp + comp_off[i];
  const uintptr_t base = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const int32_t lead = static_cast<int32_t>(reinterpret_cast<uintptr_t>(src) - base);
  const int32_t nvec = clen > 0 ? (lead + clen + 15) / 16 : 0;
  const uint4* vsrc = reinterpret_cast<const uint4*>(base);
  uint4* vdst = reinterpret_cast<uint4*>(staged);
  for (int32_t k = threadIdx.x; k < nvec; k += blockDim.x) vdst[k] = vsrc[k];
  __syncthreads();
  if (threadIdx.x != 0) return;

  // 2. Decode.
  BitReader s{staged + lead, clen, 0, 0ull, 0};
  uint8_t* o = out + out_off[i];
  int32_t n_out = 0;
  bool ok = clen > 0;
  bool last = false;
  while (ok && !last) {
    s.fill();
    last = s.take(1) != 0;
    const uint32_t type = s.take(2);
    if (type == 0) {
      // Stored: drop to a byte boundary, LEN/NLEN, then raw bytes.
      s.take(s.cnt & 7);
      const uint32_t len = s.take(16);
      const uint32_t nlen = s.take(16);
      if (len != (~nlen & 0xffffu) || s.overrun()) { ok = false; break; }
      if (n_out + static_cast<int32_t>(len) > isize) { ok = false; break; }
      uint32_t k = 0;
      for (; k < len && s.cnt >= 8; ++k) o[n_out + k] = static_cast<uint8_t>(s.take(8));
      if (s.overrun()) { ok = false; break; }
      // The bit buffer is empty here unless the block ended inside it.
      const int32_t rest = static_cast<int32_t>(len - k);
      if (rest > 0) {
        if (s.pos + rest > s.n) { ok = false; break; }
        for (int32_t j = 0; j < rest; ++j) o[n_out + k + j] = s.in[s.pos + j];
        s.pos += rest;
      }
      n_out += static_cast<int32_t>(len);
    } else if (type == 1) {
      // Fixed Huffman codes (RFC 1951 3.2.6); 30 distance symbols, so the
      // codes of 30 and 31 match nothing.
      for (int sym = 0; sym < kFixLCodes; ++sym)
        lengths[sym] = sym < 144 ? 8 : sym < 256 ? 9 : sym < 280 ? 7 : 8;
      construct(&lencode, lengths, kFixLCodes);
      for (int sym = 0; sym < kMaxDCodes; ++sym) lengths[sym] = 5;
      construct(&distcode, lengths, kMaxDCodes);
      ok = codes(s, &lencode, &distcode, o, &n_out, isize);
    } else if (type == 2) {
      const int nlen = static_cast<int>(s.take(5)) + 257;
      const int ndist = static_cast<int>(s.take(5)) + 1;
      const int ncode = static_cast<int>(s.take(4)) + 4;
      if (nlen > kMaxLCodes || ndist > kMaxDCodes) { ok = false; break; }
      for (int k = 0; k < 19; ++k) lengths[k] = 0;
      for (int k = 0; k < ncode; ++k) {
        s.fill();
        lengths[kClcOrder[k]] = static_cast<int16_t>(s.take(3));
      }
      if (construct(&lencode, lengths, 19) != 0) { ok = false; break; }
      int index = 0;
      while (index < nlen + ndist) {
        s.fill();
        int sym = decode(s, &lencode);
        if (sym < 0) { ok = false; break; }
        if (sym < 16) {
          lengths[index++] = static_cast<int16_t>(sym);
          continue;
        }
        int16_t len = 0;
        int rep;
        if (sym == 16) {
          if (index == 0) { ok = false; break; }
          len = lengths[index - 1];
          rep = 3 + static_cast<int>(s.take(2));
        } else if (sym == 17) {
          rep = 3 + static_cast<int>(s.take(3));
        } else {
          rep = 11 + static_cast<int>(s.take(7));
        }
        if (index + rep > nlen + ndist) { ok = false; break; }
        while (rep--) lengths[index++] = len;
      }
      if (!ok || s.overrun()) { ok = false; break; }
      if (lengths[256] == 0) { ok = false; break; }
      int err = construct(&lencode, lengths, nlen);
      if (err < 0 || (err > 0 && !lone_code(&lencode, nlen))) { ok = false; break; }
      err = construct(&distcode, lengths + nlen, ndist);
      if (err < 0 || (err > 0 && !lone_code(&distcode, ndist))) { ok = false; break; }
      ok = codes(s, &lencode, &distcode, o, &n_out, isize);
    } else {
      ok = false;
    }
    if (s.overrun()) ok = false;
  }
  ok = ok && last && n_out == isize;
  meta[2 * i] = n_out;
  meta[2 * i + 1] = ok ? 1 : 0;
}

}  // namespace

extern "C" {

// Decode n members.  Member i's DEFLATE stream is comp[comp_off[i] ..
// + clens[i]); its output goes to out[out_off[i] .. + isizes[i]).
// smem_bytes >= 16 * ceil((15 + max clen) / 16).  Returns the CUDA error
// code of the launch (0 on success).
int hbt_inflate_members(const void* comp, const void* comp_off,
                        const void* clens, const void* out_off,
                        const void* isizes, void* out, void* meta,
                        long long n, int smem_bytes, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      inflate_members_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  inflate_members_kernel<<<static_cast<unsigned>(n), 32, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int64_t*>(comp_off),
      static_cast<const int32_t*>(clens), static_cast<const int64_t*>(out_off),
      static_cast<const int32_t*>(isizes), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
