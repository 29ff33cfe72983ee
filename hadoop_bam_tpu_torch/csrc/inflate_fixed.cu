// Literal-only fixed-Huffman inflate for Hopper (sm_90a).
//
// Replaces hadoop_bam_tpu/ops/pallas/inflate_fixed.py (the kernel of
// _kernel_factory, launched by inflate_fixed_literal): single-block
// btype=01 members whose symbols are literals and one EOB, as
// ops.flate.deflate_fixed writes them.  The TPU kernel puts 128 members on
// the vector lanes, one token a wave, and extracts each lane's stream word
// by iota-compare reductions over the transposed stream tile.  Here one
// thread walks one member: the stream is read in aligned 8-byte words into
// a three-word register window, the 7/8/9-bit code is classified by the
// same canonical ranges (the next 9 bits reversed by __brev), and output
// bytes are packed sixteen at a time into registers and stored as one
// 16-byte write.  Rows past the member's bytes read as zero words.
//
// Bound: latency.  A member is one serial chain of dependent symbol
// decodes (~24,000 for a 24,000-byte member) and a launch holds one thread
// per member, far fewer than the card can keep in flight; the bytes (the
// compressed rows read once, the payload written once) would take a few
// hundredths of a millisecond.  The design keeps each step to register
// work: one word load every 7-9 symbols, issued two words ahead of use,
// and one store every 16 bytes.
//
// Verdicts (ok = 0 and a zero row): a header other than 011, a length code
// (257-279 other than the EOB, or 280-287), an EOB ending past clens * 8,
// and an emit that would pass the member's ISIZE (the reference decides
// this by a count != ISIZE check after at most T waves, T > ISIZE).
//
// Plain C entry point (ctypes): device pointers and the stream as
// integers; returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // one warp a block: members spread over the SMs

__device__ __forceinline__ void store16(uint8_t* p, uint64_t lo, uint64_t hi) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(lo, hi);
}

__global__ void inflate_fixed_kernel(const uint8_t* __restrict__ comp, long long stride,
                                     const int* __restrict__ clens,
                                     const int* __restrict__ isizes, int n,
                                     uint8_t* __restrict__ out, long long out_stride,
                                     uint8_t* __restrict__ ok_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t* row = reinterpret_cast<const uint64_t*>(comp + (long long)i * stride);
  const int nw = (int)(stride >> 3);
  auto word = [&](int q) -> uint64_t { return q < nw ? __ldg(row + q) : 0ull; };
  uint8_t* orow = out + (long long)i * out_stride;
  const int nbits = clens[i] * 8;
  const int isize = isizes[i];

  uint64_t w0 = word(0), w1 = word(1), w2 = word(2);
  int q = 0;
  bool ok = (w0 & 7) == 3;  // bfinal = 1, btype = 01
  int cur = 3;
  int count = 0;
  uint64_t lo = 0, hi = 0;  // the pending 16 output bytes
  while (ok) {
    const int qn = cur >> 6;
    if (qn != q) {  // a symbol advances at most 9 bits: one word at a time
      w0 = w1;
      w1 = w2;
      w2 = word(qn + 2);
      q = qn;
    }
    const int sh = cur & 63;
    const uint64_t win = sh ? (w0 >> sh) | (w1 << (64 - sh)) : w0;
    const unsigned rev = __brev((unsigned)win) >> 23;  // next 9 bits, MSB first
    const unsigned c7 = rev >> 2, c8 = rev >> 1;
    if (c7 <= 0x17) {  // symbols 256-279: only the EOB (0) is allowed
      ok = c7 == 0 && cur + 7 <= nbits;
      break;
    }
    unsigned lit;
    int adv;
    if (c8 >= 0x30 && c8 <= 0xBF) {
      lit = c8 - 0x30;
      adv = 8;
    } else if (c8 >= 0xC0 && c8 <= 0xC7) {  // symbols 280-287: lengths
      ok = false;
      break;
    } else {
      lit = rev - 0x190 + 144;
      adv = 9;
    }
    if (count == isize) {  // one byte more than ISIZE
      ok = false;
      break;
    }
    const int k = count & 15;
    if (k < 8) {
      lo |= (uint64_t)lit << (8 * k);
    } else {
      hi |= (uint64_t)lit << (8 * (k - 8));
    }
    ++count;
    if (k == 15) {
      store16(orow + count - 16, lo, hi);
      lo = hi = 0;
    }
    cur += adv;
  }
  ok = ok && count == isize;
  long long z = 0;  // first byte to zero
  if (ok) {
    z = count & ~15;
    if (count & 15) {
      store16(orow + z, lo, hi);
      z += 16;
    }
  }
  for (; z < out_stride; z += 16) store16(orow + z, 0, 0);
  ok_out[i] = ok;
}

}  // namespace

extern "C" int hbt_inflate_fixed_literal(const void* comp, long long stride, const void* clens,
                                         const void* isizes, long long n, void* out,
                                         long long out_stride, void* ok, void* stream) {
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  inflate_fixed_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, stride, (const int*)clens, (const int*)isizes, (int)n,
      (uint8_t*)out, out_stride, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
