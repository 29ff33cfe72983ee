// FASTQ record-boundary scan for Hopper (sm_90a): one warp per chunk.
//
// record_scan_kernel replaces hadoop_bam_tpu/ops/pallas/record_scan.py
// (record_scan, the pallas_call at :305).  There, up to 128 chunks ride the
// 128 vector lanes of one kernel in lockstep, one byte per lane per wave,
// over a transposed bank of packed words, with a 40-row register file per
// lane updated by iota selects.  Here each chunk gets a warp that reads its
// window in place from one flat byte tensor (chunks overlap, so nothing is
// copied into a bank): the warp loads 128 bytes at a time, one byte per lane
// in four coalesced rows, finds the newlines with __ballot_sync, and every
// lane steps the same line-level frame machine in registers (uniform
// control flow, so no lane waits on another).  The machine's state is the
// reference's: an 8-line history of (first byte, CR-stripped length,
// start), the completed-line count, sync and frame phase, the record count,
// ok and done.  Lane 0 writes each claimed record as two 16-byte stores.
//
// The verdicts are the Pallas kernel's, exactly: sync on two back-to-back
// verified frames with no end-of-data relaxation; a bad frame, a record
// past the chunk's cap, a partial claimed frame, dangling claimed text and
// a window that never synced over content give ok = 0; a final window's
// unterminated last line completes through a synthetic newline.
//
// Bound: bytes (every window byte read once, 32 bytes written per record)
// over 3.35 TB/s.  The line machine is serial per chunk, so a launch needs
// many chunks in flight to approach it: one warp per chunk, four per block.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kAt = 0x40;
constexpr int kPlus = 0x2B;
constexpr int kNl = 0x0A;
constexpr int kCr = 0x0D;
constexpr int kWarpsPerBlock = 4;

struct Machine {
  int fc[8];  // first byte of each of the last 8 lines, -1 while empty
  int ln[8];  // CR-stripped length
  int st[8];  // window offset of the line start
  int lc, synced, base, nrec, ok, done;
  int chunk_len, cap;
  int* rows;
  bool writer;

  __device__ __forceinline__ void init(int aligned, int chunk_len_, int cap_,
                                       int* rows_, bool writer_) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fc[i] = -1;
      ln[i] = 0;
      st[i] = 0;
    }
    lc = 0;
    synced = aligned;
    base = 0;
    nrec = 0;
    ok = 1;
    done = 0;
    chunk_len = chunk_len_;
    cap = cap_;
    rows = rows_;
    writer = writer_;
  }

  template <int H>
  __device__ __forceinline__ void emit() {
    if (writer) {
      int4* dst = reinterpret_cast<int4*>(rows + 8 * static_cast<int64_t>(nrec));
      dst[0] = make_int4(st[H], ln[H], st[H + 1], ln[H + 1]);
      dst[1] = make_int4(st[H + 2], ln[H + 2], st[H + 3], ln[H + 3]);
    }
    nrec += 1;
  }

  // One completed line.  Returns true once the scan stops (ok 0 or done).
  __device__ __forceinline__ bool line(int first, int eff, int start) {
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      fc[i] = fc[i + 1];
      ln[i] = ln[i + 1];
      st[i] = st[i + 1];
    }
    fc[7] = first;
    ln[7] = eff;
    st[7] = start;
    lc += 1;
    const bool frame_a = fc[0] == kAt && fc[2] == kPlus && ln[1] == ln[3];
    const bool frame_b = fc[4] == kAt && fc[6] == kPlus && ln[5] == ln[7];
    const bool can_sync = !synced && lc >= 8 && frame_a && frame_b;
    const bool sync_claim = can_sync && st[0] < chunk_len;
    const bool sync_beyond = can_sync && st[0] >= chunk_len;
    const bool bnd = synced && ((lc - base) & 3) == 0;
    const bool claim_b = st[4] < chunk_len;
    const bool emit2 = (bnd || sync_claim) && claim_b && frame_b;
    const bool bad = bnd && claim_b && !frame_b;
    const bool done_now = ((bnd || sync_claim) && !claim_b) || sync_beyond;
    const bool over = nrec + static_cast<int>(sync_claim) + static_cast<int>(emit2) > cap;
    if (!over) {
      if (sync_claim) emit<0>();
      if (emit2) emit<4>();
    }
    if (bad || over) ok = 0;
    if (done_now) done = 1;
    if (sync_claim) {
      synced = 1;
      base = lc - 8;
    }
    return !ok || done;
  }
};

// The newlines of one 32-byte row at window offset g: complete each line.
__device__ __forceinline__ bool run_row(Machine& m, const uint8_t* __restrict__ w,
                                        unsigned mask, int g, int& cur_start) {
  while (mask) {
    const int p = g + __ffs(mask) - 1;
    mask &= mask - 1;
    const int raw = p - cur_start;
    int first = -1;
    int eff = 0;
    if (raw > 0) {
      first = w[cur_start];
      eff = raw - (w[p - 1] == kCr ? 1 : 0);
    }
    const int start = cur_start;
    cur_start = p + 1;
    if (m.line(first, eff, start)) return true;
  }
  return false;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
record_scan_kernel(const uint8_t* __restrict__ data,
                   const int64_t* __restrict__ win_off,
                   const int32_t* __restrict__ win_len,
                   const int32_t* __restrict__ chunk_len,
                   const int32_t* __restrict__ flags,
                   const int32_t* __restrict__ caps,
                   const int64_t* __restrict__ row_base,
                   int32_t* __restrict__ rows, int32_t* __restrict__ meta,
                   int64_t n_chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n_chunks) return;  // the whole warp leaves together
  const uint8_t* __restrict__ w = data + win_off[k];
  const int n = win_len[k];
  const int fl = flags[k];
  Machine m;
  m.init(fl & 1, chunk_len[k], caps[k], rows + 8 * row_base[k], lane == 0);

  int cur_start = 0;
  bool stopped = false;
  for (int g = 0; g < n && !stopped; g += 128) {
    uint8_t b0, b1, b2, b3;
    {
      const int p = g + lane;
      b0 = p < n ? w[p] : 0;
      b1 = p + 32 < n ? w[p + 32] : 0;
      b2 = p + 64 < n ? w[p + 64] : 0;
      b3 = p + 96 < n ? w[p + 96] : 0;
    }
    const unsigned m0 = __ballot_sync(0xffffffffu, b0 == kNl);
    const unsigned m1 = __ballot_sync(0xffffffffu, b1 == kNl);
    const unsigned m2 = __ballot_sync(0xffffffffu, b2 == kNl);
    const unsigned m3 = __ballot_sync(0xffffffffu, b3 == kNl);
    stopped = run_row(m, w, m0, g, cur_start) || run_row(m, w, m1, g + 32, cur_start) ||
              run_row(m, w, m2, g + 64, cur_start) || run_row(m, w, m3, g + 96, cur_start);
  }

  // Text after the last newline: a final window completes it as a line.
  int cur_len = stopped ? 0 : n - cur_start;
  if (!stopped && (fl & 2) && cur_len > 0) {
    m.line(w[cur_start], cur_len - (w[n - 1] == kCr ? 1 : 0), cur_start);
    cur_len = 0;
    cur_start = n;
  }

  // Final verdicts: a claimed frame left partial, dangling claimed text,
  // and a window that never synced over content each tier the chunk down.
  const int pend = (m.lc - m.base) & 3;
  int part_start = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (8 - pend == i) part_start = m.st[i];
  }
  const bool bad_tail = m.synced && !m.done && pend != 0 && part_start < m.chunk_len;
  const bool bad_text = !m.done && cur_len > 0 && cur_start < m.chunk_len;
  const bool bad_sync = !m.synced && !m.done && (m.lc > 0 || cur_len > 0);
  if (bad_tail || bad_text || bad_sync) m.ok = 0;
  if (lane == 0) {
    meta[2 * k] = m.nrec;
    meta[2 * k + 1] = m.ok;
  }
}

}  // namespace

extern "C" {

// Scan n_chunks windows data[win_off[k] .. + win_len[k]); chunk k's claimed
// records go to rows[row_base[k] ..] (8 int32 each, at most caps[k]) and
// its [n, ok] to meta[2k], meta[2k+1].  flags bit 0: aligned, bit 1: final.
// Returns the CUDA error code of the launch.
int hbt_record_scan(const void* data, const void* win_off, const void* win_len,
                    const void* chunk_len, const void* flags, const void* caps,
                    const void* row_base, void* rows, void* meta, long long n_chunks,
                    void* cuda_stream) {
  if (n_chunks <= 0) return 0;
  const long long blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  record_scan_kernel<<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(win_off),
      static_cast<const int32_t*>(win_len), static_cast<const int32_t*>(chunk_len),
      static_cast<const int32_t*>(flags), static_cast<const int32_t*>(caps),
      static_cast<const int64_t*>(row_base), static_cast<int32_t*>(rows),
      static_cast<int32_t*>(meta), static_cast<int64_t>(n_chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
