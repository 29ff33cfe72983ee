"""Chip smoke test of the PyTorch/CUDA port (``hadoop_bam_tpu_torch``).

Run on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--records N] [--seed S]

Phases: print the card; build the CUDA kernels from ``csrc/``; hold each
kernel against its plain PyTorch version on the card (exact equality);
drive ``sort_bam`` at full size on a synthetic BAM and hold its output
byte for byte against the port's CPU run; time every kernel at the main
path's shapes.  Any failure exits non-zero.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it is the
kernel table as JSON.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
REPO = os.path.dirname(os.path.abspath(__file__))

# GRCh38 primary assembly: the 22 autosomes, X, Y and the mitochondrion.
GRCH38 = [
    ("chr1", 248956422), ("chr2", 242193529), ("chr3", 198295559),
    ("chr4", 190214555), ("chr5", 181538259), ("chr6", 170805979),
    ("chr7", 159345973), ("chr8", 145138636), ("chr9", 138394717),
    ("chr10", 133797422), ("chr11", 135086622), ("chr12", 133275309),
    ("chr13", 114364328), ("chr14", 107043718), ("chr15", 101991189),
    ("chr16", 90338345), ("chr17", 83257441), ("chr18", 80373285),
    ("chr19", 58617616), ("chr20", 64444167), ("chr21", 46709983),
    ("chr22", 50818468), ("chrX", 156040895), ("chrY", 57227415),
    ("chrM", 16569),
]


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Corpora
# ---------------------------------------------------------------------------


def _raw_deflate(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(payload) + co.flush()


class _BitWriter:
    """LSB-first bit packer for hand-built DEFLATE streams."""

    def __init__(self):
        self.bits = []

    def w(self, val, n):
        self.bits.extend((val >> k) & 1 for k in range(n))

    def code(self, c, length):  # Huffman codes go MSB-first
        self.bits.extend((c >> k) & 1 for k in range(length - 1, -1, -1))

    def bytes(self):
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out)


def _rle_block() -> tuple:
    """A dynamic block whose code-length section uses RLE codes 16, 17 and
    18; it decodes to b"ABCDEFG"."""
    bw = _BitWriter()
    bw.w(1, 1)
    bw.w(2, 2)
    bw.w(0, 5)
    bw.w(0, 5)
    bw.w(10, 4)
    clc_lens = {0: 3, 1: 3, 2: 2, 3: 2, 13: 2}
    for pos in range(14):
        bw.w(clc_lens.get(pos, 0), 3)
    zero, three, r18, r16, r17 = (0, 2), (1, 2), (2, 2), (6, 3), (7, 3)
    bw.code(*r18)
    bw.w(65 - 11, 7)
    bw.code(*three)
    bw.code(*r16)
    bw.w(0, 2)
    bw.code(*r16)
    bw.w(0, 2)
    bw.code(*r18)
    bw.w(138 - 11, 7)
    bw.code(*r18)
    bw.w(36 - 11, 7)
    bw.code(*r17)
    bw.w(10 - 3, 3)
    bw.code(*three)
    bw.code(*zero)
    for k in range(8):
        bw.code(k, 3)
    return bw.bytes(), bytes(range(65, 72))


def _oversubscribed() -> bytes:
    """Three length-1 literal/length codes: an over-subscribed table."""
    bw = _BitWriter()
    bw.w(1, 1)
    bw.w(2, 2)
    bw.w(0, 5)
    bw.w(0, 5)
    bw.w(14, 4)
    for pos in range(18):
        bw.w(1 if pos in (2, 17) else 0, 3)
    for _ in range(3):
        bw.code(0, 1)
    bw.code(1, 1)
    bw.w(138 - 11, 7)
    bw.code(1, 1)
    bw.w(116 - 11, 7)
    bw.code(0, 1)
    return bw.bytes() + b"\0" * 8


def inflate_corpus(seed: int):
    """``(comps, isizes, payloads)``: zlib levels 0/1/6/9, a flush chain,
    RLE codes, full-size members and four corrupt members (payload None)."""
    rng = np.random.default_rng(seed)
    comps, isizes, payloads = [], [], []

    def add(comp, payload, isize=None):
        comps.append(comp)
        payloads.append(payload)
        isizes.append(len(payload) if isize is None else isize)

    text = b"@SQ\tSN:chr7\tLN:10000\n" * 40
    noise = bytes(rng.integers(0, 256, 700, dtype=np.uint8))
    bases = bytes(rng.choice(list(b"ACGT"), 3000))
    for lvl in (0, 1, 6, 9):
        for p in (text, noise, bases):
            add(_raw_deflate(p, lvl), p)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    a, b, c = b"ACGTACGT" * 30, noise[:300], bases[:250]
    add(
        co.compress(a) + co.flush(zlib.Z_FULL_FLUSH) + co.compress(b)
        + co.flush(zlib.Z_FULL_FLUSH) + co.compress(c) + co.flush(),
        a + b + c,
    )
    add(*_rle_block())
    full_text = (b"read\tACGTTGCA\t" * 6000)[:0xFF00]
    full_noise = bytes(rng.integers(0, 256, 0xFF00, dtype=np.uint8))
    for lvl in (1, 6):
        add(_raw_deflate(full_text, lvl), full_text)
    add(_raw_deflate(full_noise, 0), full_noise)
    add(_raw_deflate(full_noise, 6), full_noise)
    good = _raw_deflate(b"good data here " * 25, 6)
    add(bytes([0b111]) + good[1:], None, 375)  # BTYPE 11
    cut = _raw_deflate(b"truncate me please " * 30, 6)
    add(cut[: len(cut) // 2], None, 570)
    add(_raw_deflate(b"x" * 50, 6), None, 49)  # wrong isize
    add(_oversubscribed(), None, 1)
    return comps, isizes, payloads


def chain_stream(seed: int, n: int = 3000):
    """A record stream with refid -1, pos -1 on a mapped record, the
    unmapped flag, a hash that is negative and pos = INT_MAX."""
    from hadoop_bam_tpu_torch.spec import bam

    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        k = i % 7
        if k == 0:
            recs.append(bam.build_record(f"u{i}", -1, -1, 0, 4, [], "ACGTA", b""))
        elif k == 1:
            recs.append(bam.build_record(f"p{i}", 2, 100 + i, 0, 4, [], "ACGTAC", b""))
        elif k == 2:
            recs.append(bam.build_record(f"n{i}", 1, -1, 60, 0, [], "ACG", b""))
        elif k == 3:
            recs.append(bam.build_record(f"x{i}", 3, 0x7FFFFFFF, 60, 0, [(4, "M")], "ACGT", b""))
        else:
            recs.append(
                bam.build_record(
                    f"m{i}", int(rng.integers(0, 25)), int(rng.integers(0, 1 << 28)),
                    60, 16 * int(rng.integers(0, 2)), [(30, "M")], "ACGT" * 7 + "AC", b"",
                )
            )
    return np.frombuffer(b"".join(recs), dtype=np.uint8).copy()


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 3) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def pack_members(comps, isizes, device):
    """Tensors for ``inflate_members`` over a list of raw DEFLATE streams."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin

    clens = np.asarray([len(c) for c in comps], dtype=np.int32)
    comp_off = np.zeros(len(comps), dtype=np.int64)
    comp_off[1:] = np.cumsum(clens[:-1])
    isz = np.asarray(isizes, dtype=np.int32)
    out_off = np.zeros(len(comps), dtype=np.int64)
    out_off[1:] = np.cumsum(isz[:-1].astype(np.int64))
    blob = np.frombuffer(b"".join(comps) + b"\0" * kin.COMP_PAD, dtype=np.uint8).copy()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = torch.zeros(int(isz.sum()) + 1, dtype=torch.uint8, device=device)
    return (t(blob), t(comp_off), t(clens), t(out_off), t(isz), out, int(clens.max()))


def check_inflate(seed: int) -> dict:
    """Phase 3: the inflate kernel against its plain version, exactly."""
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin

    comps, isizes, payloads = inflate_corpus(seed)
    dev_args = pack_members(comps, isizes, "cuda")
    cpu_args = pack_members(comps, isizes, "cpu")
    meta_k = kin.inflate_members(*dev_args).cpu().numpy()
    meta_p = kin.inflate_members(*cpu_args).numpy()
    out_k = dev_args[5].cpu().numpy()
    out_p = cpu_args[5].numpy()
    ok_k, ok_p = meta_k[:, 1].astype(bool), meta_p[:, 1].astype(bool)
    if not np.array_equal(ok_k, ok_p):
        raise AssertionError(f"inflate ok differs: kernel {ok_k} plain {ok_p}")
    want = np.array([p is not None for p in payloads])
    if not np.array_equal(ok_p, want):
        raise AssertionError(f"inflate ok {ok_p} != expected {want}")
    oo = dev_args[3].cpu().numpy()
    bad_bytes = 0
    for i, p in enumerate(payloads):
        if p is None:
            continue
        o = int(oo[i])
        if meta_k[i, 0] != len(p) or out_k[o : o + len(p)].tobytes() != p:
            raise AssertionError(f"inflate member {i} bytes differ from zlib")
        bad_bytes += int(np.count_nonzero(out_k[o : o + len(p)] != out_p[o : o + len(p)]))
    log(f"inflate kernel == plain: {len(comps)} members, {int(ok_k.sum())} ok, "
        f"{int((~ok_k).sum())} rejected, max_abs_err 0")
    return {"members": len(comps), "max_abs_err": float(bad_bytes)}


def check_chain(seed: int) -> dict:
    """Phase 4: walk + key gather against their plain versions, exactly,
    on a clean stream and on one with a corrupt size word."""
    import torch

    from hadoop_bam_tpu_torch.ops import decode
    from hadoop_bam_tpu_torch.ops.kernels import chain as kch
    from hadoop_bam_tpu_torch.spec import bam

    s = chain_stream(seed)
    bad = s.copy()
    at = int(bam.record_chain_partial(s, 0, len(s))[0][100])
    bad[at : at + 4] = [7, 0, 0, 0]  # a size word below the fixed fields
    for case, arr in (("clean", s), ("corrupt", bad)):
        offs_h, _ = bam.record_chain_partial(arr, 0, len(arr))
        n_rows = len(offs_h)
        res = {}
        for dev in ("cuda", "cpu"):
            t = torch.from_numpy(arr).to(dev)
            offs, meta = kch.record_chain(t, len(arr))
            keys, unm = kch.stream_keys(t, len(arr), offs, meta, n_rows)
            res[dev] = [x.cpu().numpy() for x in (offs, meta, keys, unm)]
        (ok_, mk, kk, uk), (op, mp, kp, up) = res["cuda"], res["cpu"]
        cnt = int(mk[0])
        if not (np.array_equal(mk, mp) and np.array_equal(ok_[:cnt], op[:cnt])
                and np.array_equal(kk, kp) and np.array_equal(uk, up)):
            raise AssertionError(f"chain kernel differs from plain ({case})")
        if case == "clean":
            if not (mk[1] == 1 and np.array_equal(ok_[:cnt], offs_h)):
                raise AssertionError("chain walk differs from the host walk")
            soa = bam.soa_decode(arr, offs_h)
            want = bam.soa_keys(soa, arr)
            h = np.zeros(n_rows, dtype=np.int32)
            rows = np.nonzero(uk)[0]
            from hadoop_bam_tpu_torch.utils.murmur3 import murmurhash3_int32_batch

            h[rows] = murmurhash3_int32_batch(
                arr, offs_h[rows] + 36, soa["rec_len"][rows] - 32
            )
            got = decode.patch_unmapped_keys(
                torch.from_numpy(kk).cuda(), torch.from_numpy(uk).cuda(),
                torch.from_numpy(h).cuda(),
            ).cpu().numpy()
            # pos = INT_MAX: the device rule (make_keys) wraps pos + 1 in
            # int32 and calls the row unmapped; the host rule (soa_keys)
            # does not.  Both packages share that split; skip those rows.
            same = soa["pos"] != bam.INT_MAX
            if not np.array_equal(got[same], want[same]):
                raise AssertionError("patched device keys differ from host keys")
            if not (want < 0).any() or not uk.any():
                raise AssertionError("corpus lacks negative keys or unmapped rows")
        elif mk[1] != 0:
            raise AssertionError("corrupt size word not rejected")
    log(f"chain + keys kernels == plain: {n_rows} records, corrupt stream rejected")
    return {"max_abs_err": 0.0}


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    end = end - 1
    out = np.zeros(len(beg), dtype=np.int64)
    done = np.zeros(len(beg), dtype=bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        m = ~done & ((beg >> shift) == (end >> shift))
        out[m] = base + (beg[m] >> shift)
        done |= m
    return out


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    """ASCII decimal digits of ``v``, zero-padded to ``width``: uint8 [n, width]."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((v[:, None] // p[None, :]) % 10 + 48).astype(np.uint8)


def synth_records(i0: int, n: int, rng) -> np.ndarray:
    """Records ``i0 .. i0 + n`` as uint8 rows of 280 bytes: 150 bp reads over
    the GRCh38 primary contigs, one CIGAR op (150M) and one aux tag (NM:C);
    about 10% unmapped, half of those placed beside a mate.  Unmapped rows
    have no CIGAR and a 4-byte longer name, so every row is 280 bytes."""
    W, L = 280, 150
    lens = np.asarray([c[1] for c in GRCH38], dtype=np.int64)
    idx = np.arange(i0, i0 + n, dtype=np.int64)
    unm = rng.random(n) < 0.10
    placed = unm & (rng.random(n) < 0.5)
    refid = rng.choice(len(lens), n, p=lens / lens.sum()).astype(np.int64)
    pos = (rng.random(n) * (lens[refid] - L)).astype(np.int64)
    refid[unm & ~placed] = -1
    pos[unm & ~placed] = -1
    flag = np.where(rng.random(n) < 0.5, 16, 0).astype(np.int64)
    flag[unm] = 4
    bin_ = np.where(unm, 0, _reg2bin(pos, pos + L))
    bin_[placed] = _reg2bin(pos[placed], pos[placed] + 1)
    bin_[unm & ~placed] = 4680
    rows = np.zeros((n, W), dtype=np.uint8)

    def put(col: int, vals: np.ndarray, nbytes: int) -> None:
        v = vals.astype(np.int64) & ((1 << (8 * nbytes)) - 1)
        for k in range(nbytes):
            rows[:, col + k] = (v >> (8 * k)) & 0xFF

    put(0, np.full(n, W - 4), 4)
    put(4, refid, 4)
    put(8, pos, 4)
    put(12, np.where(unm, 15, 11), 1)
    put(13, np.where(unm, 0, 60), 1)
    put(14, bin_, 2)
    put(16, np.where(unm, 0, 1), 2)
    put(18, flag, 2)
    put(20, np.full(n, L), 4)
    put(24, np.full(n, -1), 4)
    put(28, np.full(n, -1), 4)
    m = ~unm
    rows[m, 36] = ord("r")
    rows[m, 37:46] = _digits(idx[m], 9)
    rows[m, 46] = 0
    put(47, np.full(n, L << 4), 4)  # 150M; unmapped rows overwrite it
    rows[unm, 36] = ord("u")
    rows[unm, 37:50] = _digits(idx[unm], 13)
    rows[unm, 50] = 0
    nib = np.asarray([1, 2, 4, 8], dtype=np.uint8)[rng.integers(0, 4, (n, L), dtype=np.uint8)]
    rows[:, 51:126] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    rows[:, 126:276] = rng.integers(2, 41, (n, L), dtype=np.uint8)
    rows[:, 276:279] = np.frombuffer(b"NMC", dtype=np.uint8)
    rows[:, 279] = rng.integers(0, 6, n, dtype=np.uint8)
    return rows


def synth_bam(path: str, n: int, seed: int, level: int = 6) -> int:
    """Write an unsorted BAM of ``n`` synthetic records; returns its size."""
    from hadoop_bam_tpu_torch.spec import bam, bgzf

    rng = np.random.default_rng(seed)
    text = "@HD\tVN:1.6\tSO:unsorted\n" + "".join(
        f"@SQ\tSN:{c}\tLN:{ln}\n" for c, ln in GRCH38
    ) + "@PG\tID:chip_smoke\tPN:chip_smoke\n"
    header = bam.BamHeader(text, list(GRCH38))
    chunk = 250_000
    stream = np.concatenate(
        [synth_records(i, min(chunk, n - i), rng).reshape(-1) for i in range(0, n, chunk)]
    )
    body, _ = bgzf.deflate_blocks(stream, level=level)
    with open(path, "wb") as f:
        f.write(bgzf.deflate_blocks(header.encode(), level=level)[0])
        f.write(body)
        f.write(bgzf.TERMINATOR)
    return os.path.getsize(path)


def record_digests(path: str):
    """``(keys, digests)`` of every record of a BAM, read back by the port's
    own reader (host keys)."""
    from hadoop_bam_tpu_torch.io.bam import SORT_FIELDS, read_header_voffset, read_virtual_range

    _, vfirst = read_header_voffset(path)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    b = read_virtual_range(data, vfirst, (len(data) << 16) | 0xFFFF, fields=SORT_FIELDS)
    mv = memoryview(b.data)
    dig = np.fromiter(
        (
            int.from_bytes(hashlib.blake2b(mv[o - 4 : o + ln], digest_size=8).digest(), "little", signed=True)
            for o, ln in zip(b.soa["rec_off"].tolist(), b.soa["rec_len"].tolist())
        ),
        dtype=np.int64,
        count=len(b.soa["rec_off"]),
    )
    return b.keys, dig


def launch_counts() -> dict:
    from hadoop_bam_tpu_torch.ops.kernels import chain as kch
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin

    return {c.name: c.value for c in (kin.LAUNCHES, kch.WALK_LAUNCHES, kch.KEYS_LAUNCHES)}


def reset_counts() -> None:
    from hadoop_bam_tpu_torch.ops.kernels import chain as kch
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin

    for c in (kin.LAUNCHES, kch.WALK_LAUNCHES, kch.KEYS_LAUNCHES):
        c.reset()


def main_path(work: str, n: int, seed: int) -> dict:
    """Phases 5 and 6: sort a synthetic BAM on the card and on the CPU;
    the outputs must be byte-identical, sorted, and hold the input's
    records."""
    import torch

    from hadoop_bam_tpu_torch.conf import INFLATE_LANES, Configuration
    from hadoop_bam_tpu_torch.pipeline import sort_bam

    src = os.path.join(work, "in.bam")
    t0 = time.perf_counter()
    size = synth_bam(src, n, seed)
    log(f"synthetic BAM: {n} records, {size} bytes, built in "
        f"{time.perf_counter() - t0:.1f} s")
    conf = Configuration({INFLATE_LANES: "true"})
    out_gpu = os.path.join(work, "sorted.cuda.bam")
    out_cpu = os.path.join(work, "sorted.cpu.bam")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sort_bam(src, out_gpu, conf=conf, device="cuda", device_parse=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    c = st.counters
    log(f"sort_bam(cuda): {st.n_records} records, {st.n_splits} splits, "
        f"backend {st.backend}, wall {wall:.3f} s, {st.n_records / wall:.0f} reads/s")
    log(f"  phases (s): " + json.dumps({k: round(v, 3) for k, v in st.seconds.items()}))
    log(f"  launches: {json.dumps(launches)}")
    log(f"  flate.lanes_tierdown {c.get('flate.lanes_tierdown', 0)}, members on the kernel "
        f"{c.get('flate.inflate.lanes', 0)}, resident windows "
        f"{c.get('sort_bam.device_parse_residency', 0)}, uploaded windows "
        f"{c.get('device_stream.uploaded_windows', 0)}")
    log(f"  h2d bytes {c.get('transfers.h2d_bytes', 0)}, d2h bytes "
        f"{c.get('transfers.d2h_bytes', 0)}: " + json.dumps(
            {k: v for k, v in c.items() if k.startswith("transfers.")}))
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if c.get("flate.lanes_tierdown", 0) != 0:
        raise AssertionError("members tiered down on clean input")
    if st.n_records != n:
        raise AssertionError(f"sorted {st.n_records} records of {n}")
    t0 = time.perf_counter()
    st_cpu = sort_bam(src, out_cpu, conf=conf, device="cpu", device_parse=True)
    log(f"sort_bam(cpu): wall {time.perf_counter() - t0:.3f} s")
    with open(out_gpu, "rb") as f:
        a = f.read()
    with open(out_cpu, "rb") as f:
        b = f.read()
    if a != b:
        raise AssertionError("cuda and cpu outputs differ")
    log(f"cuda output == cpu output: {len(a)} bytes")
    keys_out, dig_out = record_digests(out_gpu)
    _, dig_in = record_digests(src)
    if not np.all(np.diff(keys_out) >= 0):
        raise AssertionError("output keys are not monotone")
    if not np.array_equal(np.sort(dig_out), np.sort(dig_in)):
        raise AssertionError("output records differ from the input's")
    log(f"re-read: {len(keys_out)} records, keys monotone, record multiset equal")
    return {"src": src, "launches": launches, "wall": wall, "stats": st, "cpu": st_cpu}


def time_kernels(src: str, checks: dict, launches: dict) -> list:
    """Phase 7: each kernel at the main path's shapes (the input's first
    split), beside its plain version and its bound."""
    import torch

    from hadoop_bam_tpu_torch.conf import INFLATE_LANES, Configuration
    from hadoop_bam_tpu_torch.io.bam import BamInputFormat, _read_range
    from hadoop_bam_tpu_torch.ops.kernels import chain as kch
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin
    from hadoop_bam_tpu_torch.spec import bam, bgzf

    fmt = BamInputFormat(Configuration({INFLATE_LANES: "true"}))
    split = fmt.get_splits([src], split_size=32 << 20)[0]
    size = os.path.getsize(src)
    c0, c1 = split.vstart >> 16, min(split.vend >> 16, size)
    data = _read_range(src, c0, min(c1 + (1 << 20), size) - c0)
    raw = np.frombuffer(data, dtype=np.uint8)
    co_l, cs_l, us_l = [], [], []
    pos = 0
    while pos < len(data) and pos <= c1 - c0:  # the members read_split inflates
        csize, usize = bgzf.read_block_at(data, pos)
        co_l.append(pos)
        cs_l.append(csize)
        us_l.append(usize)
        pos += csize
    co = np.asarray(co_l, dtype=np.int64)
    cs = np.asarray(cs_l, dtype=np.int64)
    us = np.asarray(us_l, dtype=np.int64)
    xlen = raw[co + 10].astype(np.int64) | (raw[co + 11].astype(np.int64) << 8)
    clens = (cs - 20 - xlen).astype(np.int32)
    comp_off = (co + 12 + xlen).astype(np.int64)
    out_off = np.zeros(len(co), dtype=np.int64)
    out_off[1:] = np.cumsum(us[:-1].astype(np.int64))
    total = int(us.astype(np.int64).sum())

    def args(dev):
        comp = torch.zeros(len(raw) + kin.COMP_PAD, dtype=torch.uint8, device=dev)
        comp[: len(raw)].copy_(torch.from_numpy(raw.copy()))
        t = lambda a: torch.from_numpy(a).to(dev)
        out = torch.empty(total, dtype=torch.uint8, device=dev)
        return (comp, t(comp_off), t(clens), t(out_off), t(us.astype(np.int32)), out,
                int(clens.max()))

    ga, ca = args("cuda"), args("cpu")
    rows = []
    k_ms = cuda_ms(lambda: kin.inflate_members(*ga), iters=5, warmup=1)
    p_ms = host_ms(lambda: kin.inflate_members_plain(*ca[:6]), iters=1)
    inflated = ga[5]
    n_in = int(clens.astype(np.int64).sum())
    rows.append({
        "name": "inflate_members", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/inflate.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/inflate_lanes.py:830",
        "launches": launches["inflate_members"], "max_abs_err": checks["inflate"],
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": (n_in + total) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "shape": f"{len(co)} members, {n_in} compressed -> {total} bytes",
    })
    # The chain kernels over the split's record stream.
    host = inflated.cpu().numpy()
    up0 = split.vstart & 0xFFFF
    offs_h, s1 = bam.record_chain_partial(host, up0, len(host))
    s0 = up0
    n_rec = len(offs_h)
    g_stream = inflated[s0:s1]
    c_stream = torch.from_numpy(host[s0:s1].copy())
    k_ms = cuda_ms(lambda: kch.record_chain(g_stream, s1 - s0), iters=5, warmup=1)
    p_ms = host_ms(lambda: kch.record_chain_plain(c_stream, s1 - s0), iters=1)
    rows.append({
        "name": "record_chain", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/chain.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/chain.py:113",
        "launches": launches["record_chain"], "max_abs_err": checks["chain"],
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": n_rec * (4 + 8) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shape": f"{n_rec} records, {s1 - s0} bytes",
    })
    offs, meta = kch.record_chain(g_stream, s1 - s0)
    k_ms = cuda_ms(lambda: kch.stream_keys(g_stream, s1 - s0, offs, meta, n_rec), iters=20)
    p_ms = cuda_ms(lambda: kch.stream_keys_plain(g_stream, s1 - s0, offs, meta, n_rec), iters=5)
    rows.append({
        "name": "stream_keys", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/chain.cu",
        "replaces": "hadoop_bam_tpu/ops/decode.py:88",
        "launches": launches["stream_keys"], "max_abs_err": checks["chain"],
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": n_rec * (8 + 10 + 8 + 1) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shape": f"{n_rec} records",
    })
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms) at {r['shape']}")
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain checks")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from hadoop_bam_tpu_torch import _build

    log(card_line())
    t0 = time.perf_counter()
    built = _build.build(force=True)
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, b in built.items():
        for line in b["log"].splitlines():
            if "registers" in line or "smem" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    checks = {
        "inflate": check_inflate(args.seed)["max_abs_err"],
        "chain": check_chain(args.seed)["max_abs_err"],
    }
    torch.cuda.synchronize()
    if args.kernels_only:
        return 0
    if args.records != 2_000_000:
        log(f"records cut from 2000000 to {args.records}")
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        res = main_path(work, args.records, args.seed)
        rows = time_kernels(res["src"], checks, res["launches"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
