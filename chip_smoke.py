"""Chip smoke test of the PyTorch/CUDA port (``hadoop_bam_tpu_torch``).

Run on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--records N] [--dup-pairs N] [--pairs N] [--variants N]
                          [--cram-records N] [--codec-mib N] [--seed S]

Phases: print the card; build the CUDA kernels from ``csrc/``; hold each
kernel against its plain PyTorch version on the card (exact equality);
drive ``sort_bam`` at full size on a synthetic BAM with the default gates
(every kernel on), with the write side's gates off (byte-identical to the
port's CPU run) and with one resident split (byte-identical to the host
gather + deflate lanes); mark duplicates, sort by name and fixmate
synthetic read pairs on the card and on the CPU (the collation phase:
markdup of 500,000 pairs with the default gates, cut from 1,000,000; byte-identical with the
write gates off, the markdup, queryname and fixmate twins, and the
default-gate queryname sort and fixmate, on the first 250,000 pairs; the duplicate decision against
its per-record oracle on the first 50,000 pairs, the mask through the
device write of one resident split, fixmate run again on its own output);
sort out of core (the out-of-core phase: the main path's input under a
128 MiB ``memory_budget`` on the card, its content the in-core sort's, card
against CPU byte-identical with the write gates off, and markdup, the
queryname sort and fixmate of the first 250,000 pairs under 32 MiB, each
decompressing to its in-core twin's bytes); salvage (the salvage phase: a
copy of the main path's input with four damaged members, where the strict
sort raises and the salvage sort on the card, under injected part-write
crashes, quarantines exactly them and decompresses to the CPU salvage
sort's bytes; a ``part_dir`` resume that skips the finished parts; the
out-of-core form with one range quarantined, then resumed; a salvaged BCF
window query, card against CPU; forced codec tier-downs in the codec
phase); the text formats (the text phase, after the variants phase: the
main path's input rows as SAM text sorted on the card to the content of
its BAM twin's sort, a sorted part through ``SamOutputWriter`` and back;
the call set's sites as plain, BGZF and plain-gzip VCF text read through
``VcfInputFormat`` to the card BCF read's keys, positions and ends, with
a malformed line under LENIENT and STRICT; ``join_counts_device`` on the
card against ``join_counts_np``); drive
``ingest_fastq`` on 250,000 synthetic read pairs with the default gates,
and on the CPU (the card's output decompresses to the CPU run's bytes),
and hold
``ingest_oracle`` to it on a prefix; query three regions of a synthetic
4,500,000-site BCF call set with ``variants_blob`` on the card (each
equal to the generator's records; the first on the CPU too,
byte-identical); sort a
synthetic no-ref rANS CRAM of 300,000 records on the card (its rANS blocks
through the decode kernel) to the
content of the sort of its BAM twin; read regions of the sorted BAM
(``build_bai``, ``flagstat`` against the generator's census, ``view_blob``
of three regions against a NumPy overlap oracle, the first on the CPU too,
``depth_stat`` and a bounded-traversal ``sort_bam``, card against CPU, and a view of the CRAM against its BAM twin's); run the device codec's
literal-only round trip on 64 MiB of record bytes (``bgzf_compress_device``
with ``use_lanes=False``, then ``bgzf_decompress_device`` with the inflate
gate off, every member through kernel row 10, and with the default gates),
the general inflate programs with the gate off, ``warm_kernels`` twice and
the walk probe (row 11); time every kernel at the paths' shapes.
Any failure exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernel table
as JSON.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import struct
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


def _canonical(lens: dict) -> dict:
    """``{symbol: (code, length)}`` of the canonical Huffman code with the
    given ``{symbol: length}`` (RFC 1951 3.2.2)."""
    counts = [0] * 16
    for n in lens.values():
        counts[n] += 1
    code, nxt = 0, [0] * 16
    for n in range(1, 16):
        code = (code + counts[n - 1]) << 1
        nxt[n] = code
    out = {}
    for sym in sorted(lens):
        out[sym] = (nxt[lens[sym]], lens[sym])
        nxt[lens[sym]] += 1
    return out


def _base_sym(bases, extras, v: int, first: int = 0):
    """``(symbol, extra value, extra bits)`` of a length or distance."""
    k = int(np.searchsorted(bases, v, side="right")) - 1
    return first + k, v - int(bases[k]), int(extras[k])


def _dynamic_block(lit_lens: dict, dist_lens: dict, tokens, final: bool = True) -> bytes:
    """One dynamic-Huffman block with the given ``{symbol: length}`` codes
    (its code-length code gives symbols 0-15 four bits each).  Tokens:
    ``("lit", byte)``, ``("copy", length, dist)`` (dist None writes the
    length alone) and ``("bits", value, n)`` for raw bits."""
    from hadoop_bam_tpu_torch.ops.flate import (CLC_ORDER, DIST_BASE, DIST_EXTRA, LEN_BASE,
                                                LEN_EXTRA)

    bw = _BitWriter()
    nlen = max(257, max(lit_lens) + 1)
    ndist = max(1, max(dist_lens, default=0) + 1)
    bw.w(int(final), 1)
    bw.w(2, 2)
    bw.w(nlen - 257, 5)
    bw.w(ndist - 1, 5)
    bw.w(19 - 4, 4)
    for k in range(19):
        bw.w(4 if CLC_ORDER[k] < 16 else 0, 3)
    for n in [lit_lens.get(s, 0) for s in range(nlen)] + [dist_lens.get(s, 0) for s in range(ndist)]:
        bw.code(n, 4)
    lit, dst = _canonical(lit_lens), _canonical(dist_lens)
    for t in tokens:
        if t[0] == "lit":
            bw.code(*lit[t[1]])
        elif t[0] == "bits":
            bw.w(t[1], t[2])
        else:
            sym, x, n = _base_sym(LEN_BASE, LEN_EXTRA, t[1], 257)
            bw.code(*lit[sym])
            bw.w(x, n)
            if t[2] is not None:
                sym, x, n = _base_sym(DIST_BASE, DIST_EXTRA, t[2])
                bw.code(*dst[sym])
                bw.w(x, n)
    bw.code(*lit[256])
    return bw.bytes()


def _replay(tokens) -> bytes:
    out = bytearray()
    for t in tokens:
        if t[0] == "lit":
            out.append(t[1])
        else:
            for _ in range(t[1]):
                out.append(out[-t[2]])
    return bytes(out)


def _zlib_payload(comp: bytes, isize: int):
    """zlib's verdict on a raw DEFLATE member: its payload, or None."""
    d = zlib.decompressobj(-15)
    try:
        got = d.decompress(comp, isize + 1)
    except zlib.error:
        return None
    return got if d.eof and len(got) == isize else None


def inflate_edge_cases(seed: int) -> list:
    """``[(name, comp, isize, payload or None)]``: codes longer than the
    inflate kernel's root tables (hand-made and zlib's), lone length-1
    codes and the unused half of one, incomplete sets zlib refuses, far (dist 32,768) and overlapping
    (len 258, dist 1) copies, a copy from before the member start, a
    65,535-byte stored block, copies out of a stored block's payload, isize
    65,536 and above, and wrong-isize twins."""
    import struct

    from hadoop_bam_tpu_torch.ops.flate import DIST_BASE, DIST_EXTRA, encode_tokens_fixed

    rng = np.random.default_rng(seed)
    cases = []

    def add(name, comp, payload, isize=None):
        cases.append((name, comp, len(payload) if isize is None else isize, payload))

    # Literal codes of 1..13 bits and four of 15 (one literal, the EOB and two
    # length symbols); distance codes of 1..14 bits and two of 15.
    lits = list(range(65, 78))
    lit_lens = {s: k + 1 for k, s in enumerate(lits)}
    lit_lens.update({90: 15, 256: 15, 257: 15, 265: 15})
    dist_lens = {s: s + 1 for s in range(14)}
    dist_lens.update({14: 15, 15: 15})
    toks, n_out = [], 0
    for k in range(3000):
        r = rng.random()
        if k < 40 or r < 0.5:
            toks.append(("lit", int(rng.choice(lits + [90]))))
            n_out += 1
            continue
        length = 3 if r < 0.75 else int(rng.integers(11, 13))
        ds = int(rng.integers(0, 16))
        dist = int(DIST_BASE[ds]) + int(rng.integers(0, 1 << int(DIST_EXTRA[ds])))
        if dist > n_out:
            dist = int(rng.integers(1, n_out + 1))
        toks.append(("copy", length, dist))
        n_out += length
    add("long_codes", _dynamic_block(lit_lens, dist_lens, toks), _replay(toks))
    fib = [1, 2]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    sk = np.repeat(np.arange(20, dtype=np.uint8) * 7 + 33, fib)
    sk = bytes(rng.permutation(sk))
    add("fibonacci_zlib9", _raw_deflate(sk, 9), sk)
    lone = [("lit", 97), ("copy", 3, 1), ("copy", 3, 1)]
    add("lone_dist_code", _dynamic_block({97: 1, 256: 2, 257: 2}, {0: 1}, lone), b"a" * 7)
    add("lone_dist_unused", _dynamic_block(
        {97: 1, 256: 2, 257: 2}, {0: 1}, [("lit", 97), ("copy", 3, None), ("bits", 1, 1)]),
        None, 4)
    add("lone_eob_code", _dynamic_block({256: 1}, {0: 1}, []), b"")
    # Incomplete sets zlib refuses: a lone code of length 2, two codes of three.
    add("lone_dist_len2", _dynamic_block({97: 1, 256: 2, 257: 2}, {0: 2}, lone), None, 7)
    add("incomplete_lit", _dynamic_block({97: 1, 256: 2}, {0: 1}, [("lit", 97)]), None, 1)
    far = [("lit", int(x)) for x in rng.integers(0, 256, 32768)]
    far += [("copy", 258, 32768), ("copy", 3, 32768)]
    add("dist_32768", encode_tokens_fixed(far), _replay(far))
    before = [("lit", int(x)) for x in rng.integers(0, 256, 100)] + [("copy", 5, 101)]
    add("dist_before_start", encode_tokens_fixed(before), None, 105)
    run = [("lit", 97)] + [("copy", 258, 1)] * 200
    add("len258_dist1", encode_tokens_fixed(run), _replay(run))
    add("len258_dist1_zlib6", _raw_deflate(b"a" * 65280, 6), b"a" * 65280)
    stored = bytes(rng.integers(0, 256, 65535, dtype=np.uint8))
    add("stored_65535", bytes([1]) + struct.pack("<HH", 65535, 0) + stored, stored)
    # Copies that read a stored block's payload, near and far back.
    head = stored[:20000]
    tail = [("copy", 50, 10000), ("copy", 20, 19000), ("copy", 9, 3)]
    add("stored_then_copies", bytes([0]) + struct.pack("<HH", len(head), len(head) ^ 0xFFFF)
        + head + encode_tokens_fixed(tail), _replay([("lit", x) for x in head] + tail))
    bases = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 100_000))
    for size in (65536, 100_000):
        p = bases[:size]
        comp = _raw_deflate(p, 6)
        add(f"isize_{size}", comp, p)
        add(f"isize_{size}_wrong", comp, None, size + 1 if size == 65536 else size - 1)
    return cases


def inflate_corpus(seed: int):
    """``(comps, isizes, payloads)``: zlib levels 0/1/6/9, a flush chain,
    RLE codes, full-size members, four corrupt members (payload None),
    :func:`inflate_edge_cases` and 200 bit-flipped members (payload: zlib's
    verdict)."""
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
    for _, comp, isize, payload in inflate_edge_cases(seed):
        add(comp, payload, isize)
    small = [(c, n) for c, n, p in zip(comps, isizes, payloads) if p is not None and len(c) < 4096]
    for k in range(200):
        comp, isize = small[k % len(small)]
        flipped = bytearray(comp)
        for _ in range(1 + k % 3):
            bit = int(rng.integers(0, 8 * len(flipped)))
            flipped[bit >> 3] ^= 1 << (bit & 7)
        add(bytes(flipped), _zlib_payload(bytes(flipped), isize), isize)
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


def bam_records(rng, lengths) -> bytes:
    """BAM-framed records of the given lengths (4 + block_size each, at
    least 36) whose bodies are half zero bytes and half random ones, so that
    many positions inside a record read a plausible size word."""
    out = []
    for ln in lengths:
        body = rng.integers(0, 256, ln - 4, dtype=np.uint8)
        body[rng.random(ln - 4) < 0.5] = 0
        out.append(struct.pack("<I", ln - 4) + body.tobytes())
    return b"".join(out)


def chain_starts(stream: bytes) -> list:
    """The chain positions of a clean record stream, its end included."""
    offs = [0]
    while offs[-1] < len(stream):
        offs.append(offs[-1] + 4 + struct.unpack_from("<I", stream, offs[-1])[0])
    return offs


def chain_trouble_cases(seed: int, seg: int, slab: int, big: bool = False) -> dict:
    """``(stream, n_bytes, ok)`` of the record-chain walk's trouble cases for
    the card's walk in segments of ``seg`` bytes and slabs of ``slab``
    (``stream`` a uint8 array of at least ``n_bytes``): records straddling
    segments and slabs, a record past 64 KiB, records on segment boundaries and in a segment's
    last 1-36 bytes (the key fields of a record starting in the last 20 past
    the segment), n_bytes inside a last record's key fields, a false chain of plausible size words inside a long
    read, size words 31 and 2^28 + 1 in the first, a middle and the last
    segment and at 0, the 2^28 edge, overruns and 1-3 trailing bytes, views
    whose bytes past ``n_bytes`` are set, minimal records and the empty
    stream.  ``ok`` is the walk's verdict.  ``big`` adds a valid 2^28-byte
    record (a 268 MB stream) and nine of them (2.4 GB, offsets past 2^31)."""
    rng = np.random.default_rng(seed)
    S = seg
    cases = {}

    def fill(nbytes: int) -> list:
        out = []
        while sum(out) < nbytes:
            out.append(int(rng.integers(36, 400)))
        return out

    def add(what: str, stream: bytes, ok: int, n: int = -1) -> None:
        cases[what] = (np.frombuffer(stream, np.uint8).copy(), len(stream) if n < 0 else n, ok)

    varied = bam_records(rng, fill(S) + [S + 1] + fill(S) + [5 * S // 2] + fill(S)
                         + [3 * S + 17] + fill(S))
    add("varied lengths, records past a segment", varied, 1)
    add("a record past a slab", bam_records(rng, fill(S) + [slab + S + 123] + fill(S)), 1)
    add("a 100,000-byte record", bam_records(rng, fill(S) + [100_000] + fill(S)), 1)
    quarter = S // 4 if S // 4 >= 36 else S
    add("records on segment boundaries", bam_records(rng, [quarter] * 24), 1)
    add("records filling two slabs exactly", bam_records(rng, [quarter] * (2 * slab // quarter)), 1)
    add("records in a segment's last 1-36 bytes", bam_records(rng, [S - 1] * 37), 1)
    # A long read whose bases and qualities hold a chain of plausible 40-byte
    # records, 4 bytes off, across three segments and past the read's end.
    fakes = b"".join(struct.pack("<I", 36) + rng.integers(0, 256, 36, dtype=np.uint8).tobytes()
                     for _ in range(3 * S // 40 + 4))
    body = 3 * S + 11
    read = struct.pack("<I", body) + (bytes(4) + fakes)[:body]
    add("a false chain inside a long read",
        bam_records(rng, fill(2 * S)) + read + bam_records(rng, fill(S)), 1)
    errs = bam_records(rng, fill(4 * S + 100))
    offs = chain_starts(errs)[:-1]
    places = (("at 0", 0), ("in the first segment", [o for o in offs if o < S][-1]),
              ("in a middle segment", min(o for o in offs if o >= 2 * S)),
              ("in the last record", offs[-1]))
    for where, at in places:
        for word in (31, (1 << 28) + 1):
            bad = bytearray(errs)
            struct.pack_into("<I", bad, at, word)
            add(f"block_size {word} {where}", bytes(bad), 0)
    for word, ok in ((32, 1), (1 << 28, 0), ((1 << 28) + 1, 0)):
        rec = struct.pack("<I", word) + rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        add(f"block_size {word} in a short stream",
            bam_records(rng, fill(2 * S)) + rec + bam_records(rng, fill(S)), ok)
    cut = bam_records(rng, fill(3 * S))
    add("a truncated last record", cut[: chain_starts(cut)[-2] + 20], 0)
    for c in (2, 6, 10, 14, 19):  # the key fields end 20 bytes into a record
        add(f"n_bytes {c} bytes into the last record", cut + bam_records(rng, [40]), 0,
            len(cut) + c)
    for tail, what in ((b"\x28", "1 trailing byte reading 40"), (b"\x05\x00", "2 trailing bytes"),
                       (b"\x20\x00\x00", "3 trailing bytes reading 32"),
                       (b"\x1f\x00\x00", "3 trailing bytes reading 31")):
        add(what, varied + tail, 0)
    add("bytes past n_bytes set", varied + b"\xff" * 77, 1, len(varied))
    add("n_bytes inside the last record", varied + b"\xff" * 77, 0, len(varied) - 10)
    add("minimal 36-byte records", bam_records(rng, [36] * (4 * S // 36 + 7)), 1)
    add("an empty stream", b"", 1)
    if big:
        add("a 2^28-byte record", bam_records(rng, fill(S)) + struct.pack("<I", 1 << 28)
            + bytes(1 << 28) + bam_records(rng, fill(S)), 1)
        step = 4 + (1 << 28)
        nine = np.zeros(9 * step, np.uint8)
        for k in range(9):
            nine[k * step : k * step + 4] = np.frombuffer(struct.pack("<I", 1 << 28), np.uint8)
        cases["nine 2^28-byte records, offsets past 2^31"] = (nine, len(nine), 1)
    return cases


def check_chain_walk(cases: dict, seg: int, slab: int) -> dict:
    """The record-chain walk at segments of ``seg`` bytes and slabs of
    ``slab`` against its plain version (offsets, count and ok, exactly) on
    each ``(stream, n_bytes, ok)`` case, from a view 1-15 bytes past an
    aligned tensor with the emit's keys of three rows more than the walk
    finds (against ``stream_keys_plain``), and from an aligned copy without.
    Returns ``{what: [count, ok]}``."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import chain as kch

    verdicts = {}
    for j, (what, (stream, n, ok)) in enumerate(cases.items()):
        t = torch.from_numpy(stream)
        offs_p, meta_p = kch.record_chain_plain(t, n)
        count = int(meta_p[0])
        keys_p, unm_p = kch.stream_keys_plain(t, n, offs_p, meta_p, count + 3)
        shift = 1 + j % 15
        g = torch.zeros(len(stream) + shift, dtype=torch.uint8, device="cuda")
        g[shift:] = t.cuda()
        for view, n_rows in ((g[shift:], count + 3), (g[shift:].clone(), None)):
            offs_k, meta_k, _, _, keys_k, unm_k = kch._launch(view, n, seg, slab, n_rows=n_rows)
            if meta_k.cpu().tolist() != meta_p.tolist():
                raise AssertionError(f"record_chain [count, ok] differs from plain ({what}, seg "
                                     f"{seg}): {meta_k.cpu().tolist()} vs {meta_p.tolist()}")
            if not torch.equal(offs_k[:count].cpu(), offs_p[:count]):
                raise AssertionError(f"record_chain offsets differ from plain ({what}, seg {seg})")
            if n_rows is not None and not (torch.equal(keys_k.cpu(), keys_p)
                                           and torch.equal(unm_k.cpu(), unm_p)):
                raise AssertionError(f"record_chain keys differ from plain ({what}, seg {seg})")
        if int(meta_p[1]) != ok:
            raise AssertionError(f"record_chain verdict {meta_p.tolist()} for {what}")
        verdicts[what] = meta_p.tolist()
        del t, g, offs_k, offs_p, keys_k, unm_k
    return verdicts


def check_chain(seed: int) -> dict:
    """Phase 4: the walk with its fused keys, and the standalone key gather,
    against their plain versions, exactly, on a clean stream and on one with
    a corrupt size word; then the walk and its keys on the trouble cases."""
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
            res[dev] = [x.cpu().numpy() for x in kch.record_chain_keys(t, len(arr), n_rows)]
            if dev == "cuda":  # the standalone gather at the walk's offsets
                res["alone"] = [x.cpu().numpy() for x in kch.stream_keys(
                    t, len(arr), *[torch.from_numpy(x).cuda() for x in res[dev][:2]], n_rows)]
        (ok_, mk, kk, uk), (op, mp, kp, up) = res["cuda"], res["cpu"]
        cnt = int(mk[0])
        if not (np.array_equal(mk, mp) and np.array_equal(ok_[:cnt], op[:cnt])
                and np.array_equal(kk, kp) and np.array_equal(uk, up)):
            raise AssertionError(f"chain kernel (walk + fused keys) differs from plain ({case})")
        if not (np.array_equal(res["alone"][0], kp) and np.array_equal(res["alone"][1], up)):
            raise AssertionError(f"stream_keys kernel differs from plain ({case})")
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
    log(f"chain walk with fused keys and stream_keys == plain: {n_rows} records, corrupt "
        "stream rejected")
    verdicts = check_chain_walk(chain_trouble_cases(seed, kch.SEG, kch.SLAB, big=True),
                                kch.SEG, kch.SLAB)
    log(f"record_chain == plain at seg {kch.SEG}, slab {kch.SLAB}: {len(verdicts)} streams "
        f"[count, ok] {json.dumps(verdicts)}")
    tiny = chain_trouble_cases(seed + 1, 512, 2048)
    tiny["the key corpus"] = (s, len(s), 1)
    verdicts = check_chain_walk(tiny, 512, 2048)
    log(f"record_chain == plain at seg 512, slab 2048: {len(verdicts)} streams "
        f"[count, ok] {json.dumps(verdicts)}")
    return {"max_abs_err": 0.0}


def write_view(rng, numel: int, at: int) -> np.ndarray:
    """``numel`` random bytes starting ``at`` bytes past a 16-byte boundary
    of a larger random buffer (a stream that is a view)."""
    buf = rng.integers(0, 256, 16 + at + numel + 64, dtype=np.uint8)
    start = (-buf.ctypes.data) % 16 + at
    return buf[start : start + numel]


def on_card_at(view: np.ndarray):
    """``view`` on the card at the same residue mod 16 (a view of a larger
    card buffer)."""
    import torch

    at = view.ctypes.data % 16
    buf = torch.empty(at + view.size + 16, dtype=torch.uint8, device="cuda")
    t = buf[at : at + view.size]
    t.copy_(torch.from_numpy(np.ascontiguousarray(view)))
    return t


#: Member lengths of the CRC trouble cases, each at every residue mod 16.
CRC_LENGTHS = (0, 1, 3, 15, 16, 17, 4095, 57088, 65536)


def crc_trouble_cases(seed: int) -> dict:
    """Row 3c's trouble cases, ``name -> (stream, offs, lens)``: every
    length of ``CRC_LENGTHS`` at every residue mod 16; members ending at the
    stream's last byte, the stream a view at odd offsets; members inside a
    short view (empty ones included)."""
    rng = np.random.default_rng(seed + 16)
    cases = {}
    offs, lens, at = [], [], 0
    for n in CRC_LENGTHS:
        for r in range(16):
            offs.append(at + r)
            lens.append(n)
            at += 16 * (1 + n // 64)
    s = write_view(rng, max(o + n for o, n in zip(offs, lens)), 0)
    cases["every length at every residue"] = (s, offs, lens)
    for at in (1, 7, 13):
        numel = 70000 + at
        s = write_view(rng, numel, at)
        ln = [1, 2, 3, 4, 5, 15, 16, 17, 31, 33, 4095, 57088, numel]
        cases[f"members ending at the last byte, a view at +{at}"] = (
            s, [numel - n for n in ln], ln)
    s = write_view(rng, 300, 5)
    cases["members inside a short view"] = (s, [0, 0, 1, 2, 3, 150, 299, 300, 17],
                                            [300, 1, 299, 4, 0, 150, 1, 0, 283])
    return cases


def gather_trouble_cases(seed: int) -> dict:
    """Row 3b's trouble cases, ``name -> (stream, src, lens, dup, bits)``:
    every (src, dst) residue pair mod 16; records of 0, 1, 2, 36 bytes and
    64 KiB, one ending at the stream's last byte; duplicate flags whose
    bytes 18 and 19 straddle a 16-byte chunk (and, at small tiles, a tile);
    a part of records of 36-600 bytes; no mark column; one 1-byte record."""
    from hadoop_bam_tpu_torch.ops.kernels.gather import FLAG_DUPLICATE

    rng = np.random.default_rng(seed + 17)
    cases = {}
    # Record k starts at dst residue k % 16 (lengths 1 mod 16) and src
    # residue k // 16.
    k = np.arange(256)
    ln = 17 + 16 * rng.integers(0, 4, 256)
    src = 16 * rng.integers(0, 300, 256) + k // 16
    s = write_view(rng, int((src + ln).max()) + 3, 3)
    cases["every src / dst residue pair"] = (s, src, ln, rng.random(256) < 0.5, FLAG_DUPLICATE)
    ln = np.array([0, 1, 2, 36, 65536, 0, 0, 36, 1, 2, 0, 19, 20, 18, 65536, 37, 0], np.int64)
    s = write_view(rng, 140000, 9)
    src = rng.integers(0, s.size - ln + 1)
    src[-2] = s.size - ln[-2]
    cases["records of 0-36 bytes and 64 KiB"] = (s, src, ln, np.ones(len(ln), bool), 0xA55A)
    ln = np.array([13] + [48] * 12, np.int64)  # the second record starts at 13 mod 16
    s = write_view(rng, 4000, 1)
    src = rng.integers(0, s.size - 48, len(ln))
    cases["flags straddling a chunk and a tile"] = (s, src, ln, np.ones(len(ln), bool), 0x0401)
    s = write_view(rng, 300000, 0)
    ln = rng.integers(36, 600, 900)
    src = rng.integers(0, s.size - ln)
    cases["a part of records"] = (s, src, ln, rng.random(900) < 0.1, FLAG_DUPLICATE)
    cases["no mark column"] = (s, src[:100], ln[:100], None, FLAG_DUPLICATE)
    cases["one record of one byte"] = (s[:1], np.array([0]), np.array([1]), np.array([1]), 0xFFFF)
    return cases


def host_gather(stream, src, lens, dup, bits) -> np.ndarray:
    """The records joined, then the flag bytes ORed in, as ``io/bam.py``'s
    ``patch_flags`` does."""
    out = np.frombuffer(b"".join(stream[s : s + n].tobytes() for s, n in zip(src, lens)),
                        np.uint8).copy()
    if dup is not None:
        starts = np.cumsum(lens) - lens
        for d, n, m in zip(starts, lens, dup):
            if m and n > 18:
                out[d + 18] |= bits & 0xFF
            if m and n > 19:
                out[d + 19] |= (bits >> 8) & 0xFF
    return out


#: Row 3c's geometries checked on the card, (threads, bytes a thread a
#: round): the default first, one warp of 16-byte pieces, the largest.
CRC_GEOMETRIES = ((128, 32), (32, 16), (256, 64), (256, 256))
#: Row 3b's, (tile bytes, threads): the default first, one chunk a thread
#: of tiny tiles, longer runs of chunks a thread.
GATHER_GEOMETRIES = ((2048, 64), (64, 32), (4096, 256), (16384, 128))


def check_crc32(seed: int) -> dict:
    """The CRC32 kernel against its plain version and zlib: empty, 1-byte,
    word-boundary, unaligned, multi-member and full-size windows, then
    ``crc_trouble_cases`` (from card views at the same residues) at each of
    ``CRC_GEOMETRIES``."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import crc32 as kcrc

    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 256, 3 * 0xDF00, dtype=np.uint8)
    offs = np.array([0, 0, 10, 64, 100, 17, 2995, 0, 3, 0xDF00, 5], dtype=np.int64)
    lens = np.array([0, 1, 4, 256, 123, 33, 5, 3000, 0xDF00, 0xDF00, 1], dtype=np.int64)
    got = kcrc.crc32_device(torch.from_numpy(stream).cuda(), offs, lens).cpu()
    plain = kcrc.crc32_device(torch.from_numpy(stream), offs, lens)
    k = got.view(torch.int32).numpy().view(np.uint32).astype(np.int64)
    p = plain.view(torch.int32).numpy().view(np.uint32).astype(np.int64)
    want = np.array([zlib.crc32(stream[o : o + n].tobytes()) for o, n in zip(offs, lens)])
    if not (np.array_equal(k, p) and np.array_equal(k, want)):
        raise AssertionError(f"crc32 kernel {k} plain {p} zlib {want}")
    log(f"crc32 kernel == plain == zlib: {len(offs)} windows, max_abs_err 0")
    members = 0
    for what, (s, o, n) in crc_trouble_cases(seed).items():
        plain = kcrc.crc32_device(torch.from_numpy(s), o, n).view(torch.int32).numpy()
        want = np.array([zlib.crc32(s[a : a + b]) for a, b in zip(o, n)], np.uint32)
        if not np.array_equal(plain.view(np.uint32), want):
            raise AssertionError(f"crc32 plain != zlib on {what}")
        g = on_card_at(s)
        ot, lt = kcrc._columns(np.asarray(o, np.int64), np.asarray(n, np.int64), g.device)
        for threads, w in CRC_GEOMETRIES:
            if (threads, w) == (kcrc.THREADS, kcrc.W):
                got = kcrc.crc32_device(g, o, n).view(torch.int32)
            else:
                got = torch.empty(len(o), dtype=torch.int32, device="cuda")
                kcrc._launch(g, ot, lt, got, threads, w)
            if not np.array_equal(got.cpu().numpy(), plain):
                raise AssertionError(f"crc32 kernel at {threads} threads, w {w} != plain on "
                                     f"{what}")
        members += len(o)
    log(f"crc32 kernel == plain == zlib on the trouble cases ({members} members, views at "
        f"every residue) at (threads, w) {list(CRC_GEOMETRIES)}, max_abs_err 0")
    return {"max_abs_err": float(np.abs(k - p).max())}


def check_gather(seed: int) -> dict:
    """The gather kernel against its plain version and the host gather +
    ``patch_flags``, on a permuted record stream with a duplicate mask, then
    ``gather_trouble_cases`` (from card views at the same residues) at each
    of ``GATHER_GEOMETRIES``."""
    import torch

    from hadoop_bam_tpu_torch.io.bam import RecordBatch, gather_record_array, patch_flags
    from hadoop_bam_tpu_torch.ops.kernels import gather as kg
    from hadoop_bam_tpu_torch.spec import bam

    rng = np.random.default_rng(seed)
    s = chain_stream(seed)
    offs, _ = bam.record_chain_partial(s, 0, len(s))
    soa = bam.soa_decode(s, offs)
    order = rng.permutation(len(offs))
    dup = rng.random(len(offs)) < 0.3
    src = (soa["rec_off"] - 4)[order]
    ln = (soa["rec_len"] + 4)[order]
    host = gather_record_array(RecordBatch(soa=soa, data=s, keys=np.empty(0)), order).copy()
    patch_flags(host, (np.cumsum(ln) - ln)[dup[order]])
    k, total = kg.gather_stream_device(torch.from_numpy(s).cuda(), src, ln, dup_mask=dup[order])
    p, _ = kg.gather_stream_device(torch.from_numpy(s), src, ln, dup_mask=dup[order])
    k = k.cpu().numpy()
    if not (total == len(host) and np.array_equal(k, p.numpy()) and np.array_equal(k, host)):
        raise AssertionError("gather kernel differs from plain / host gather")
    log(f"gather kernel == plain == host gather + patch_flags: {len(offs)} records, "
        f"{int(dup.sum())} marked, max_abs_err 0")
    records = 0
    for what, (st, sr, n, d, bits) in gather_trouble_cases(seed).items():
        plain, _ = kg.gather_stream_device(torch.from_numpy(st), sr, n, dup_mask=d, bits=bits)
        plain = plain.numpy()
        if not np.array_equal(plain, host_gather(st, sr, n, d, bits)):
            raise AssertionError(f"gather plain != host gather on {what}")
        g = on_card_at(st)
        cols = kg._columns(np.asarray(sr, np.int64), np.asarray(n, np.int64),
                           None if d is None else np.asarray(d, np.uint8), g.device)
        for tile, threads in GATHER_GEOMETRIES:
            if (tile, threads) == (kg.TILE, kg.THREADS):
                got, _ = kg.gather_stream_device(g, sr, n, dup_mask=d, bits=bits)
            else:
                got = torch.full((len(plain),), 0xA5, dtype=torch.uint8, device="cuda")
                tf = torch.empty(-(-len(plain) // tile), dtype=torch.int32, device="cuda")
                kg._launch(g, *cols, bits, got, tf, tile, threads)
            if not np.array_equal(got.cpu().numpy(), plain):
                raise AssertionError(f"gather kernel at tile {tile}, {threads} threads != plain "
                                     f"on {what}")
        records += len(sr)
    log(f"gather kernel == plain == host gather on the trouble cases ({records} records, views "
        f"at every residue) at (tile, threads) {list(GATHER_GEOMETRIES)}, max_abs_err 0")
    # The wrapper's checks (on the card there) refuse what the plain path does.
    st = np.zeros(1000, np.uint8)
    for src_b, ln_b in (([0, 990], [5, 20]), ([-1, 0], [3, 3]), ([0, 0], [4, -1]),
                        ([2**31 - 2, 0], [4, 1]), ([0], [2**31])):
        raised = []
        for t in (torch.from_numpy(st), torch.from_numpy(st).cuda()):
            try:
                kg.gather_stream_device(t, src_b, ln_b)
                raised.append(None)
            except (IndexError, ValueError) as e:
                raised.append(type(e).__name__)
        if raised[0] is None or raised[0] != raised[1]:
            raise AssertionError(f"gather checks differ on src {src_b}, lens {ln_b}: {raised}")
    log("gather wrapper on the card raises as the plain path on 5 bad geometries")
    return {"max_abs_err": float(np.count_nonzero(k != p.numpy()))}


def _far_repeat(rng, at: int) -> bytes:
    """40 nonzero random bytes at 0 and again at ``at``, zeros between and
    after: the zero run enters the hash heads at one slot only, so the
    second copy finds the first at distance ``at`` (a copy at 32,768, a
    literal run at 32,769)."""
    x = bytes(rng.integers(1, 256, 40, dtype=np.uint8))
    return x + bytes(at - len(x)) + x + bytes(100)


def deflate_trouble_cases(seed: int) -> dict:
    """Where a 32-position scan window can go wrong: in-window hash
    collisions (small alphabets; the narrowest heads take ``hb`` = 8),
    periods shorter than a window (every lane matches), the last three
    bytes of a member inside a window, distances of exactly 32,768 and
    32,769, copies that reach ``plen`` or 258 bytes, members of 0-3
    bytes."""
    rng = np.random.default_rng(seed + 11)
    motif = b"GATTACA-"
    cases = {
        "empty": b"", "one_byte": b"A", "three_bytes": b"ACG",
        "collide_3_symbols": bytes(rng.integers(0, 3, 3000, dtype=np.uint8)),
        "collide_random": bytes(rng.integers(0, 256, 3000, dtype=np.uint8)),
        "period_1": b"\0" * 1000, "period_2": b"ab" * 200, "period_3": b"abc" * 300,
        "period_31": bytes(rng.integers(0, 256, 31, dtype=np.uint8)) * 40,
        "period_33": bytes(rng.integers(0, 256, 33, dtype=np.uint8)) * 40,
        "copy_258": b"Q" + b"xyz" * 300,
        "copy_to_plen": bytes(rng.integers(0, 256, 300, dtype=np.uint8)) * 2,
        "dist_32768": _far_repeat(rng, 1 << 15),
        "dist_32769": _far_repeat(rng, (1 << 15) + 1),
    }
    for n in (33, 34, 35, 66, 67, 129):  # the last 1-3 bytes inside a window
        cases[f"tail_{n}"] = (motif * 20)[:n]
    return cases


def deflate_corpus(seed: int) -> list:
    """The reference's edge cases: empty, 3 bytes, zero runs, random bytes,
    BAM records, a member exactly at a chunk multiple, full-size members;
    then :func:`deflate_trouble_cases`."""
    rng = np.random.default_rng(seed)
    s = chain_stream(seed).tobytes()
    synth = synth_records(0, 210, rng).reshape(-1).tobytes()
    return [
        b"", b"ACG", b"\0" * 480, b"\0" * 20000,
        bytes(rng.integers(0, 256, 400, dtype=np.uint8)),
        bytes(rng.integers(0, 4, 3000, dtype=np.uint8)),
        s[:500], s[1000:9192], (b"part-write-cap!!" * 1024)[:8192],
        synth[:0xDF00], synth[5:5 + 0xDF00], bytes(rng.integers(0, 256, 0xDF00, dtype=np.uint8)),
    ] + list(deflate_trouble_cases(seed).values())


def _deflate_both(payloads, **kw):
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import deflate as kd

    P = max(1, max(len(p) for p in payloads))
    mat = np.zeros((len(payloads), P), dtype=np.uint8)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    lens = np.array([len(p) for p in payloads], dtype=np.int64)
    k = [t.cpu().numpy() for t in kd.deflate_lanes(torch.from_numpy(mat).cuda(), lens, **kw)]
    p = [t.numpy() for t in kd.deflate_lanes(torch.from_numpy(mat), lens, **kw)]
    return k, p


def check_deflate_rows(payloads, comp, clens, ok, what: str) -> None:
    """Every accepted row decodes to its payload through zlib and through
    the port's inflate kernel."""
    rows = [comp[i, : clens[i]].tobytes() for i in range(len(payloads)) if ok[i]]
    want = [p for i, p in enumerate(payloads) if ok[i]]
    for i, (c, p) in enumerate(zip(rows, want)):
        d = zlib.decompressobj(-15)
        if d.decompress(c) != p or not d.eof:
            raise AssertionError(f"{what}: row {i} does not inflate to its payload (zlib)")
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin

    args = pack_members(rows, [len(p) for p in want], "cuda")
    meta = kin.inflate_members(*args).cpu().numpy()
    out = args[5].cpu().numpy()
    oo = args[3].cpu().numpy()
    for i, p in enumerate(want):
        o = int(oo[i])
        if not (meta[i, 1] == 1 and out[o : o + len(p)].tobytes() == p):
            raise AssertionError(f"{what}: row {i} does not inflate to its payload (kernel)")


def check_deflate(seed: int) -> dict:
    """The deflate kernel against its plain version (rows, clens, ok), at
    the default chunk and at chunk_bytes=512 (narrower hash heads), with a
    max_clen decline; every row through zlib and the inflate kernel."""
    payloads = deflate_corpus(seed)
    bad = 0
    clens = None
    for kw in ({}, {"max_clen": 2000}):
        (kc, kl, ko), (pc, pl, po) = _deflate_both(payloads, **kw)
        clens = kl if clens is None else clens
        if not (np.array_equal(kl, pl) and np.array_equal(ko, po) and np.array_equal(kc, pc)):
            raise AssertionError(f"deflate kernel differs from plain ({kw})")
        bad += int(np.count_nonzero(kc != pc))
        if not kw and not ko.all():
            raise AssertionError(f"deflate declined accepted members: {ko}")
        check_deflate_rows(payloads, kc, kl, ko, f"deflate {kw}")
    trouble = deflate_trouble_cases(seed)
    small = [p for p in payloads if len(p) <= 9000] + [
        p for p in trouble.values() if len(p) > 9000]
    (kc, kl, ko), (pc, pl, po) = _deflate_both(small, chunk_bytes=512)
    if not (np.array_equal(kl, pl) and np.array_equal(ko, po) and np.array_equal(kc, pc)):
        raise AssertionError("deflate kernel differs from plain (chunk_bytes=512)")
    check_deflate_rows(small, kc, kl, ko, "deflate chunk 512")
    log(f"deflate kernel == plain: {len(payloads)} members (+{len(small)} at chunk 512), "
        f"clens {clens.tolist()}; every row inflates through zlib and the inflate kernel, "
        "max_abs_err 0")
    check_deflate_widths(list(trouble.values()))
    return {"max_abs_err": float(bad)}


def _member_tensors(payloads, device):
    """Payloads in one stream at offsets that put every lead (offset mod
    16) in play: ``(stream, offs, lens, max_plen)``."""
    import torch

    parts, offs, pos = [], [], 0
    for i, p in enumerate(payloads):
        gap = (5 * i) % 16
        parts.append(bytes(gap))
        offs.append(pos + gap)
        parts.append(p)
        pos += gap + len(p)
    stream = np.frombuffer(b"".join(parts) + bytes(16), dtype=np.uint8).copy()
    lens = np.array([len(p) for p in payloads], dtype=np.int32)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(stream), t(np.array(offs, dtype=np.int64)), t(lens), int(lens.max(initial=0))


def token_counts(stream, offs, lens, hb: int) -> np.ndarray:
    """``[n, 2]`` literals and copies of the plain version's token rows."""
    from hadoop_bam_tpu_torch.ops.kernels import deflate as kd

    tok, ntok, _ = kd._match_waves(stream.numpy(), offs.numpy().astype(np.int64),
                                   lens.numpy().astype(np.int64), hb)
    live = np.arange(tok.shape[1])[None, :] < ntok[:, None]
    cpy = (((tok >> 30) & 1) == 1) & live
    return np.stack([ntok - cpy.sum(axis=1), cpy.sum(axis=1)], axis=1)


def check_deflate_widths(payloads) -> None:
    """``deflate_members`` straight, at every hash width (8..11), on the
    trouble cases at assorted leads: rows, clens and ok equal the plain
    version's, and the kernel's literal and copy counts equal the plain
    version's tokens."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import deflate as kd

    cpu = _member_tensors(payloads, "cpu")
    dev = _member_tensors(payloads, "cuda")
    row = kd.out_bytes(max(cpu[3], 1)) + 3
    n = len(payloads)
    for hb in (8, 9, 10, 11):
        counts = torch.zeros((n, 3), dtype=torch.int32, device="cuda")
        kc, kl, ko = [t.cpu().numpy() for t in kd.deflate_members(*dev, hb, row, counts=counts)]
        pc, pl, po = [t.numpy() for t in kd.deflate_members(*cpu, hb, row)]
        if not (np.array_equal(kl, pl) and np.array_equal(ko, po) and np.array_equal(kc, pc)):
            raise AssertionError(f"deflate kernel differs from plain at hb {hb}")
        want = token_counts(*cpu[:3], hb)
        if not np.array_equal(counts.cpu().numpy()[:, :2], want):
            raise AssertionError(f"deflate kernel's token counts differ from plain at hb {hb}")
    log(f"deflate kernel == plain at hb 8..11: {n} trouble cases (0-32,909 bytes), "
        "token counts equal")


# ---------------------------------------------------------------------------
# FASTQ: corpus and the record-scan kernel
# ---------------------------------------------------------------------------

READ_LEN = 151
SCAN_CHUNK = 0xDF00  # the ingest's default claim region
SCAN_OVERLAP = 2048


def fastq_pairs(n_pairs: int, seed: int, crlf: bool = False, at_quals: bool = False):
    """``(r1, r2)`` FASTQ texts of ``n_pairs`` read pairs: 151 bp reads with
    Phred+33 qualities and CASAVA 1.8 ids
    (``@INST:RUN:FC:LANE:TILE:X:Y 1:N:0:BARCODE``) in cluster order (lane,
    tile, then a random walk of X/Y), not in name order.  ``at_quals``
    starts every third quality string with ``@``."""
    rng = np.random.default_rng(seed)
    eol = b"\r\n" if crlf else b"\n"
    lane = 1 + (np.arange(n_pairs) * 4 // max(n_pairs, 1))
    tile = 1101 + (np.arange(n_pairs) * 96 // max(n_pairs, 1)) % 24
    x = rng.integers(1000, 32000, n_pairs)
    y = np.cumsum(rng.integers(1, 40, n_pairs)) % 40000 + 1000
    texts = []
    for mate in (1, 2):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n_pairs, READ_LEN))]
        qual = rng.integers(35, 75, (n_pairs, READ_LEN), dtype=np.uint8)
        if at_quals:
            qual[::3, 0] = ord("@")
        bc = "ATCACGTT" if mate == 1 else "ATCACGTA"
        ids = [f"@A00123:8:HV2JKDSXX:{lane[i]}:{tile[i]}:{x[i]}:{y[i]} {mate}:N:0:{bc}".encode()
               for i in range(n_pairs)]
        rows = [b"".join((ids[i], eol, seq[i].tobytes(), eol, b"+", eol, qual[i].tobytes(), eol))
                for i in range(n_pairs)]
        texts.append(b"".join(rows))
    return texts[0], texts[1]


def scan_chunks_of(run: bytes):
    """The ingest's chunking of one aligned run: ``(starts, lens,
    chunk_lens, aligned, final)`` columns."""
    offs = np.arange(0, len(run), SCAN_CHUNK, dtype=np.int64)
    lens = np.minimum(SCAN_CHUNK + SCAN_OVERLAP, len(run) - offs)
    return (offs, lens, np.minimum(SCAN_CHUNK, len(run) - offs), offs == 0,
            offs + lens >= len(run))


def _fq_lines(rng, n_seq: int, eol: bytes = b"\n", q0: bytes = b"", name: int = 10) -> list:
    """The four lines of one FASTQ record, each with its end of line: an id
    of ``name`` bytes after '@', ``n_seq`` bases, '+', and ``n_seq``
    qualities starting with ``q0``."""
    ident = b"@" + rng.integers(0x30, 0x5B, name, dtype=np.uint8).tobytes()
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_seq)].tobytes()
    qual = (q0 + rng.integers(0x21, 0x4B, n_seq, dtype=np.uint8).tobytes())[:n_seq]
    return [ident + eol, seq + eol, b"+" + eol, qual + eol]


def _fq(rng, count: int, eol: bytes = b"\n", q0: bytes = b"", lo: int = 1,
        hi: int = 40) -> bytes:
    """``count`` FASTQ records of ``lo`` to ``hi`` - 1 bases."""
    return b"".join(b"".join(_fq_lines(rng, int(rng.integers(lo, hi)), eol, q0))
                    for _ in range(count))


def _record_starts(text: bytes) -> list:
    """The record starts of clean FASTQ text (every fourth line)."""
    nl = np.flatnonzero(np.frombuffer(text, np.uint8) == 0x0A).tolist()
    return [0] + [nl[k] + 1 for k in range(3, len(nl) - 1, 4)]


def _placed(rng, targets, eol: bytes, which=None) -> bytes:
    """Records each with one line whose newline lies at a target window
    offset (line ``which`` of the record, else one at random; the id grows
    to put it there; a target too close to the previous one is skipped),
    then three more records."""
    out = bytearray()
    for x in targets:
        parts = _fq_lines(rng, int(rng.integers(0, 24)), eol, name=0)
        j = int(rng.integers(0, 4)) if which is None else which
        grow = x - len(out) - sum(len(p) for p in parts[: j + 1]) + 1
        if grow < 0:
            continue
        parts[0] = b"@" + b"N" * grow + parts[0][1:]
        out += b"".join(parts)
    return bytes(out) + _fq(rng, 3, eol)


def record_scan_trouble_cases(seed: int, tile: int) -> dict:
    """``{what: [(window, chunk_len, aligned, final, cap), ...]}``: the
    record scan's trouble cases for a kernel that reads a window in tiles of
    ``tile`` bytes from a 16-byte boundary.  Tile seams: a newline in a
    tile's first byte, a CR in a tile's last byte with its LF in the next, a
    line from one tile to two tiles later, a record whose four lines span
    three tiles.  The line count's extremes: 59,136 newlines, and no newline
    at all, final and not.  Claims at the edge: records starting at
    chunk_len - 1, at chunk_len and past it, a sync line at chunk_len - 1
    and at chunk_len.  The cap: n == cap, the cap hit mid-tile, an unaligned
    cap of 1 whose sync claims two records, cap 0.  False frames: qualities
    starting with '@' or '+', CRLF text, a lone frame before the records.
    Windows of 0-15 bytes, unterminated final text, a torn frame, a partial
    claimed frame, dangling claimed text, empty lines and lone-CR lines."""
    from hadoop_bam_tpu_torch.ops.kernels import record_scan as krs

    rng = np.random.default_rng(seed)
    cases: dict = {}

    def add(what, win, chunk_len=None, aligned=True, final=True, cap=None):
        chunk_len = len(win) if chunk_len is None else chunk_len
        cap = krs.default_rec_cap(len(win)) if cap is None else cap
        cases.setdefault(what, []).append((bytes(win), int(chunk_len), bool(aligned),
                                           bool(final), int(cap)))

    def four(what, win, chunk_len=None):
        for aligned in (True, False):
            for final in (True, False):
                add(what, win, chunk_len, aligned, final)

    seams = [k * tile for k in range(1, 7)]
    four("LF in a tile's first byte", _placed(rng, seams, b"\n"), 4 * tile)
    four("CR in a tile's last byte, its LF in the next", _placed(rng, seams, b"\r\n"), 4 * tile)
    for eol in (b"\n", b"\r\n"):
        head = _placed(rng, [tile - 8], eol, which=0)[: tile - 7]  # an id line ending at tile - 8
        long = b"".join(_fq_lines(rng, 2 * tile + 5, eol)[1:])  # its seq and qual: 3 tiles each
        four(f"a line over three tiles ({eol!r})", head + long + _fq(rng, 4, eol))
        head = _placed(rng, [tile - 4], eol, which=0)[: tile - 3]
        mid = b"".join(_fq_lines(rng, int(0.6 * tile) + 1, eol)[1:])
        four(f"a record over three tiles ({eol!r})", head + mid + _fq(rng, 4, eol))
    big = SCAN_CHUNK + SCAN_OVERLAP
    four("every byte a newline", b"\n" * big, SCAN_CHUNK)
    four("no newline", b"A" * big, SCAN_CHUNK)
    four("no newline, 40 bytes", b"ACGT" * 10, 20)
    clean = _fq(rng, 24, lo=20, hi=3 * tile // 8 + 21)
    st = _record_starts(clean)
    for what, cl in (("a record starting at chunk_len - 1", st[9] + 1),
                     ("a record starting at chunk_len", st[9]),
                     ("a record starting past chunk_len", st[9] - 1)):
        add(what, clean, cl, final=False)
    torn = clean[st[3] - 7:]  # the tail of record 2's qualities, then record 3 on
    s0, s1 = 7, st[4] - st[3] + 7
    for what, cl in (("a sync line at chunk_len - 1", s0 + 1), ("a sync line at chunk_len", s0),
                     ("the second sync record at chunk_len", s1),
                     ("the second sync record at chunk_len - 1", s1 + 1)):
        add(what, torn, cl, aligned=False, final=False)
    add("n == cap", clean, st[9], final=False, cap=9)
    add("the cap one short", clean, st[9], final=False, cap=8)
    add("the cap hit mid-tile", clean, cap=13)
    add("cap 0", clean, cap=0)
    add("cap 0, unaligned", torn, aligned=False, cap=0)
    add("cap 1, unaligned, the sync claims two", torn, aligned=False, cap=1)
    add("cap 1, unaligned, the sync claims one", torn, s1, aligned=False, final=False, cap=1)
    add("cap 2, unaligned", torn, aligned=False, cap=2)
    for q0, what in ((b"@", "qualities starting with '@'"), (b"+", "qualities starting with '+'")):
        for eol in (b"\n", b"\r\n"):
            text = _fq(rng, 30, eol, q0, lo=2, hi=tile // 4 + 3)
            four(f"{what} ({eol!r})", text, len(text) // 2)
            for cut in (1, 3, 7, 12, 25, 40):  # windows starting inside the first records
                add(f"{what} ({eol!r}), unaligned cuts", text[cut:], len(text) // 2 - cut,
                    aligned=False, final=bool(cut & 1))
    lone = b"xx\n" * 5 + b"@a\nAC\n+\nII\n" + b"zz\n" * 4 + _fq(rng, 6)
    for final in (True, False):
        for cut in (0, 3):
            add("a lone frame before the records", lone[cut:], aligned=False, final=final)
    for k in range(16):
        for aligned in (True, False):
            for final in (True, False):
                add("windows of 0-15 bytes", clean[:k], k, aligned, final)
    for eol in (b"\n", b"\r\n"):
        text = _fq(rng, 7, eol)
        for cut in sorted({1, 2, len(eol) + 1}):  # no end of line; a last byte that is the CR
            four(f"unterminated text ({eol!r}, {cut} bytes cut)", text[:-cut])
    bad = bytearray(clean)
    del bad[st[7] - 2]  # record 6's qualities one byte short
    add("a torn frame", bytes(bad), final=False)
    partial = clean[: clean.index(b"\n", st[12]) + 1]  # record 12's id line alone
    add("a partial claimed frame", partial, final=False)
    add("a partial frame, not claimed", partial, st[12], final=False)
    add("dangling claimed text", clean[: st[12] + 9], final=False)
    lines = b"\n\r\n\n" + b"@e\r\n\r\n+\r\n\r\n" * 3 + b"\r\n" * 2 + _fq(rng, 5, b"\r\n")
    four("empty lines and lone-CR lines", lines)
    four("empty lines and lone-CR lines", b"@e\n\r\n+\n\r\n" * 9)
    return cases


def scan_blob(chunks, shift: int = 0):
    """Chunks packed into one byte string for one launch, each window from a
    16-byte boundary (then ``shift`` bytes past it): ``(blob, starts, lens,
    chunk_lens, aligned, final, caps)``."""
    parts, starts, pos = [], [], 0
    for win, *_ in chunks:
        pad = (-pos) % 16 + shift
        parts.append(b"\x00" * pad + win)
        starts.append(pos + pad)
        pos += pad + len(win)
    cols = [np.array([c[i] for c in chunks], dt) for i, dt in
            ((1, np.int64), (2, bool), (3, bool), (4, np.int64))]
    return (b"".join(parts), np.array(starts, np.int64),
            np.array([len(c[0]) for c in chunks], np.int64), *cols)


def _scan_both(blob: bytes, cols, caps):
    """The record-scan kernel and its plain version on the same windows:
    ``(meta, rows)`` per side, rows cut to each chunk's ``n``."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import record_scan as krs

    out = []
    for dev in ("cuda", "cpu"):
        data = torch.from_numpy(np.frombuffer(blob, np.uint8).copy()).to(dev)
        rows, meta, base = krs.scan_windows(data, *cols, caps)
        meta = meta.cpu().numpy()
        rows = rows.cpu().numpy()
        base = base.cpu().numpy()
        out.append((meta, [rows[b : b + n] for b, n in zip(base.tolist(), meta[:, 0].tolist())]))
    return out


def check_record_scan(seed: int) -> dict:
    """The record-scan kernel against its plain version (meta and rows,
    exactly) at the ingest's full geometry (57,088-byte claims + 2,048
    bytes of overlap): >= 256 chunks of the smoke corpus; a CRLF corpus
    whose qualities begin with '@'; a garbage and a clean chunk in one
    launch; a chunk past its record cap; an unaligned head; every accepted
    chunk also against the NumPy host scan."""
    from hadoop_bam_tpu_torch.ops.kernels import record_scan as krs

    r1, _ = fastq_pairs(42_000, seed)
    crlf, _ = fastq_pairs(2_000, seed + 1, crlf=True, at_quals=True)
    cases = []
    cols = scan_chunks_of(r1)
    n_main = len(cols[0])
    if n_main < 256:
        raise AssertionError(f"record-scan corpus has {n_main} chunks, want >= 256")
    cases.append(("smoke corpus", r1, cols, [krs.default_rec_cap(SCAN_CHUNK + SCAN_OVERLAP)]
                  * n_main))
    cc = scan_chunks_of(crlf)
    cases.append(("crlf, @-qualities", crlf, cc, [krs.default_rec_cap(SCAN_CHUNK + SCAN_OVERLAP)]
                  * len(cc[0])))
    garbage = bytes(np.random.default_rng(seed).integers(1, 128, SCAN_CHUNK + SCAN_OVERLAP,
                                                         dtype=np.uint8))
    clean = r1[: SCAN_CHUNK + SCAN_OVERLAP]
    blob = garbage + clean + r1[17 : 17 + SCAN_CHUNK + SCAN_OVERLAP]
    w = SCAN_CHUNK + SCAN_OVERLAP
    mixed = (np.array([0, w, 2 * w]), np.array([w, w, w]), np.array([SCAN_CHUNK] * 3),
             np.array([True, True, False]), np.array([False, False, False]))
    cases.append(("garbage + clean + unaligned", blob, mixed, [1664] * 3))
    cases.append(("record cap overflow", clean, (np.array([0]), np.array([w]),
                  np.array([SCAN_CHUNK]), np.array([True]), np.array([False])), [64]))
    bad = 0
    verdicts = {}
    for what, data, cols, caps in cases:
        (mk, rk), (mp, rp) = _scan_both(data, cols, caps)
        if not np.array_equal(mk, mp):
            raise AssertionError(f"record_scan meta differs from plain ({what}): "
                                 f"{mk[(mk != mp).any(1)][:4]} vs {mp[(mk != mp).any(1)][:4]}")
        for k, (a, b) in enumerate(zip(rk, rp)):
            if not np.array_equal(a, b):
                raise AssertionError(f"record_scan rows differ from plain ({what}, chunk {k})")
            bad += int(np.count_nonzero(a != b))
        starts, lens, cl, al, fi = cols
        for k in np.flatnonzero(mk[:, 1]).tolist():
            s = int(starts[k])
            host = krs.scan_window_host(data[s : s + int(lens[k])], int(cl[k]), bool(al[k]),
                                        bool(fi[k]))
            if not np.array_equal(rk[k], host):
                raise AssertionError(f"record_scan differs from the host scan ({what}, chunk {k})")
        verdicts[what] = [int(mk[:, 1].sum()), len(mk)]
    if verdicts["garbage + clean + unaligned"] != [2, 3] or verdicts["record cap overflow"] != [0, 1]:
        raise AssertionError(f"record_scan verdicts {verdicts}")
    if verdicts["smoke corpus"] != [n_main, n_main]:
        raise AssertionError(f"record_scan declined smoke chunks: {verdicts}")
    log(f"record_scan kernel == plain: {sum(v[1] for v in verdicts.values())} chunks "
        f"({n_main} at full geometry), ok/total {json.dumps(verdicts)}, every ok chunk == "
        "host scan, max_abs_err 0")
    check_scan_trouble(seed, krs.TILE, krs.THREADS)
    check_scan_trouble(seed + 1, 64, 128)
    return {"max_abs_err": float(bad), "corpus": r1}


def check_scan_trouble(seed: int, tile: int, threads: int) -> None:
    """The record scan at tiles of ``tile`` bytes and ``threads`` a block
    against its plain version (meta of every chunk, rows ``[:n]``, exactly)
    on ``record_scan_trouble_cases(seed, tile)``, from an aligned tensor and
    from a view 1-15 bytes past one."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import record_scan as krs

    cases = record_scan_trouble_cases(seed, tile)
    verdicts = {}
    for j, (what, chunks) in enumerate(cases.items()):
        blob, *cols = scan_blob(chunks)
        t = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
        rows_p, meta_p, base = krs.scan_windows(t, *cols)
        meta_p, rows_p = meta_p.numpy(), rows_p.numpy()
        shift = 1 + j % 15
        g = torch.zeros(len(blob) + shift, dtype=torch.uint8, device="cuda")
        g[shift:] = t.cuda()
        for view in (g[shift:].clone(), g[shift:]):
            kcols, rows_k, meta_k = krs._columns(view, *cols)
            krs._launch(view, kcols, rows_k, meta_k, tile, threads)
            meta_k, rows_k = meta_k.cpu().numpy(), rows_k.cpu().numpy()
            if not np.array_equal(meta_k, meta_p):
                k = int(np.flatnonzero((meta_k != meta_p).any(1))[0])
                raise AssertionError(f"record_scan [n, ok] differs from plain ({what}, chunk {k}, "
                                     f"tile {tile}): {meta_k[k].tolist()} vs {meta_p[k].tolist()}")
            for k, (b, n) in enumerate(zip(base.tolist(), meta_p[:, 0].tolist())):
                if not np.array_equal(rows_k[b : b + n], rows_p[b : b + n]):
                    raise AssertionError(f"record_scan rows differ from plain ({what}, chunk {k}, "
                                         f"tile {tile})")
        verdicts[what] = [int(meta_p[:, 1].sum()), len(chunks)]
    log(f"record_scan == plain at tile {tile}, {threads} threads: {len(cases)} trouble cases, "
        f"{sum(v[1] for v in verdicts.values())} chunks, aligned and 1-15 bytes off; ok/total "
        f"{json.dumps(verdicts)}")


def time_record_scan(run: bytes, checks: dict, launches: int, launches_from: str) -> dict:
    """The record-scan kernel over one ingest input's chunks, beside its
    plain version and its bound."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import record_scan as krs

    cols = scan_chunks_of(run)
    cap = krs.default_rec_cap(SCAN_CHUNK + SCAN_OVERLAP)
    caps = [cap] * len(cols[0])
    g = torch.from_numpy(np.frombuffer(run, np.uint8).copy()).cuda()
    c = torch.from_numpy(np.frombuffer(run, np.uint8).copy())
    k_ms = cuda_ms(lambda: krs.scan_windows(g, *cols, caps), iters=10)
    p_ms = host_ms(lambda: krs.scan_windows(c, *cols, caps), iters=1)
    _, meta, _ = krs.scan_windows(g, *cols, caps)
    n_rec = int(meta[:, 0].sum())
    # The bare launch on columns already on the card, and its phases' shares
    # of the blocks' clock cycles (one timed launch).
    kcols, rows_k, meta_k = krs._columns(g, *cols, caps)
    bare_ms = cuda_ms(lambda: krs._launch(g, kcols, rows_k, meta_k), iters=10)
    cyc = torch.zeros(len(krs.PHASES), dtype=torch.int64, device="cuda")
    krs._launch(g, kcols, rows_k, meta_k, cycles=cyc)
    cyc = cyc.cpu().numpy().astype(np.float64)
    shares = {k: round(float(v / cyc.sum()), 4) for k, v in zip(krs.PHASES, cyc)}
    if not torch.equal(meta_k, meta):
        raise AssertionError("record_scan: the bare launch's meta differs from scan_windows'")
    # The windows cover the run; each byte is read once, whatever the overlap.
    # Per chunk: six columns in (32 bytes) and [n, ok] out (8); 32 bytes a row.
    moved = len(run) + (32 + 8) * len(caps) + 32 * n_rec
    row = {
        "name": "record_scan", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/record_scan.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/record_scan.py:305",
        "launches": launches, "launches_from": launches_from,
        "max_abs_err": checks["record_scan"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "shape": f"{len(caps)} chunks, {len(run)} bytes, {n_rec} records",
        "kernel_ms": bare_ms, "phase_shares": shares,
    }
    log(f"  record_scan: {k_ms:.4f} ms (plain {p_ms:.3f} ms, bound {row['bound_ms']:.4f} ms) "
        f"at {row['shape']}; kernel_ms {bare_ms:.4f} (the bare launch); phase shares of the "
        f"blocks' cycles {json.dumps(shares)}")
    return row


# ---------------------------------------------------------------------------
# BCF: the call-set generator and the record-chain kernel
# ---------------------------------------------------------------------------

SAMPLES = ("NA12878", "NA12891", "NA12892")  # a trio
BCF_RECORD = 109  # bytes of every generated record (see synth_bcf_rows)
#: A window on chr1 where the generator places no site.
EMPTY_WINDOW = ("chr1", 125_000_001, 126_000_000)
VARIANT_REGIONS = ("chr20:10,000,001-11,000,000", "chr21",
                   f"{EMPTY_WINDOW[0]}:{EMPTY_WINDOW[1]}-{EMPTY_WINDOW[2]}")


def bcf_header_lines() -> list:
    """The call set's VCF header: GATK-style INFO AC/AF/AN/DP and FORMAT
    GT:AD:DP:GQ:PL over the 25 GRCh38 contigs, three samples."""
    return (["##fileformat=VCFv4.2", '##FILTER=<ID=PASS,Description="All filters passed">']
            + [f"##contig=<ID={c},length={n}>" for c, n in GRCH38]
            + ['##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count">',
               '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency">',
               '##INFO=<ID=AN,Number=1,Type=Integer,Description="Total number of alleles">',
               '##INFO=<ID=DP,Number=1,Type=Integer,Description="Approximate read depth">',
               '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
               '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">',
               '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
               '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
               '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Genotype likelihoods">',
               "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(SAMPLES)])


def synth_sites(n: int, seed: int):
    """``(contig, pos)`` of about ``n`` sites placed in proportion to contig
    length, sorted by (contig, pos), none in :data:`EMPTY_WINDOW`."""
    rng = np.random.default_rng(seed)
    lens = np.asarray([c[1] for c in GRCH38], dtype=np.int64)
    want = np.round(n * lens / lens.sum()).astype(np.int64)
    contig, pos = [], []
    for ci, (name, ln) in enumerate(GRCH38):
        p = np.unique(rng.integers(1, ln + 1, int(want[ci])))
        if name == EMPTY_WINDOW[0]:
            p = p[(p < EMPTY_WINDOW[1]) | (p > EMPTY_WINDOW[2])]
        contig.append(np.full(len(p), ci, dtype=np.int64))
        pos.append(p)
    return np.concatenate(contig), np.concatenate(pos)


def synth_bcf_rows(contig: np.ndarray, pos: np.ndarray, seed: int) -> np.ndarray:
    """The BCF records of biallelic SNVs at ``(contig, pos)``: uint8 rows of
    :data:`BCF_RECORD` bytes, each exactly what ``spec/bcf.encode_record``
    writes for it.  INFO AC (1..6), AF (AC/6 as its %g text in float32),
    AN=6, DP (<= 126); FORMAT GT, AD and DP (int8), GQ (int8) and PL
    (int16: every sample has a likelihood above 127)."""
    rng = np.random.default_rng(seed)
    n = len(pos)
    alt = rng.choice(3, (n, 3), p=[0.45, 0.35, 0.20])  # alt alleles per sample
    none = alt.sum(1) == 0
    alt[none, 0] = 1  # a site carries at least one alt allele
    ac = alt.sum(1)
    # AF as the float32 of its %g text, so decode and re-encode keep its bits
    af = np.asarray([float(f"{k / 6:g}") for k in range(7)], dtype=np.float32)[ac]
    dp_s = rng.integers(15, 43, (n, 3))
    ref_ad = np.where(alt == 0, dp_s, np.where(alt == 1, dp_s // 2, rng.integers(0, 3, (n, 3))))
    alt_ad = dp_s - ref_ad
    gq = rng.integers(20, 100, (n, 3))
    pl = rng.integers(128, 2000, (n, 3, 3))
    pl[np.arange(n)[:, None], np.arange(3)[None, :], alt] = 0
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.integers(0, 4, n)
    alt_b = (ref + rng.integers(1, 4, n)) % 4
    qual = np.round(rng.uniform(30, 3000, n), 2).astype(np.float32)
    rows = np.zeros((n, BCF_RECORD), dtype=np.uint8)

    def put(col: int, vals, nbytes: int) -> None:
        v = np.asarray(vals).astype(np.int64) & ((1 << (8 * nbytes)) - 1)
        for k in range(nbytes):
            rows[:, col + k] = (v >> (8 * k)) & 0xFF

    def const(col: int, data: bytes) -> None:
        rows[:, col : col + len(data)] = np.frombuffer(data, np.uint8)

    put(0, np.full(n, 50), 4)  # l_shared
    put(4, np.full(n, BCF_RECORD - 58), 4)  # l_indiv
    put(8, contig, 4)
    put(12, pos - 1, 4)
    put(16, np.ones(n), 4)  # rlen
    put(20, qual.view(np.uint32), 4)
    put(24, np.full(n, (2 << 16) | 4), 4)
    put(28, np.full(n, (5 << 24) | 3), 4)
    const(32, b"\x07\x17")  # ID: an empty string; REF: one char
    rows[:, 34] = bases[ref]
    rows[:, 35] = 0x17
    rows[:, 36] = bases[alt_b]
    const(37, b"\x11\x00\x11\x01\x11")  # FILTER PASS; AC key; AC value type
    put(42, ac, 1)
    const(43, b"\x11\x02\x15")  # AF key, value type
    put(46, af.view(np.uint32), 4)
    const(50, b"\x11\x03\x11\x06\x11\x04\x11")  # AN key, AN=6, DP key, value type
    put(57, dp_s.sum(1), 1)
    const(58, b"\x11\x05\x21")  # GT: two int8 per sample
    gt = np.stack([np.where(alt >= 2, 4, 2), np.where(alt >= 1, 4, 2)], axis=2)
    rows[:, 61:67] = gt.reshape(n, 6)
    const(67, b"\x11\x06\x21")  # AD: two int8 per sample
    rows[:, 70:76] = np.stack([ref_ad, alt_ad], axis=2).reshape(n, 6)
    const(76, b"\x11\x04\x11")  # DP
    rows[:, 79:82] = dp_s
    const(82, b"\x11\x07\x11")  # GQ
    rows[:, 85:88] = gq
    const(88, b"\x11\x08\x32")  # PL: three int16 per sample
    pl16 = pl.reshape(n, 9).astype("<i2").view(np.uint8).reshape(n, 18)
    rows[:, 91:109] = pl16
    return rows


def synth_bcf(path: str, n: int, seed: int, level: int = 6):
    """Write a BGZF-BCF call set of about ``n`` sites; returns ``(contig,
    pos, rows, header bytes)``."""
    from hadoop_bam_tpu_torch.spec import bcf, bgzf
    from hadoop_bam_tpu_torch.spec.vcf import VcfHeader

    contig, pos = synth_sites(n, seed)
    rows = synth_bcf_rows(contig, pos, seed + 1)
    head = bcf.encode_header(VcfHeader(bcf_header_lines()))
    blob, _ = bgzf.deflate_blocks(np.concatenate([np.frombuffer(head, np.uint8),
                                                  rows.reshape(-1)]), level=level)
    with open(path, "wb") as f:
        f.write(blob)
        f.write(bgzf.TERMINATOR)
    return contig, pos, rows, head


def check_bcf_rows(rows: np.ndarray, contig: np.ndarray, pos: np.ndarray, k: int, seed: int):
    """A sample of generated records decodes with ``spec/bcf.decode_record``
    to its site and re-encodes to the same bytes."""
    from hadoop_bam_tpu_torch.spec import bcf
    from hadoop_bam_tpu_torch.spec.vcf import VcfHeader

    hdr = bcf.BcfHeader(VcfHeader(bcf_header_lines()))
    for i in np.random.default_rng(seed).choice(len(rows), min(k, len(rows)), replace=False):
        raw = rows[i].tobytes()
        v, end = bcf.decode_record(raw, 0, hdr)
        if (end, v.chrom, v.pos) != (len(raw), GRCH38[contig[i]][0], int(pos[i])) or \
                bcf.encode_record(hdr, v) != raw:
            raise AssertionError(f"generated record {i} is not canonical: {v.format_line()}")


def varied_bcf_payload(seed: int, n: int = 3000) -> bytes:
    """Records the generator does not make, encoded by the port's spec: SNVs
    and indels, POS=0, symbolic deletions with INFO END, sites-only records,
    missing QUAL/FILTER/values, IDs, flags and strings."""
    from hadoop_bam_tpu_torch.spec import bcf
    from hadoop_bam_tpu_torch.spec.vcf import VcfHeader, parse_variant_line

    rng = np.random.default_rng(seed)
    lines = bcf_header_lines()
    lines[-1:-1] = ['##INFO=<ID=END,Number=1,Type=Integer,Description="End">',
                    '##INFO=<ID=DB,Number=0,Type=Flag,Description="dbSNP">',
                    '##INFO=<ID=NOTE,Number=1,Type=String,Description="Note">']
    hdr = bcf.BcfHeader(VcfHeader(lines))
    out = []
    for i, p in enumerate(np.sort(rng.integers(1, 10**6, n)).tolist()):
        kind = i % 9
        p = 0 if i == 0 else p
        ref, alt = ("ACGT"[i % 4], "GT"[i % 2]) if kind else ("ACG", "A")
        info = f"AC={1 + i % 6};AF=0.5;AN=6;DP={i % 500}"
        if kind == 1:
            ref, alt, info = "A", "<DEL>", f"END={p + 500};DP=3"
        elif kind == 2:
            info += ";DB;NOTE=x" + str(i)
        qual = "." if kind == 3 else f"{i % 997 / 7:.2f}"
        vid = f"rs{i}" if kind == 4 else "."
        filt = "." if kind == 5 else "PASS"
        fields = ["chr7", str(p), vid, ref, alt, qual, filt, info]
        if kind != 6:
            gts = ["0/1:3,4:7:50:20,0,300", "./.:.:.:.:.", f"1|1:0,{i % 300}:9:99:900,600,0"]
            fields += ["GT:AD:DP:GQ:PL"] + gts
        out.append(bcf.encode_record(hdr, parse_variant_line("\t".join(fields))))
    return b"".join(out)


def bcf_records(rng, lengths) -> bytes:
    """Records of the given lengths (8 + l_shared + l_indiv each, at least
    32): l_shared drawn from 24 .. min(length - 8, 4096), random fixed
    fields and blocks (so some positions inside a record frame plausibly)."""
    out = []
    for ln in lengths:
        ls = int(rng.integers(24, min(ln - 8, 4096) + 1))
        out.append(struct.pack("<II", ls, ln - 8 - ls)
                   + rng.integers(0, 256, ln - 8, dtype=np.uint8).tobytes())
    return b"".join(out)


def bcf_record_starts(payload: bytes, start: int = 0) -> list:
    """The chain positions of a clean payload from ``start``, its end included."""
    offs = [start]
    while offs[-1] + 8 <= len(payload):
        ls, li = struct.unpack_from("<II", payload, offs[-1])
        offs.append(offs[-1] + 8 + ls + li)
    return offs


def bcf_trouble_cases(seed: int, seg: int, slab: int, big: bool = False) -> dict:
    """``(payload, start, limit, ok)`` of the chain walk's trouble cases for
    the card's walk in segments of ``seg`` bytes anchored at ``start`` and
    slabs of ``slab``: records longer than a segment and than a slab,
    records on segment boundaries and in a segment's last 1-31 bytes, a
    plausible false chain inside a long record, framing errors in the
    first, a middle and the last segment, the length words' edges, a
    truncated record, limits at p + 7, p + 8 and past the payload, empty
    windows, unaligned starts, minimal records, starts past the payload and
    an empty payload.  ``ok`` is the walk's verdict.  ``big`` adds a valid
    record with l_indiv = 2^28 - 1 (a 268 MB payload)."""
    rng = np.random.default_rng(seed)
    S = seg

    def fill(nbytes: int) -> list:
        out = []
        while sum(out) < nbytes:
            out.append(int(rng.integers(32, 400)))
        return out

    def rec(ls: int, li: int, body: int = -1) -> bytes:
        body = ls + li if body < 0 else body
        return struct.pack("<II", ls, li) + rng.integers(0, 256, body, dtype=np.uint8).tobytes()

    def around(middle: bytes) -> bytes:
        return bcf_records(rng, fill(2 * S)) + middle + bcf_records(rng, fill(S))

    cases = {}
    varied = bcf_records(rng, fill(S) + [S + 1] + fill(S) + [5 * S // 2] + fill(S)
                         + [3 * S + 17] + fill(S))
    cases["varied lengths, records past a segment"] = (varied, 0, len(varied), 1)
    over = bcf_records(rng, fill(S) + [slab + S + 123] + fill(S))
    cases["a record past a slab"] = (over, 0, len(over), 1)
    edge = bcf_records(rng, [max(32, S // 4)] * 24)
    cases["records on segment boundaries"] = (edge, 0, len(edge), 1)
    tail = bcf_records(rng, [S - 1] * 33)
    cases["records in a segment's last 1-31 bytes"] = (tail, 0, len(tail), 1)
    # A long record whose genotype block holds a chain of plausible 40-byte
    # records, 4 bytes off, across three segments and past the record's end.
    fakes = b"".join(struct.pack("<II", 24, 8) + rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
                     for _ in range(3 * S // 40 + 4))
    li = 3 * S + 11
    host = struct.pack("<II", 24, li) + rng.integers(0, 256, 24, dtype=np.uint8).tobytes()
    false = around(host + (bytes(4) + fakes)[:li])
    cases["a false chain inside a genotype block"] = (false, 0, len(false), 1)
    errs = bcf_records(rng, fill(4 * S + 100))
    offs = bcf_record_starts(errs)[:-1]
    mid = min(o for o in offs if o >= 2 * S)
    for where, at in (("the first segment", [o for o in offs if o < S][-1]),
                      ("a middle segment", mid), ("the last record", offs[-1])):
        bad = bytearray(errs)
        struct.pack_into("<I", bad, at, 7)
        cases[f"l_shared 7 in {where}"] = (bytes(bad), 0, len(bad), 0)
    for ls, ok in ((23, 0), (24, 1), ((1 << 24) - 1, 1), (1 << 24, 0)):
        p = around(rec(ls, 5, ls + 5 if ok else 60))
        cases[f"l_shared {ls}"] = (p, 0, len(p), ok)
    for li in ((1 << 28) - 1, 1 << 28, 0x90000000):
        p = around(rec(30, li, 60))
        cases[f"l_indiv {li:#x} in a short payload"] = (p, 0, len(p), 0)
    cut = bcf_records(rng, fill(3 * S))
    cut = cut[: bcf_record_starts(cut)[-2] + 20]
    cases["a truncated last record"] = (cut, 0, len(cut), 0)
    p = bcf_record_starts(varied)[len(bcf_record_starts(varied)) // 2]
    cases["limit at p + 7"] = (varied, 0, p + 7, 1)
    cases["limit at p + 8"] = (varied, 0, p + 8, 1)
    cases["limit past the payload"] = (varied, 0, len(varied) + 100, 0)
    cases["start == limit"] = (varied, p, p, 1)
    odd = bytes(5) + varied
    cases["start 5, not on 16 bytes"] = (odd, 5, len(odd), 1)
    cases["start and limit mid-payload, unaligned"] = (odd, p + 5, len(odd) - 1001, 1)
    tiny = bcf_records(rng, [32] * (4 * S // 32 + 7))
    cases["minimal 32-byte records"] = (tiny, 0, len(tiny), 1)
    cases["start past the payload"] = (edge, len(edge) + 3, len(edge) + 20, 0)
    cases["start past the payload, window ends"] = (edge, len(edge) + 3, len(edge) + 10, 1)
    cases["empty payload, empty window"] = (b"", 0, 0, 1)
    cases["empty payload"] = (b"", 0, 8, 0)
    if big:
        p = bcf_records(rng, fill(S)) + rec(24, (1 << 28) - 1, 60)
        p += bytes((1 << 28) - 1 + 24 - 60) + bcf_records(rng, fill(S))
        cases["l_indiv 0xfffffff, valid"] = (p, 0, len(p), 1)
    return cases


def bcf_walk_cases(seed: int, big: bytes, trouble: dict) -> dict:
    """``(payload, start, limit)`` of the chain-walk check: the generated
    call set at a split's size and the varied records, each clean, as a
    window with a straddling tail, with a corrupt l_shared, with a corrupt
    l_indiv, truncated, and an empty window; then the ``trouble`` cases
    (:func:`bcf_trouble_cases`)."""
    cases = {}
    for tag, payload in (("call set", big), ("varied", varied_bcf_payload(seed))):
        offs = bcf_record_starts(payload)
        k = len(offs) // 2
        bad_s = bytearray(payload)
        struct.pack_into("<I", bad_s, offs[k], 7)
        bad_i = bytearray(payload)
        struct.pack_into("<I", bad_i, offs[k + 1] + 4, 0x90000000)
        cut = payload[: offs[k + 2] + 20]
        cases.update({
            f"{tag}: clean": (payload, 0, len(payload)),
            f"{tag}: window, straddling tail": (payload, offs[3], offs[k + 5] - 5),
            f"{tag}: corrupt l_shared": (bytes(bad_s), 0, len(payload)),
            f"{tag}: corrupt l_indiv": (bytes(bad_i), 0, len(payload)),
            f"{tag}: truncated": (cut, 0, len(cut)),
            f"{tag}: empty window": (payload, offs[k], offs[k]),
        })
    for what, c in trouble.items():
        cases[f"trouble: {what}"] = c[:3]
    return cases


def check_bcf_walk(cases: dict, seg: int, slab: int) -> dict:
    """The chain kernel at segments of ``seg`` bytes and slabs of ``slab``
    against its plain version (columns, count and ok, exactly) on each case,
    from an aligned tensor and from a view 1-15 bytes past one; the tiered
    walk answers ok windows on the card and re-walks the others on the
    host.  Returns ``{what: [count, ok, tier]}``."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import bcf_chain as kb

    verdicts = {}
    for j, (what, (buf, start, limit)) in enumerate(cases.items()):
        t = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
        cols_p, meta_p = kb.walk_chain_device(t, start, limit)
        count = int(meta_p[0])
        shift = 1 + j % 15
        g = torch.zeros(len(buf) + shift, dtype=torch.uint8, device="cuda")
        g[shift:] = t.cuda()
        for view in (t.cuda(), g[shift:]):
            cols_k, meta_k = kb._launch(view, start, limit, seg, slab)[:2]
            if meta_k.cpu().tolist() != meta_p.tolist():
                raise AssertionError(f"bcf_chain [count, ok] differs from plain ({what}, seg {seg}"
                                     f"): {meta_k.cpu().tolist()} vs {meta_p.tolist()}")
            diff = int((cols_k[:, :count].cpu() != cols_p[:, :count]).sum())
            if diff:
                raise AssertionError(f"bcf_chain columns differ from plain ({what}, seg {seg}): "
                                     f"{diff} values")
        _, _, ok, tier = kb.walk_chain(t.cuda(), start, limit, host=buf)
        verdicts[what] = [count, int(meta_p[1]), tier]
        if tier != ("device" if meta_p[1] else "host") or ok != bool(meta_p[1]):
            raise AssertionError(f"walk_chain tier {tier} for {what}")
        del t, g
    return verdicts


def check_bcf_chain(seed: int, big: bytes) -> dict:
    """The BCF chain kernel against its plain version on every case of
    :func:`bcf_walk_cases` at the wrapper's geometry, and on the trouble
    cases built for segments of 512 bytes and slabs of 2,048 at that
    geometry (many boundaries, slab carries); each verdict is the one
    expected."""
    from hadoop_bam_tpu_torch.ops.kernels import bcf_chain as kb

    trouble = bcf_trouble_cases(seed, kb.SEG, kb.SLAB, big=True)
    verdicts = check_bcf_walk(bcf_walk_cases(seed, big, trouble), kb.SEG, kb.SLAB)
    oks = [v[1] for v in verdicts.values()]
    if oks != [1, 1, 0, 0, 0, 1] * 2 + [c[3] for c in trouble.values()]:
        raise AssertionError(f"bcf_chain verdicts {verdicts}")
    small = bcf_trouble_cases(seed + 1, 512, 2048)
    tiny = check_bcf_walk({k: c[:3] for k, c in small.items()}, 512, 2048)
    if [v[1] for v in tiny.values()] != [c[3] for c in small.values()]:
        raise AssertionError(f"bcf_chain verdicts at seg 512 {tiny}")
    log(f"bcf_chain kernel == plain: {len(verdicts)} windows [count, ok, tier] "
        f"{json.dumps(verdicts)}, max_abs_err 0")
    log(f"bcf_chain kernel == plain at seg 512, slab 2048: {len(tiny)} windows "
        f"{json.dumps(tiny)}")
    return {"max_abs_err": 0.0}


def time_bcf_chain(path: str, checks: dict, launches: int, launches_from: str) -> dict:
    """The chain kernel over one split of the call set (the first), beside
    its plain version and its bound."""
    import torch

    from hadoop_bam_tpu_torch.io.bcf import BcfInputFormat, _read_bcf_split_local
    from hadoop_bam_tpu_torch.ops.kernels import bcf_chain as kb

    split = BcfInputFormat().get_splits([path])[0]
    _, payload, p, end, _, _ = _read_bcf_split_local(split)
    g = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).cuda()
    c = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    k_ms = cuda_ms(lambda: kb.walk_chain_device(g, p, end), iters=10)
    p_ms = host_ms(lambda: kb.walk_chain_device(c, p, end), iters=1)
    _, meta = kb.walk_chain_device(g, p, end)
    n_rec = int(meta[0])
    runs = [kb.walk_chain_phases(g, p, end)[2] for _ in range(5)]
    phase_us = {k: 1e3 * sum(r[f"{k}_ms"] for r in runs) / len(runs) for k in kb.PHASES}
    row = {
        "name": "bcf_chain", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/bcf_chain.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/bcf_chain.py:172",
        "launches": launches, "launches_from": launches_from,
        "max_abs_err": checks["bcf_chain"], "ms": k_ms, "plain_ms": p_ms,
        # per record: 8 B of lengths + 24 B of fixed fields read, 28 B of columns written
        "bound_ms": (8 + 24 + 28) * n_rec / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "shape": f"one split: {n_rec} records, {end - p} bytes",
        **{f"{k}_us": v for k, v in phase_us.items()},
        "hops": runs[0]["hops"],
    }
    log(f"  bcf_chain: {k_ms:.4f} ms (plain {p_ms:.3f} ms, bound {row['bound_ms']:.4f} ms) "
        f"at {row['shape']}")
    log("  bcf_chain phases (CUDA events, mean of 5, us): "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_us.items())
        + f"; {runs[0]['segments']} segments of {kb.SEG} bytes, {row['hops']} hops")
    return row


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


BAM_TEXT = "@HD\tVN:1.6\tSO:unsorted\n" + "".join(
    f"@SQ\tSN:{c}\tLN:{ln}\n" for c, ln in GRCH38
) + "@PG\tID:chip_smoke\tPN:chip_smoke\n"


def synth_rows(n: int, seed: int) -> np.ndarray:
    """``n`` synthetic records (:func:`synth_records`) as uint8 [n, 280]."""
    rng = np.random.default_rng(seed)
    chunk = 250_000
    return np.concatenate([synth_records(i, min(chunk, n - i), rng) for i in range(0, n, chunk)])


def synth_bam(path: str, n: int, seed: int, level: int = 6, rows=None, text: str = BAM_TEXT) -> int:
    """Write an unsorted BAM of ``n`` synthetic records (or of ``rows``),
    with header text ``text``; returns its size."""
    from hadoop_bam_tpu_torch.spec import bam, bgzf

    header = bam.BamHeader(text, list(GRCH38))
    stream = (synth_rows(n, seed) if rows is None else rows).reshape(-1)
    body, _ = bgzf.deflate_blocks(stream, level=level)
    with open(path, "wb") as f:
        f.write(bgzf.deflate_blocks(header.encode(), level=level)[0])
        f.write(body)
        f.write(bgzf.TERMINATOR)
    return os.path.getsize(path)


def bam_batch(path: str, fields=None):
    """Every record of a BAM as one decoded batch (the port's reader, host
    keys)."""
    from hadoop_bam_tpu_torch.io.bam import SORT_FIELDS, read_header_voffset, read_virtual_range

    _, vfirst = read_header_voffset(path)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    return read_virtual_range(data, vfirst, (len(data) << 16) | 0xFFFF,
                              fields=fields or SORT_FIELDS)


def record_digests(path: str):
    """``(keys, digests)`` of every record of a BAM, read back by the port's
    own reader (host keys)."""
    b = bam_batch(path)
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


def _counters():
    from hadoop_bam_tpu_torch.ops.kernels import bcf_chain as kb
    from hadoop_bam_tpu_torch.ops.kernels import chain as kch
    from hadoop_bam_tpu_torch.ops.kernels import crc32 as kcrc
    from hadoop_bam_tpu_torch.ops.kernels import deflate as kd
    from hadoop_bam_tpu_torch.ops.kernels import gather as kg
    from hadoop_bam_tpu_torch.ops.kernels import histogram as kh
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin
    from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed as kfix
    from hadoop_bam_tpu_torch.ops.kernels import inflate_probe as kip
    from hadoop_bam_tpu_torch.ops.kernels import overlap as kov
    from hadoop_bam_tpu_torch.ops.kernels import rans as kr
    from hadoop_bam_tpu_torch.ops.kernels import record_scan as krs
    from hadoop_bam_tpu_torch.ops.kernels import unpack as ku

    return (kin.LAUNCHES, kch.WALK_LAUNCHES, kch.KEYS_LAUNCHES, kd.LAUNCHES, kg.LAUNCHES,
            kcrc.LAUNCHES, krs.LAUNCHES, kb.LAUNCHES, kr.LAUNCHES, kov.LAUNCHES,
            kov.ROWS_LAUNCHES, kh.LAUNCHES,
            ku.LAUNCHES, kfix.LAUNCHES, kip.LAUNCHES)


def launch_counts() -> dict:
    return {c.name: c.value for c in _counters()}


def reset_counts() -> None:
    for c in _counters():
        c.reset()


def bgzf_content(path: str) -> bytes:
    """The decompressed bytes of a BGZF file (header, records, terminator)."""
    from hadoop_bam_tpu_torch.spec import bgzf

    with open(path, "rb") as f:
        data = f.read()
    co, cs, us = bgzf.scan_blocks(data)
    out, _ = bgzf.inflate_blocks(data, co, cs, us)
    return out.tobytes()


def timed_sort(src: str, out: str, what: str, trace: bool = False, job=None, **kw):
    """One ``sort_bam`` (or ``job``: ``markdup_bam``, ``fixmate_bam``) with
    the launch counts zeroed just before it and read just after it; with
    ``trace``, under ``torch.profiler`` (device activity only)."""
    import contextlib

    import torch

    from hadoop_bam_tpu_torch.pipeline import sort_bam

    job = job or sort_bam
    reset_counts()
    if kw.get("device") == "cuda":
        torch.cuda.synchronize()
    ctx = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
           if trace else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        st = job(src, out, **kw)
        if kw.get("device") == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    c = st.counters
    log(f"{what if '(' in what else f'sort_bam({what})'}: {st.n_records} records, "
        f"{st.n_splits} splits, backend {st.backend}, wall {wall:.3f} s, "
        f"{st.n_records / wall:.0f} reads/s, {os.path.getsize(out)} bytes out")
    log("  phases (s): " + json.dumps({k: round(v, 3) for k, v in st.seconds.items()}))
    log(f"  launches: {json.dumps(launches)}")
    log("  counters: " + json.dumps({k: v for k, v in sorted(c.items()) if v and (
        k.startswith(("flate.", "bam.", "sort_bam.", "device_stream.", "cram.", "collate.",
                      "fixmate.", "salvage.", "executor.", "faults.")))}))
    log("  transfers: " + json.dumps({k: v for k, v in c.items() if k.startswith("transfers.")}))
    if trace:
        log_device_time(prof, out + ".trace.json", wall)
    return st, wall, launches


def main_path(work: str, n: int, seed: int) -> dict:
    """Sort a synthetic BAM: (1) on the card with the default gates (every
    kernel on), (2) on the card with the write gates off and (3) on the
    CPU, byte-identical to (2), with (1)'s records equal to (3)'s; then
    (4) with one resident split and the default gates (the device part
    write), byte-identical to (5), the same split through host gather +
    deflate lanes."""
    import torch

    from hadoop_bam_tpu_torch.conf import (DEFLATE_LANES, INFLATE_LANES, WRITE_DEVICE,
                                            Configuration)

    src = os.path.join(work, "in.bam")
    t0 = time.perf_counter()
    rows = synth_rows(n, seed)
    size = synth_bam(src, n, seed, rows=rows)
    log(f"synthetic BAM: {n} records, {size} bytes, built in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {k: os.path.join(work, f"sorted.{k}.bam")
           for k in ("lanes", "zlib", "cpu", "resident", "resident_host")}
    # (1) The main path: sort_bam as a user calls it on the card.
    torch.cuda.reset_peak_memory_stats()
    st, wall, launches = timed_sort(src, out["lanes"], "cuda, default gates", device="cuda")
    card_peak = torch.cuda.max_memory_allocated()
    log(f"  card peak (torch.cuda.max_memory_allocated): {card_peak} bytes")
    c = st.counters
    missing = [k for k in ("inflate_members", "record_chain", "deflate_members")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of the main path never launched: {missing}")
    if launches["stream_keys"]:  # the keys ride the walk's emit
        raise AssertionError(f"the sort launched stream_keys {launches['stream_keys']} times")
    if c.get("flate.lanes_tierdown", 0) or c.get("flate.deflate_lanes_tierdown", 0):
        raise AssertionError("members tiered down on clean input")
    if c.get("flate.deflate.lanes", 0) <= 0 or st.n_records != n:
        raise AssertionError(f"sorted {st.n_records} of {n} records, "
                             f"{c.get('flate.deflate.lanes', 0)} members on the lanes")
    log(f"  bam.device_write_tierdown.no_residency "
        f"{c.get('bam.device_write_tierdown.no_residency', 0)} of {st.n_splits} parts")
    # (2), (3) The write side's gates off: parts through host zlib at level 6.
    off = Configuration({INFLATE_LANES: "true", DEFLATE_LANES: "false", WRITE_DEVICE: "false"})
    st_z, wall_z, _ = timed_sort(src, out["zlib"], "cuda, write gates off", conf=off,
                                 device="cuda", device_parse=True)
    st_cpu, wall_cpu, _ = timed_sort(src, out["cpu"], "cpu, write gates off", conf=off,
                                     device="cpu", device_parse=True)
    with open(out["zlib"], "rb") as f:
        a = f.read()
    with open(out["cpu"], "rb") as f:
        b = f.read()
    if a != b:
        raise AssertionError("cuda and cpu outputs differ")
    log(f"cuda output == cpu output (write gates off): {len(a)} bytes")
    if bgzf_content(out["lanes"]) != bgzf_content(out["cpu"]):
        raise AssertionError("default-gate output decompresses to other bytes than the cpu run")
    ratio = os.path.getsize(out["lanes"]) / len(a)
    log(f"default-gate output decompresses to the cpu run's bytes; size "
        f"{os.path.getsize(out['lanes'])} = {ratio:.4f} x zlib level 6 ({len(a)})")
    keys_out, dig_out = record_digests(out["lanes"])
    _, dig_in = record_digests(src)
    if not np.all(np.diff(keys_out) >= 0):
        raise AssertionError("output keys are not monotone")
    if not np.array_equal(np.sort(dig_out), np.sort(dig_in)):
        raise AssertionError("output records differ from the input's")
    log(f"re-read: {len(keys_out)} records, keys monotone, record multiset equal")
    # (4), (5) One split holds the whole file, so its window stays resident
    # and the part is gathered, CRC'd and deflated on the card.
    whole = size + 1
    st_r, wall_r, launches_r = timed_sort(src, out["resident"], "cuda, default gates, one split",
                                          device="cuda", split_size=whole)
    cr = st_r.counters
    if not (cr.get("bam.device_write_parts", 0) == st_r.n_splits
            and cr.get("bam.device_write_tierdown.no_residency", 0) == 0):
        raise AssertionError(f"device write did not take every part: {cr}")
    if min(launches_r[k] for k in ("gather_stream", "crc32", "deflate_members")) <= 0:
        raise AssertionError(f"device write kernels never launched: {launches_r}")
    host_lanes = Configuration({WRITE_DEVICE: "false", DEFLATE_LANES: "true"})
    timed_sort(src, out["resident_host"], "cuda, host gather + lanes, one split",
               conf=host_lanes, device="cuda", split_size=whole)
    with open(out["resident"], "rb") as f:
        a = f.read()
    with open(out["resident_host"], "rb") as f:
        b = f.read()
    if a != b:
        raise AssertionError("device write differs from host gather + deflate lanes")
    log(f"device write == host gather + deflate lanes: {len(a)} bytes")
    return {"src": src, "launches": launches, "launches_resident": launches_r, "wall": wall,
            "stats": st, "cpu": st_cpu, "ratio": ratio, "sorted": out["zlib"],
            "lanes": out["lanes"], "card_peak": card_peak, "flagstat": flagstat_oracle(rows)}


# ---------------------------------------------------------------------------
# The collation family: markdup, the queryname sort and fixmate
# ---------------------------------------------------------------------------

PAIR_CHUNK = 50_000  # pairs a generator chunk; every family, pair and copy lies in one
TWIN_PAIRS = 250_000  # the prefix the card/CPU twins of queryname and fixmate run on
READ_CIGAR_LEN = 150
NAME_PREFIX = b"A00123:8:H7KJ2DSXX:"


def _num_digits(v: np.ndarray):
    """Decimal digits of ``v >= 0`` without leading zeros: (uint8 [n, 10],
    lengths), left-justified."""
    v = v.astype(np.int64)
    nd = 1 + sum((v >= 10 ** k).astype(np.int64) for k in range(1, 10))
    d = _digits(v, 10)
    idx = np.minimum((10 - nd)[:, None] + np.arange(10)[None, :], 9)
    return np.take_along_axis(d, idx, axis=1), nd


def _hcat(pieces, n: int):
    """Concatenate ragged pieces ``(uint8 [n, w] or bytes, lengths)`` row by
    row: (uint8 [n, sum of widths], lengths)."""
    width = sum(len(p) if isinstance(p, bytes) else p.shape[1] for p, _ in pieces)
    out = np.zeros((n, width), np.uint8)
    cur = np.zeros(n, np.int64)
    rows = np.arange(n)
    for p, ln in pieces:
        if isinstance(p, bytes):
            for k, b in enumerate(p):
                out[rows, cur + k] = b
            cur = cur + len(p)
            continue
        for k in range(p.shape[1]):
            m = k < ln
            out[rows[m], cur[m] + k] = p[m, k]
        cur = cur + ln
    return out, cur


def illumina_names(lane: np.ndarray, i: np.ndarray, x: np.ndarray):
    """``A00123:8:H7KJ2DSXX:{lane}:{tile}:{x}:{y}`` + NUL for pair (or
    fragment) index ``i``: tile and y follow from i, so names are unique per
    (lane, i); x and y have varying digit counts, so natural order is not
    ASCII order.  (uint8 [n, w], l_read_name)."""
    n = len(i)
    tile = 1101 + (i % 4000) // 4
    y = 2 + 147 * (i // 4000)
    sep = (np.full((n, 1), ord(":"), np.uint8), np.ones(n, np.int64))
    lane_d = ((lane[:, None] + 48).astype(np.uint8), np.ones(n, np.int64))
    tile_d = _num_digits(tile)
    x_d, y_d = _num_digits(x), _num_digits(y)
    return _hcat([(NAME_PREFIX, None), lane_d, sep, tile_d, sep, x_d, sep, y_d,
                  (b"\x00", None)], n)


def _cigar_words(lead: np.ndarray, m: np.ndarray, trail: np.ndarray):
    """Up to three CIGAR ops (lead S, M, trail S) a record, left-justified:
    (uint8 [n, 12], n_cigar_op)."""
    words = np.stack([(lead << 4) | 4, m << 4, (trail << 4) | 4], axis=1).astype(np.uint32)
    valid = np.stack([lead > 0, m > 0, trail > 0], axis=1)
    order = np.argsort(~valid, axis=1, kind="stable")
    words = np.take_along_axis(words, order, axis=1)
    return words.view(np.uint8).reshape(len(lead), 12), valid.sum(axis=1)


_FIXED = np.dtype([("size", "<u4"), ("refid", "<i4"), ("pos", "<i4"), ("l_read_name", "u1"),
                   ("mapq", "u1"), ("bin", "<u2"), ("n_cigar_op", "<u2"), ("flag", "<u2"),
                   ("l_seq", "<u4"), ("next_refid", "<i4"), ("next_pos", "<i4"),
                   ("tlen", "<i4")])


def encode_bam_records(f: dict, rng) -> np.ndarray:
    """The record stream (size words included) of the records in ``f``:
    ``refid``, ``pos``, ``mapq``, ``flag``, ``next_refid``, ``next_pos``,
    ``tlen``, ``name`` / ``l_name``, ``lead`` / ``m`` / ``trail`` (the CIGAR);
    150 random bases and qualities 2..41 and an NM:C tag each."""
    n = len(f["refid"])
    L = READ_CIGAR_LEN
    cig, n_cig = _cigar_words(f["lead"], f["m"], f["trail"])
    span = np.maximum(f["m"], 1)
    pos = f["pos"].astype(np.int64)
    bin_ = np.where(pos >= 0, _reg2bin(np.maximum(pos, 0), np.maximum(pos, 0) + span), 4680)
    body = 32 + f["l_name"] + 4 * n_cig + (L + 1) // 2 + L + 4
    fixed = np.zeros(n, _FIXED)
    for k, v in (("size", body), ("refid", f["refid"]), ("pos", pos), ("l_read_name", f["l_name"]),
                 ("mapq", f["mapq"]), ("bin", bin_), ("n_cigar_op", n_cig), ("flag", f["flag"]),
                 ("l_seq", np.full(n, L)), ("next_refid", f["next_refid"]),
                 ("next_pos", f["next_pos"]), ("tlen", f["tlen"])):
        fixed[k] = v
    fixed = fixed.view(np.uint8).reshape(n, 36)
    nib = np.asarray([1, 2, 4, 8], dtype=np.uint8)[rng.integers(0, 4, (n, L), dtype=np.uint8)]
    seq = (nib[:, 0::2] << 4) | nib[:, 1::2]
    qual = rng.integers(2, 42, (n, L), dtype=np.uint8)
    tags = np.zeros((n, 4), np.uint8)
    tags[:, :3] = np.frombuffer(b"NMC", np.uint8)
    tags[:, 3] = rng.integers(0, 6, n, dtype=np.uint8)
    full = 4 + body
    offs = np.cumsum(full) - full
    stream = np.empty(int(full.sum()), np.uint8)
    key = f["l_name"].astype(np.int64) * 4 + n_cig
    for k in np.unique(key):
        rows = np.flatnonzero(key == k)
        ln, nc = int(f["l_name"][rows[0]]), int(n_cig[rows[0]])
        mat = np.concatenate([fixed[rows], f["name"][rows, :ln], cig[rows, : 4 * nc], seq[rows],
                              qual[rows], tags[rows]], axis=1)
        stream[offs[rows][:, None] + np.arange(mat.shape[1])[None, :]] = mat
    return stream


def synth_pair_chunk(p0: int, n: int, seed: int):
    """Records of pairs ``p0 .. p0 + n`` in random order, and their census.

    150 bp mates of fragments of about N(400, 50) over the GRCh38 primary
    contigs, first/second flags and mate fields, Illumina names; about 10%
    of the pairs in duplicate families of 2-4 copies with equal unclipped 5'
    ends (each copy its own soft clips and qualities); about 2% with the
    reverse mate unmapped and placed at its mate; 0.5% orphans (the reverse
    mate absent); secondary or supplementary copies of about 1% of the
    records; single-end fragments on the forward ends of about 1% of the
    pairs.  Every census count is exact for the chunk."""
    rng = np.random.default_rng([seed, p0])
    L = READ_CIGAR_LEN
    lens = np.asarray([c[1] for c in GRCH38], dtype=np.int64)
    idx = np.arange(p0, p0 + n, dtype=np.int64)
    refid = rng.choice(len(lens), n, p=lens / lens.sum()).astype(np.int64)
    frag = np.clip(np.rint(rng.normal(400, 50, n)), 200, 1000).astype(np.int64)
    start = (rng.random(n) * (lens[refid] - frag)).astype(np.int64)
    f1_fwd = rng.random(n) < 0.5
    # Duplicate families: blocks of a permutation copy their template's
    # fragment; each copy keeps its own clips and qualities.
    perm = rng.permutation(n)
    sizes = []
    while sum(sizes) < n // 10:
        sizes.append(int(rng.integers(2, 5)))
    in_fam = np.zeros(n, bool)
    at = 0
    for k in sizes:
        members = perm[at : at + k]
        t = members[0]
        refid[members], frag[members], start[members] = refid[t], frag[t], start[t]
        f1_fwd[members] = f1_fwd[t]
        in_fam[members] = True
        at += k
    rest = perm[at:]
    n_unm, n_orph, n_se = n // 50, n // 200, n // 100
    unm = np.zeros(n, bool)
    unm[rest[:n_unm]] = True
    orph = np.zeros(n, bool)
    orph[rest[n_unm : n_unm + n_orph]] = True
    se_on = rest[n_unm + n_orph : n_unm + n_orph + n_se]
    clip_f = np.where(in_fam, rng.integers(0, 21, n), rng.integers(0, 4, n) * (rng.random(n) < 0.2))
    clip_r = np.where(in_fam, rng.integers(0, 21, n), rng.integers(0, 4, n) * (rng.random(n) < 0.2))
    clip_r[unm] = 0
    fpos = start + clip_f
    rpos = start + frag - L
    rpos[unm] = fpos[unm]
    P, PROPER, UNM, MUNM, REV, MREV = 0x1, 0x2, 0x4, 0x8, 0x10, 0x20
    F1, F2 = 0x40, 0x80
    fflag = P | np.where(unm, MUNM, PROPER | MREV) | np.where(f1_fwd, F1, F2)
    rflag = P | np.where(unm, UNM, PROPER | REV) | np.where(f1_fwd, F2, F1)
    name, l_name = illumina_names(1 + idx % 4, idx, 1000 + rng.integers(0, 31001, n))
    z = np.zeros(n, np.int64)
    fwd = {"refid": refid, "pos": fpos, "mapq": np.full(n, 60), "flag": fflag,
           "next_refid": refid, "next_pos": np.where(unm, fpos, rpos),
           "tlen": np.where(unm, 0, frag), "name": name, "l_name": l_name,
           "lead": clip_f, "m": L - clip_f, "trail": z}
    rev = {"refid": refid, "pos": rpos, "mapq": np.where(unm, 0, 60), "flag": rflag,
           "next_refid": refid, "next_pos": fpos, "tlen": np.where(unm, 0, -frag),
           "name": name, "l_name": l_name, "lead": z, "m": np.where(unm, 0, L - clip_r),
           "trail": clip_r}
    keep_rev = ~orph
    parts = [fwd, {k: v[keep_rev] for k, v in rev.items()}]
    # Secondary / supplementary copies of about 1% of the records.
    n_sec = (2 * n) // 100
    src = rng.choice(np.flatnonzero(~unm & ~orph), n_sec, replace=False)
    sec = {k: v[src].copy() for k, v in fwd.items()}
    sec["pos"] = sec["pos"] + rng.integers(1000, 100_000, n_sec)
    sec["flag"] = sec["flag"] | np.where(rng.random(n_sec) < 0.5, 0x100, 0x800)
    sec["mapq"] = np.zeros(n_sec, np.int64)
    parts.append(sec)
    # Single-end fragments on the forward ends of pairs: always duplicates.
    se_name, se_lname = illumina_names(np.full(n_se, 5), idx[se_on], 1000 + rng.integers(0, 31001, n_se))
    zs = np.zeros(n_se, np.int64)
    parts.append({"refid": refid[se_on], "pos": start[se_on], "mapq": np.full(n_se, 60),
                  "flag": zs, "next_refid": zs - 1, "next_pos": zs - 1, "tlen": zs,
                  "name": se_name, "l_name": se_lname, "lead": zs, "m": zs + L, "trail": zs})
    w = max(p["name"].shape[1] for p in parts)
    for p in parts:
        p["name"] = np.pad(p["name"], ((0, 0), (0, w - p["name"].shape[1])))
    f = {k: np.concatenate([p[k] for p in parts]) for k in fwd}
    order = rng.permutation(len(f["refid"]))
    f = {k: v[order] for k, v in f.items()}
    census = {"pairs": n - n_orph, "orphans": n_orph, "singletons": n_se,
              "records": len(order), "family_pairs": int(in_fam.sum()),
              "planted_duplicates": 2 * sum(k - 1 for k in sizes) + n_se,
              "unmapped_mates": n_unm, "secondary_supplementary": n_sec}
    return encode_bam_records(f, rng), census


def synth_pairs(n_pairs: int, seed: int):
    """The record streams and censuses of the :func:`synth_pair_chunk`
    chunks of pairs ``0 .. n_pairs``, made by a process pool."""
    starts = list(range(0, n_pairs, PAIR_CHUNK))
    sizes = [min(PAIR_CHUNK, n_pairs - p0) for p0 in starts]
    with spawn_pool(min(len(starts), os.cpu_count() or 1)) as pool:
        got = list(pool.map(synth_pair_chunk, starts, sizes, [seed] * len(starts)))
    return [s for s, _ in got], [c for _, c in got]


def census_of(chunks) -> dict:
    return {k: sum(c[k] for c in chunks) for k in chunks[0]}


def write_pairs_bam(path: str, streams, level: int = 1) -> int:
    """The unsorted BAM of the record ``streams``, in order; returns its size."""
    from hadoop_bam_tpu_torch.spec import bam, bgzf

    header = bam.BamHeader(BAM_TEXT, list(GRCH38))
    body, _ = bgzf.deflate_blocks(np.concatenate(streams), level=level)
    with open(path, "wb") as f:
        f.write(bgzf.deflate_blocks(header.encode(), level=level)[0])
        f.write(body)
        f.write(bgzf.TERMINATOR)
    return os.path.getsize(path)


def same_bytes(a: str, b: str, what: str) -> int:
    with open(a, "rb") as f:
        x = f.read()
    with open(b, "rb") as f:
        y = f.read()
    if x != y:
        raise AssertionError(f"{what}: the outputs differ")
    return len(x)


def illumina_order_faults(path: str) -> int:
    """Adjacent records of a BAM whose names, all of :func:`illumina_names`'
    shape, are out of samtools' natural order: after the common prefix each
    name is ``lane:tile:x:y`` in decimal without leading zeros, so that
    order is the byte order of the four fields each right-justified in ten
    '0's, a key built for all the names at once."""
    b = bam_batch(path, ("rec_off", "rec_len", "l_read_name"))
    lens = b.soa["l_read_name"].astype(np.int64) - 1
    n, k, w = len(lens), len(NAME_PREFIX), int(lens.max())
    buf = np.concatenate([np.asarray(b.data, np.uint8), np.zeros(w, np.uint8)])
    names = np.lib.stride_tricks.sliding_window_view(buf, w)[b.soa["rec_off"].astype(np.int64) + 32]
    names = np.where(np.arange(w)[None, :] < lens[:, None], names, 0)
    if not (names[:, :k] == np.frombuffer(NAME_PREFIX, np.uint8)).all():
        raise AssertionError("a name lacks the generator's prefix")
    suffix = names[:, k:]
    rows, cols = np.nonzero(suffix == ord(":"))
    if len(rows) != 3 * n or (np.bincount(rows, minlength=n) != 3).any():
        raise AssertionError("a name has not four fields after the prefix")
    colon = cols.reshape(n, 3)
    starts = np.concatenate([np.zeros((n, 1), np.int64), colon + 1], axis=1)
    ends = np.concatenate([colon, (lens - k)[:, None]], axis=1)
    # Field f's last ten bytes, in a copy of the names padded on the left
    # with ten '0's; those before the field's start become '0'.
    at = ends[:, :, None] + np.arange(10)[None, None, :]
    padded = np.pad(suffix, ((0, 0), (10, 0)), constant_values=ord("0"))
    key = np.take_along_axis(padded, at.reshape(n, 40), axis=1).reshape(n, 4, 10)
    key = np.where(at - 10 >= starts[:, :, None], key, ord("0")).reshape(n, 40)
    if ((ends - starts) < 1).any() or ((ends - starts) > 10).any() or \
            ((key < ord("0")) | (key > ord("9"))).any():
        raise AssertionError("a name's field is not 1 to 10 decimal digits")
    ne = key[1:] != key[:-1]
    first = ne.argmax(axis=1)
    at_first = np.arange(n - 1)
    return int((ne.any(axis=1) & (key[1:][at_first, first] < key[:-1][at_first, first])).sum())


def collation_phase(work: str, n_pairs: int, seed: int) -> dict:
    """The collation family on a synthetic paired-end BAM of ``n_pairs``
    pairs (:func:`synth_pair_chunk`).  Markdup: the card with the default
    gates (traced), its duplicates counted back from the output and held to
    the generator; the card and the CPU with the write gates off on the
    generator's first ``TWIN_PAIRS`` pairs (byte-identical); the decision
    on the first chunk against the per-record oracle; then one resident
    split of the first ``TWIN_PAIRS`` pairs (the device write) against the
    host gather + deflate lanes, decompressing to the write-gates-off
    pair's bytes.  The queryname sort and fixmate on the first
    ``TWIN_PAIRS`` pairs: the card with the default gates (re-read: the
    order, the header, the counts), and the card and the CPU with the write
    gates off (byte-identical; fixmate's as one split, so that
    fixmate run again on the card's output, one split again, must give its
    bytes).  Returns the launches of each default-gate card job, and the twin
    file with its in-core outputs (the one-split markdup, the card's
    queryname and fixmate twins) for :func:`external_phase`."""
    from hadoop_bam_tpu_torch.conf import (DEFLATE_LANES, INFLATE_LANES, WRITE_DEVICE,
                                            Configuration)
    from hadoop_bam_tpu_torch.dedup import (DEDUP_EXTRA_FIELDS, mark_duplicates_device,
                                             mark_duplicates_oracle, signature_columns)
    from hadoop_bam_tpu_torch.io.bam import read_header
    from hadoop_bam_tpu_torch.pipeline import fixmate_bam, markdup_bam, sort_bam
    from hadoop_bam_tpu_torch.spec import bam

    t_phase = time.perf_counter()
    paths = {k: os.path.join(work, f"pairs.{k}.bam") for k in ("full", "twin")}
    streams, chunks = synth_pairs(n_pairs, seed)
    census = census_of(chunks)
    size = write_pairs_bam(paths["full"], streams)
    # Whole chunks, so that the twins' input is the full file's prefix.
    n_twin = max(1, min(len(streams), TWIN_PAIRS // PAIR_CHUNK))
    twin_size = write_pairs_bam(paths["twin"], streams[:n_twin])
    twin_census = census_of(chunks[:n_twin])
    twin_pairs = min(n_pairs, n_twin * PAIR_CHUNK)
    first = streams[0]
    del streams
    log(f"synthetic paired BAM: {n_pairs} pairs, {census['records']} records, {size} bytes, "
        f"built in {time.perf_counter() - t_phase:.1f} s; census {json.dumps(census)}")
    log(f"the one-split markdup pair and the queryname and fixmate twins (cuda and cpu, write "
        f"gates off) run on the first {twin_pairs} pairs ({twin_census['records']} records, "
        f"{twin_size} bytes)")
    src = paths["full"]
    out = {k: os.path.join(work, f"collate.{k}.bam") for k in (
        "md_a", "md_b", "md_c", "md_r", "md_rh", "qn_a", "qn_b", "qn_c", "fm_a", "fm_b", "fm_c",
        "fm_again")}
    off = Configuration({INFLATE_LANES: "true", DEFLATE_LANES: "false", WRITE_DEVICE: "false"})
    launches = {}

    def need(what: str, got: dict, names) -> None:
        missing = [k for k in names if got[k] <= 0]
        if missing:
            raise AssertionError(f"{what}: kernels never launched: {missing}")

    def decided(what: str, st, wall: float) -> None:
        """Log the decision of a markdup run on the card: its device time,
        which the job counted by CUDA events."""
        us = st.counters.get("dedup.decision_device_us", 0)
        if us <= 0:
            raise AssertionError(f"{what}: no decision timed on the card")
        log(f"  decision: {us / 1e3:.3f} ms of device time (CUDA events) = "
            f"{us / 1e6 / wall:.6f} of the wall; {st.seconds['markdup']:.6f} s of host time "
            f"(upload, decision, read-back), {st.n_duplicates} duplicates")

    # Markdup on the card with the default gates.
    st, wall, launches["markdup"] = timed_sort(src, out["md_a"], "markdup_bam(cuda, default "
                                               "gates)", trace=True, job=markdup_bam,
                                               device="cuda")
    need("markdup", launches["markdup"], ("inflate_members", "record_chain", "deflate_members"))
    if st.n_records != census["records"]:
        raise AssertionError(f"markdup: {st.n_records} of {census['records']} records")
    decided("markdup, default gates (the first decision of the process)", st, wall)
    flags = bam_batch(out["md_a"]).soa["flag"]
    n_marked = int(((flags & 0x400) != 0).sum())
    if n_marked != st.n_duplicates or st.n_duplicates < census["planted_duplicates"]:
        raise AssertionError(f"markdup: {st.n_duplicates} duplicates, {n_marked} flagged in the "
                             f"output, {census['planted_duplicates']} planted")
    log(f"  re-read: {n_marked} records flagged 0x400 = n_duplicates >= "
        f"{census['planted_duplicates']} planted")
    os.remove(out["md_a"])
    # The cut that pays for the out-of-core phase: the write-gates-off pair
    # runs on the twin file, not on the full one.
    log(f"markdup's write-gates-off pair (cuda and cpu) cut from {n_pairs} to the first "
        f"{twin_pairs} pairs")
    st_b, wall_b, _ = timed_sort(paths["twin"], out["md_b"], f"markdup_bam(cuda, write gates "
                                 f"off, {twin_pairs} pairs)", job=markdup_bam, conf=off,
                                 device="cuda")
    decided("markdup, write gates off", st_b, wall_b)
    st_c, _, _ = timed_sort(paths["twin"], out["md_c"], f"markdup_bam(cpu, write gates off, "
                            f"{twin_pairs} pairs)", job=markdup_bam, conf=off, device="cpu")
    nb = same_bytes(out["md_b"], out["md_c"], "markdup, cuda and cpu with the write gates off")
    if st_b.n_duplicates != st_c.n_duplicates:
        raise AssertionError("markdup: cuda and cpu marked differently")
    log(f"markdup: cuda == cpu with the write gates off ({nb} bytes)")
    os.remove(out["md_b"])
    # The decision on the first chunk (the file's first records) against
    # the per-record oracle.
    soa = bam.soa_decode(first, bam.record_offsets(first, 0),
                         ("rec_off", "rec_len", "refid", "pos", "flag") + DEDUP_EXTRA_FIELDS)
    t0 = time.perf_counter()
    mask = mark_duplicates_device(signature_columns(first, soa), device="cuda")
    t_dev = time.perf_counter() - t0
    recs = list(bam.iter_records(first))
    t0 = time.perf_counter()
    want = mark_duplicates_oracle(recs)
    t_or = time.perf_counter() - t0
    if not np.array_equal(mask, want) or not want.any():
        raise AssertionError("markdup: the decision differs from mark_duplicates_oracle")
    log(f"markdup decision (cuda) == mark_duplicates_oracle on the first "
        f"{chunks[0]['pairs'] + chunks[0]['orphans']} pairs ({len(recs)} records, "
        f"{int(want.sum())} duplicates; columns + decision {t_dev:.2f} s, oracle {t_or:.1f} s)")
    del first, soa, recs
    # One resident split: the device write patches the flags in the gather.
    one = 1 << 40
    st_r, wall_r, launches["markdup_resident"] = timed_sort(
        paths["twin"], out["md_r"], f"markdup_bam(cuda, default gates, one split, "
        f"{twin_pairs} pairs)", job=markdup_bam, device="cuda", split_size=one)
    decided("markdup, one split", st_r, wall_r)
    cr = st_r.counters
    need("markdup, one split", launches["markdup_resident"], ("gather_stream", "crc32",
                                                              "deflate_members"))
    if cr.get("bam.device_write_parts", 0) != st_r.n_splits or \
            st_r.n_duplicates < twin_census["planted_duplicates"]:
        raise AssertionError(f"markdup, one split: device write parts, duplicates {cr}")
    st_rh, _, _ = timed_sort(
        paths["twin"], out["md_rh"], f"markdup_bam(cuda, host gather + lanes, one split, "
        f"{twin_pairs} pairs)", job=markdup_bam,
        conf=Configuration({WRITE_DEVICE: "false", DEFLATE_LANES: "true"}), device="cuda",
        split_size=one)
    if st_rh.n_duplicates != st_r.n_duplicates:
        raise AssertionError("markdup, one split: the two write paths marked differently")
    nb = same_bytes(out["md_r"], out["md_rh"], "markdup, device write against host gather")
    log(f"markdup: device write (with the duplicate mask) == host gather + deflate lanes: "
        f"{nb} bytes")
    if bgzf_content(out["md_r"]) != bgzf_content(out["md_c"]) or \
            st_r.n_duplicates != st_c.n_duplicates:
        raise AssertionError("markdup: the default-gate output decompresses to other bytes")
    log("markdup: the one-split default-gate output decompresses to the write-gates-off "
        "pair's bytes")
    for k in ("md_rh", "md_c"):
        os.remove(out[k])

    # The queryname sort and fixmate run on the twin file only (the cut
    # that pays for the salvage phase): the card with the default gates and
    # the card and the CPU with the write gates off.
    log(f"the queryname sort's and fixmate's default-gate card runs cut from {n_pairs} to the "
        f"first {twin_pairs} pairs")
    q = dict(job=sort_bam, sort_order="queryname")
    st, _, launches["queryname"] = timed_sort(paths["twin"], out["qn_a"], f"sort_bam(cuda, "
                                              f"queryname, default gates, {twin_pairs} pairs)",
                                              device="cuda", **q)
    need("queryname", launches["queryname"], ("inflate_members", "deflate_members"))
    if read_header(out["qn_a"]).text.split("\n")[0].split("\t")[-1] != "SO:queryname":
        raise AssertionError("queryname: the header does not say SO:queryname")
    t0 = time.perf_counter()
    bad = illumina_order_faults(out["qn_a"])
    if bad or st.n_records != twin_census["records"]:
        raise AssertionError(f"queryname: {bad} adjacent names out of natural order")
    log(f"queryname: SO:queryname; {st.n_records} names non-decreasing in natural order (checked "
        f"in {time.perf_counter() - t0:.1f} s)")
    os.remove(out["qn_a"])
    timed_sort(paths["twin"], out["qn_b"], f"sort_bam(cuda, queryname, write gates off, "
               f"{twin_pairs} pairs)", conf=off, device="cuda", **q)
    timed_sort(paths["twin"], out["qn_c"], f"sort_bam(cpu, queryname, write gates off, "
               f"{twin_pairs} pairs)", conf=off, device="cpu", **q)
    nb = same_bytes(out["qn_b"], out["qn_c"], "queryname, cuda and cpu with the write gates off")
    log(f"queryname: cuda == cpu with the write gates off ({nb} bytes)")
    os.remove(out["qn_c"])

    st, _, launches["fixmate"] = timed_sort(paths["twin"], out["fm_a"], f"fixmate_bam(cuda, "
                                            f"default gates, {twin_pairs} pairs)",
                                            job=fixmate_bam, device="cuda")
    need("fixmate", launches["fixmate"], ("inflate_members", "deflate_members"))
    got = (st.n_pairs, st.n_singletons, st.n_orphans)
    n_back = len(bam_batch(out["fm_a"], ("rec_off", "rec_len")).soa["rec_off"])
    if got != (twin_census["pairs"], twin_census["singletons"], twin_census["orphans"]) or \
            n_back != twin_census["records"]:
        raise AssertionError(f"fixmate: pairs, singletons, orphans {got}, {n_back} records back, "
                             f"generator {twin_census}")
    log(f"fixmate: pairs {got[0]}, singletons {got[1]}, orphans {got[2]} as generated; "
        f"{n_back} records read back")
    os.remove(out["fm_a"])
    # The twins as one split (one part), so that fixmate run again on the
    # card's output, one split again, has the same part boundaries.
    fm = dict(job=fixmate_bam, conf=off, split_size=one)
    st_b, _, _ = timed_sort(paths["twin"], out["fm_b"], f"fixmate_bam(cuda, write gates off, "
                            f"one split, {twin_pairs} pairs)", device="cuda", **fm)
    st_c, _, _ = timed_sort(paths["twin"], out["fm_c"], f"fixmate_bam(cpu, write gates off, "
                            f"one split, {twin_pairs} pairs)", device="cpu", **fm)
    nb = same_bytes(out["fm_b"], out["fm_c"], "fixmate, cuda and cpu with the write gates off")
    got = [(x.n_pairs, x.n_singletons, x.n_orphans) for x in (st_b, st_c)]
    want_t = (twin_census["pairs"], twin_census["singletons"], twin_census["orphans"])
    if got != [want_t, want_t]:
        raise AssertionError(f"fixmate twins: {got}, generator {want_t}")
    log(f"fixmate: cuda == cpu with the write gates off ({nb} bytes), pairs, singletons, "
        f"orphans {want_t} as generated")
    os.remove(out["fm_c"])
    timed_sort(out["fm_b"], out["fm_again"], "fixmate_bam(cuda, write gates off, one split, "
               "its own output)", device="cuda", **fm)
    nb = same_bytes(out["fm_b"], out["fm_again"], "fixmate run again on its own output")
    log(f"fixmate run again on its own output of the first {twin_pairs} pairs: the same {nb} "
        f"bytes")
    os.remove(out["fm_again"])
    os.remove(paths["full"])
    log(f"collation phase: {time.perf_counter() - t_phase:.1f} s")
    # The twin file and its in-core outputs stay for the out-of-core phase.
    return {"launches": launches, "twin": paths["twin"], "twin_pairs": twin_pairs,
            "markdup": out["md_r"], "n_duplicates": st_r.n_duplicates, "queryname": out["qn_b"],
            "fixmate": out["fm_b"], "fixmate_counts": want_t}


# ---------------------------------------------------------------------------
# The out-of-core sort
# ---------------------------------------------------------------------------

#: ~479,000 of the main path's 280-byte records: the scale of Picard SortSam's
#: MAX_RECORDS_IN_RAM (500,000).
EXTERNAL_BUDGET = 128 << 20
TWIN_BUDGET = 32 << 20  # the collation family's budget on the twin file


def external_phase(work: str, mp: dict, col: dict, n: int) -> dict:
    """The out-of-core sort (``memory_budget``) on the inputs and outputs of
    :func:`main_path` and :func:`collation_phase`.  (a) The main path's
    input at ``EXTERNAL_BUDGET`` on the card with the default gates
    (traced): runs, ranges and ``peak_bytes`` within the budget, rows 1
    and 3 launched (row 3 once a range), rows 2, 3b and 3c not, every range
    tiered down ``no_residency``, no member tiered down, the in-core sort's
    records in its order, and a card peak below the in-core sort's.  (b) The same
    budget with the write gates off on the card and the CPU, byte-identical;
    on the card every chunk's and range's ``torch.sort`` permutation is held
    to NumPy's stable argsort.  (c) Markdup, the queryname sort and fixmate
    on the twin file at ``TWIN_BUDGET``, each decompressing to its in-core
    twin's bytes with the same counts.  A run cut below full depth (``n``
    records, the twin file's pairs) cuts both budgets in proportion, so
    that each job still spills several runs; the cut is logged."""
    import torch

    from hadoop_bam_tpu_torch import pipeline as tp
    from hadoop_bam_tpu_torch.conf import (DEFLATE_LANES, INFLATE_LANES, WRITE_DEVICE,
                                            Configuration)

    t_phase = time.perf_counter()
    out = {k: os.path.join(work, f"external.{k}.bam") for k in ("a", "b", "c", "md", "qn", "fm")}
    budget = max(4 << 20, EXTERNAL_BUDGET * n // FULL_DEPTH["records"])
    twin_budget = max(4 << 20, TWIN_BUDGET * col["twin_pairs"] // TWIN_PAIRS)
    if (budget, twin_budget) != (EXTERNAL_BUDGET, TWIN_BUDGET):
        log(f"out-of-core budgets cut from {EXTERNAL_BUDGET} and {TWIN_BUDGET} to {budget} and "
            f"{twin_budget} bytes")
    mib = f"{budget / (1 << 20):g}"
    torch.cuda.reset_peak_memory_stats()
    st, _, launches = timed_sort(mp["src"], out["a"], f"sort_bam(cuda, memory_budget {mib} "
                                 f"MiB, default gates)", trace=True, device="cuda",
                                 memory_budget=budget)
    card_peak = torch.cuda.max_memory_allocated()
    c = st.counters
    log(f"  runs {st.n_runs}, ranges {st.n_ranges}, peak_bytes {st.peak_bytes} (budget "
        f"{budget}); card peak {card_peak} bytes, against {mp['card_peak']} for the "
        f"in-core default-gate sort of the same input")
    if st.n_runs < 4 or st.n_ranges < 4 or st.peak_bytes > budget:
        raise AssertionError(f"out of core: {st.n_runs} runs, {st.n_ranges} ranges, peak "
                             f"{st.peak_bytes}")
    if launches["inflate_members"] <= 0 or launches["deflate_members"] != st.n_ranges:
        raise AssertionError(f"out of core: rows 1 and 3 launched {launches}")
    if launches["record_chain"] or launches["gather_stream"] or launches["crc32"]:
        raise AssertionError(f"out of core: rows 2, 3b or 3c launched {launches}")
    if c.get("bam.device_write_tierdown.no_residency", 0) != st.n_ranges:
        raise AssertionError(f"out of core: {c.get('bam.device_write_tierdown.no_residency')} "
                             f"no_residency tier-downs of {st.n_ranges} ranges")
    if c.get("flate.lanes_tierdown", 0) or c.get("flate.deflate_lanes_tierdown", 0):
        raise AssertionError("out of core: members tiered down on clean input")
    if card_peak >= mp["card_peak"]:
        raise AssertionError(f"out of core: card peak {card_peak} not below the in-core "
                             f"{mp['card_peak']}")
    if bgzf_content(out["a"]) != bgzf_content(mp["lanes"]):
        raise AssertionError("out of core: the output decompresses to other bytes than the "
                             "in-core sort's")
    log(f"out of core: {st.n_ranges} ranges, each one row-3 launch and one no_residency "
        f"tier-down; rows 2, 3b, 3c not launched; decompresses to the in-core sort's bytes")
    os.remove(out["a"])

    # (b) The write gates off: card and CPU, byte-identical, each chunk's
    # and range's card sort held to NumPy's stable argsort.
    off = Configuration({INFLATE_LANES: "true", DEFLATE_LANES: "false", WRITE_DEVICE: "false"})
    real = tp._sort_perm
    held = []

    def sort_perm_held(keys, backend, dev, metrics):
        perm = real(keys, backend, dev, metrics)
        if not np.array_equal(perm, np.argsort(keys, kind="stable")):
            raise AssertionError(f"torch.sort on the card differs from numpy's stable argsort "
                                 f"on {len(keys)} keys")
        held.append(len(keys))
        return perm

    tp._sort_perm = sort_perm_held
    try:
        st_b, _, _ = timed_sort(mp["src"], out["b"], f"sort_bam(cuda, memory_budget {mib} MiB, "
                                f"write gates off)", conf=off, device="cuda",
                                memory_budget=budget)
    finally:
        tp._sort_perm = real
    if len(held) != st_b.n_runs + st_b.n_ranges:
        raise AssertionError(f"{len(held)} sorts held, {st_b.n_runs} runs + {st_b.n_ranges} "
                             f"ranges")
    log(f"torch.sort(stable) on the card == numpy's stable argsort on {len(held)} chunks and "
        f"ranges ({sum(held)} keys)")
    timed_sort(mp["src"], out["c"], f"sort_bam(cpu, memory_budget {mib} MiB, write gates off)",
               conf=off, device="cpu", memory_budget=budget)
    nb = same_bytes(out["b"], out["c"], "out of core, cuda and cpu with the write gates off")
    log(f"out of core: cuda == cpu with the write gates off ({nb} bytes)")
    for k in ("b", "c"):
        os.remove(out[k])

    # (c) The collation family under a budget on the twin file.
    twin = col["twin"]
    tag = (f"memory_budget {twin_budget / (1 << 20):g} MiB, default gates, "
           f"{col['twin_pairs']} pairs")
    job_launches = {"sort": launches}
    st, _, job_launches["markdup"] = timed_sort(twin, out["md"], f"markdup_bam(cuda, {tag})",
                                                job=tp.markdup_bam, device="cuda",
                                                memory_budget=twin_budget)
    if st.n_runs < 4 or st.n_duplicates != col["n_duplicates"] or \
            bgzf_content(out["md"]) != bgzf_content(col["markdup"]):
        raise AssertionError(f"out-of-core markdup: {st.n_runs} runs, {st.n_duplicates} "
                             f"duplicates against {col['n_duplicates']}, or other bytes")
    log(f"out-of-core markdup: {st.n_runs} runs, {st.n_duplicates} duplicates; decompresses to "
        f"the in-core one-split markdup's bytes")
    st, _, job_launches["queryname"] = timed_sort(twin, out["qn"], f"sort_bam(cuda, queryname, "
                                                  f"{tag})", device="cuda",
                                                  sort_order="queryname",
                                                  memory_budget=twin_budget)
    if bgzf_content(out["qn"]) != bgzf_content(col["queryname"]):
        raise AssertionError("out-of-core queryname: other bytes than the in-core twin's")
    log(f"out-of-core queryname: {st.n_runs} runs; decompresses to the in-core twin's bytes")
    st, _, job_launches["fixmate"] = timed_sort(twin, out["fm"], f"fixmate_bam(cuda, {tag})",
                                                job=tp.fixmate_bam, device="cuda",
                                                memory_budget=twin_budget)
    got = (st.n_pairs, st.n_singletons, st.n_orphans)
    if got != col["fixmate_counts"] or bgzf_content(out["fm"]) != bgzf_content(col["fixmate"]):
        raise AssertionError(f"out-of-core fixmate: pairs, singletons, orphans {got} against "
                             f"{col['fixmate_counts']}, or other bytes")
    log(f"out-of-core fixmate: pairs, singletons, orphans {got}; decompresses to the in-core "
        f"twin's bytes")
    for k in ("md", "qn", "fm"):
        os.remove(out[k])
    for k in (twin, col["markdup"], col["queryname"], col["fixmate"]):
        os.remove(k)
    log(f"out-of-core phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": job_launches}


# ---------------------------------------------------------------------------
# The executor, the fault plan and salvage
# ---------------------------------------------------------------------------

#: The main path's 32 MiB splits that get a damaged member: a payload bit
#: (the CRC gate catches it) or a destroyed gzip magic (the member scan
#: re-syncs).
SALVAGE_DAMAGE = {1: "payload", 3: "magic", 5: "payload", 9: "payload"}
SALVAGE_PLAN = "exec.crash:items=0-2,attempts=0,n=3"
SALVAGE_SPLIT = 32 << 20  # the main path's split size
RESUME_DELETED = (2, 6, 10)  # the parts (b) deletes before its resume


def damage_bam(src: str, dst: str, split_size: int) -> dict:
    """Copy ``src`` to ``dst`` with one record member of each split of
    :data:`SALVAGE_DAMAGE` damaged: the member 3/8 into the split (away
    from the 8 MiB splits of the out-of-core sort's clamp), bit 0 of its
    eighth DEFLATE byte flipped or its gzip magic destroyed.  Returns the
    damaged members' offsets by split."""
    from hadoop_bam_tpu_torch.io.bam import BamInputFormat
    from hadoop_bam_tpu_torch.spec import bgzf

    with open(src, "rb") as f:
        data = bytearray(f.read())
    splits = BamInputFormat().get_splits([src], split_size=split_size)
    co, _, _ = bgzf.scan_blocks(bytes(data))
    picked = {}
    for k, how in SALVAGE_DAMAGE.items():
        s = splits[k]
        c0, c1 = s.vstart >> 16, s.vend >> 16
        c = int(co[int(np.searchsorted(co, c0 + 3 * (c1 - c0) // 8))])
        if how == "payload":
            data[c + 25] ^= 0x01
        else:
            data[c + 1] ^= 0xFF
        picked[k] = (c, how)
    with open(dst, "wb") as f:
        f.write(bytes(data))
    return picked


def _counted(c: dict, want: dict, what: str) -> None:
    got = {k: c.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what}: counters {got}, want {want}")
    log(f"  {what}: {json.dumps(got)}")


def salvage_phase(work: str, mp: dict, n: int) -> dict:
    """The executor, the fault plan and salvage on the main path's input at
    full width (its 32 MiB splits), with :data:`SALVAGE_DAMAGE` applied to a
    copy.  (a) A strict sort on the card raises ``BgzfError``; the salvage
    sort on the card with the default gates and a ``part_dir``, under
    :data:`SALVAGE_PLAN`, completes: four members quarantined after four
    strict fallbacks, three injected crashes retried, no split failed and no
    part quarantined, rows 1 and 2 on the seven clean splits, row 3 once a
    part; it decompresses to the CPU salvage sort's bytes (write gates
    off).  (b) Three parts, ``_SUCCESS`` and the output deleted, the rerun
    on the same ``part_dir`` skips the other eight and writes (a)'s bytes.
    (c) Out of core at ``EXTERNAL_BUDGET`` with ``max_attempts=1`` and
    ``exec.crash:items=1,attempts=*``: salvage quarantines range 1 (the
    executor's contract); the rerun with no plan reuses the spill, skips
    every other range and decompresses to (a)'s bytes.  Returns the
    launches of each card job."""
    from hadoop_bam_tpu_torch import faults
    from hadoop_bam_tpu_torch.conf import (DEFLATE_LANES, INFLATE_LANES, WRITE_DEVICE,
                                            Configuration)
    from hadoop_bam_tpu_torch.parallel.executor import bgzf_part_valid
    from hadoop_bam_tpu_torch.pipeline import sort_bam
    from hadoop_bam_tpu_torch.spec import bgzf

    t_phase = time.perf_counter()
    bad = os.path.join(work, "damaged.bam")
    picked = damage_bam(mp["src"], bad, SALVAGE_SPLIT)
    log(f"damaged copy of the main path's input: members {json.dumps(picked)} (split: offset, "
        f"how)")
    out = {k: os.path.join(work, f"salvage.{k}.bam") for k in ("strict", "a", "cpu", "c")}
    launches = {}
    t0 = time.perf_counter()
    try:
        sort_bam(bad, out["strict"], device="cuda", split_size=SALVAGE_SPLIT)
    except bgzf.BgzfError as e:
        log(f"sort_bam(cuda, strict) on the damaged copy raised BgzfError in "
            f"{time.perf_counter() - t0:.1f} s: {e}")
    else:
        raise AssertionError("the strict sort of the damaged copy did not raise")

    # (a) Salvage on the card under the plan, then on the CPU.
    pdir = os.path.join(work, "salvage.parts")
    faults.arm(SALVAGE_PLAN)
    try:
        st, _, launches["sort"] = timed_sort(bad, out["a"], f"sort_bam(cuda, salvage, default "
                                             f"gates, {SALVAGE_PLAN})", device="cuda",
                                             errors="salvage", part_dir=pdir,
                                             split_size=SALVAGE_SPLIT)
    finally:
        faults.disarm()
    n_damaged = len(SALVAGE_DAMAGE)
    clean_splits = st.n_splits - n_damaged
    _counted(st.counters, {"salvage.members_quarantined": n_damaged,
                           "salvage.strict_fallbacks": n_damaged, "salvage.splits_failed": 0,
                           "faults.fired.exec.crash": 3, "executor.retried": 3,
                           "executor.failed_parts": 0, "salvage.parts_quarantined": 0},
             "salvage sort (a)")
    la = launches["sort"]
    if la["record_chain"] != clean_splits or la["inflate_members"] < clean_splits or \
            la["deflate_members"] != st.n_splits or la["gather_stream"] or la["crc32"]:
        raise AssertionError(f"salvage sort: launches {la} for {clean_splits} clean splits of "
                             f"{st.n_splits}")
    log(f"  rows 1 and 2 on the {clean_splits} clean splits (row 1 {la['inflate_members']} "
        f"launches, with the damaged splits' strict attempts), row 3 once a part; "
        f"{st.n_records} of {n} records salvaged")
    off = Configuration({INFLATE_LANES: "true", DEFLATE_LANES: "false", WRITE_DEVICE: "false"})
    st_cpu, _, _ = timed_sort(bad, out["cpu"], "sort_bam(cpu, salvage, write gates off)",
                              conf=off, device="cpu", errors="salvage",
                              split_size=SALVAGE_SPLIT)
    _counted(st_cpu.counters, {"salvage.members_quarantined": n_damaged,
                               "salvage.strict_fallbacks": n_damaged}, "salvage sort, cpu")
    content = bgzf_content(out["a"])
    if content != bgzf_content(out["cpu"]) or st_cpu.n_records != st.n_records:
        raise AssertionError("the card's salvage sort decompresses to other bytes than the cpu's")
    log(f"salvage sort: cuda decompresses to the cpu salvage sort's bytes ({len(content)} "
        f"bytes, {st.n_records} records)")
    os.remove(out["cpu"])
    with open(out["a"], "rb") as f:
        a_bytes = f.read()

    # (b) Resume: three parts, _SUCCESS and the output gone.
    for i in RESUME_DELETED:
        os.remove(os.path.join(pdir, f"part-r-{i:05d}"))
    os.remove(os.path.join(pdir, "_SUCCESS"))
    os.remove(out["a"])
    st_b, _, launches["resume"] = timed_sort(bad, out["a"], "sort_bam(cuda, salvage, default "
                                             "gates, resumed part_dir)", device="cuda",
                                             errors="salvage", part_dir=pdir,
                                             split_size=SALVAGE_SPLIT)
    _counted(st_b.counters, {"executor.skipped_existing": st.n_splits - len(RESUME_DELETED),
                             "executor.attempts": len(RESUME_DELETED)}, "resume (b)")
    with open(out["a"], "rb") as f:
        if f.read() != a_bytes:
            raise AssertionError("the resumed salvage sort wrote other bytes")
    if launches["resume"]["deflate_members"] != len(RESUME_DELETED):
        raise AssertionError(f"resume: row 3 launched {launches['resume']}")
    log(f"resume: {len(RESUME_DELETED)} parts written, the other "
        f"{st.n_splits - len(RESUME_DELETED)} skipped, (a)'s bytes")
    shutil.rmtree(pdir)

    # (c) Out of core: range 1 fails its one attempt (quarantined under
    # salvage), then the rerun resumes.
    budget = max(4 << 20, EXTERNAL_BUDGET * n // FULL_DEPTH["records"])
    mib = f"{budget / (1 << 20):g}"
    xdir = os.path.join(work, "salvage.xparts")
    plan = "exec.crash:items=1,attempts=*"
    faults.arm(plan)
    try:
        st_c, _, launches["external"] = timed_sort(
            bad, out["c"], f"sort_bam(cuda, salvage, memory_budget {mib} MiB, max_attempts=1, "
            f"{plan})", device="cuda", errors="salvage", memory_budget=budget, part_dir=xdir,
            max_attempts=1)
    finally:
        faults.disarm()
    _counted(st_c.counters, {"salvage.members_quarantined": n_damaged,
                             "faults.fired.exec.crash": 1, "executor.failed_parts": 1,
                             "salvage.parts_quarantined": 1}, "out of core (c), first run")
    if os.path.exists(os.path.join(xdir, "part-r-00001")) or \
            not bgzf_part_valid(os.path.join(xdir, "part-r-00000")):
        raise AssertionError("out of core: range 1 was written, or range 0 was not")
    st_r, _, launches["external_resume"] = timed_sort(
        bad, out["c"], f"sort_bam(cuda, salvage, memory_budget {mib} MiB, resumed)",
        device="cuda", errors="salvage", memory_budget=budget, part_dir=xdir)
    _counted(st_r.counters, {"sort_bam.resume_spill_reused": 1,
                             "executor.skipped_existing": st_r.n_ranges - 1,
                             "executor.failed_parts": 0}, "out of core (c), resumed")
    if launches["external_resume"]["deflate_members"] != 1 or \
            bgzf_content(out["c"]) != content:
        raise AssertionError("out of core: the resumed run wrote more than one range, or its "
                             "output decompresses to other bytes than (a)'s")
    log(f"out of core: range 1 quarantined on its one attempt, then the resume wrote it alone "
        f"({st_r.n_ranges} ranges, peak_bytes {st_r.peak_bytes}); decompresses to (a)'s bytes")
    shutil.rmtree(xdir)
    for k in ("a", "c"):
        os.remove(out[k])
    os.remove(bad)
    seconds = time.perf_counter() - t_phase
    log(f"salvage phase, sorts (a)-(c): {seconds:.1f} s")
    return {"launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# The ingest path
# ---------------------------------------------------------------------------

GZ_MEMBER_BYTES = 60_000  # R2's gzip members: each fits a BGZF frame when repacked
ORACLE_PAIRS = 20_000  # the prefix the pure-host ingest_oracle is held to


def write_fastq_inputs(work: str, r1: bytes, r2: bytes, tag: str):
    """R1 as BGZF at level 6, R2 as plain multi-member gzip (members of at
    most 60,000 uncompressed bytes, level 6).  Returns the two paths."""
    import gzip
    from concurrent.futures import ThreadPoolExecutor

    from hadoop_bam_tpu_torch.spec import bgzf

    p1 = os.path.join(work, f"{tag}_R1.fastq.bgz")
    p2 = os.path.join(work, f"{tag}_R2.fastq.gz")
    with open(p1, "wb") as f:
        f.write(bgzf.deflate_blocks(r1, level=6)[0] + bgzf.TERMINATOR)
    cuts = [r2[k : k + GZ_MEMBER_BYTES] for k in range(0, len(r2), GZ_MEMBER_BYTES)]
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        members = list(pool.map(lambda c: gzip.compress(c, 6, mtime=0), cuts))
    with open(p2, "wb") as f:
        f.write(b"".join(members))
    return p1, p2


def device_time(trace_path: str) -> dict:
    """The device's work in a ``torch.profiler`` chrome trace: the union of
    its kernel, copy and set intervals (``busy_s``) and, per kernel name
    (copies and sets by kind), ``[count, ms]``, the 12 largest."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = []
    by_name: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((ts, ts + dur))
        name = e["name"].replace("(anonymous namespace)::", "")
        key = name.split("(")[0][:80] if e["cat"] == "kernel" else e["cat"]
        n, us = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, us + dur)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"busy_s": busy / 1e6, "events": len(spans),
            "by_name": {k: [n, round(us / 1e3, 3)] for k, (n, us) in top}}


def log_device_time(prof, trace_path: str, wall: float) -> bool:
    """Log the card's busy time, idle share and time by kernel from a
    ``torch.profiler`` run that took ``wall`` seconds; False when the trace
    holds no device event."""
    prof.export_chrome_trace(trace_path)
    dev = device_time(trace_path)
    os.remove(trace_path)
    if dev["events"]:
        log(f"  device (torch.profiler): busy {dev['busy_s']:.6f} s of the wall {wall:.6f} s,"
            f" idle {1 - dev['busy_s'] / wall:.6f}; {dev['events']} device events")
        log("  device time by kernel [count, ms]: " + json.dumps(dev["by_name"]))
        return True
    log("  device (torch.profiler): the trace holds no device events; not measured")
    return False


def timed_ingest(paths, out: str, what: str, trace: bool = False, **kw):
    """One ``ingest_fastq`` with the launch counts zeroed just before it and
    read just after it; with ``trace``, under ``torch.profiler`` (device
    activity only), its device time logged beside the wall."""
    import contextlib

    import torch

    from hadoop_bam_tpu_torch.ingest import ingest_fastq

    on_card = kw.get("device") == "cuda"
    reset_counts()
    if on_card:
        torch.cuda.synchronize()
    ctx = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
           if trace else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        st = ingest_fastq(paths[0], out, r2=paths[1], **kw)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    c = st.counters
    log(f"ingest_fastq({what}): {st.n_records} records, wall {wall:.3f} s, "
        f"{st.n_records / wall:.0f} reads/s, {st.out_bytes} bytes out")
    log("  stages (s): " + json.dumps({k: round(v, 3) for k, v in st.seconds.items()}))
    log("  stats: " + json.dumps(st.counts()))
    log(f"  launches: {json.dumps(launches)}")
    log("  counters: " + json.dumps({k: v for k, v in sorted(c.items()) if v and k.startswith(
        ("flate.", "fastq.", "ingest.", "collate.", "salvage.", "device_stream."))}))
    log("  transfers: " + json.dumps({k: v for k, v in c.items() if k.startswith("transfers.")}))
    if trace:
        log_device_time(prof, out + ".trace.json", wall)
    return st, wall, launches


def ingest_phase(work: str, n_pairs: int, seed: int) -> dict:
    """FASTQ ingest of ``n_pairs`` synthetic read pairs: (a) on the card with
    the default gates, (c) the port on the CPU; (a) decompresses to (c)'s
    bytes with (c)'s stats; then the port's ``ingest_oracle`` on a prefix
    of ``ORACLE_PAIRS`` equals the CPU run at that size.  (a) runs under
    ``torch.profiler`` for the card's busy time.  The card run with the
    deflate lanes off, byte-identical to (c), is cut (it paid for the
    salvage phase)."""
    from hadoop_bam_tpu_torch.ingest import ingest_oracle

    t0 = time.perf_counter()
    r1, r2 = fastq_pairs(n_pairs, seed)
    paths = write_fastq_inputs(work, r1, r2, "full")
    log(f"synthetic FASTQ: {n_pairs} pairs, {len(r1) + len(r2)} bytes of text, "
        f"{os.path.getsize(paths[0])} + {os.path.getsize(paths[1])} bytes compressed, built in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {k: os.path.join(work, f"ingest.{k}.bam") for k in ("a", "c", "pc", "oracle")}
    st_a, wall_a, launches = timed_ingest(paths, out["a"], "cuda, default gates", trace=True,
                                          device="cuda")
    c = st_a.counters
    missing = [k for k in ("inflate_members", "record_scan", "deflate_members")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of the ingest path never launched: {missing}")
    if st_a.scan_lanes == 0 or st_a.scan_serial or c.get("flate.lanes_tierdown", 0) \
            or c.get("flate.deflate_lanes_tierdown", 0):
        raise AssertionError(f"the card tiered down on clean input: {st_a.counts()}")
    if st_a.n_records != 2 * n_pairs or st_a.n_pairs != n_pairs or st_a.n_repacked == 0:
        raise AssertionError(f"ingest stats {st_a.counts()}")
    st_c, _, _ = timed_ingest(paths, out["c"], "cpu", device="cpu")
    cc_len = os.path.getsize(out["c"])
    if bgzf_content(out["a"]) != bgzf_content(out["c"]):
        raise AssertionError("ingest: default-gate output decompresses to other bytes than (c)")
    ratio = os.path.getsize(out["a"]) / cc_len
    log(f"ingest (a) decompresses to (c)'s bytes; size {os.path.getsize(out['a'])} = "
        f"{ratio:.4f} x (c)")
    for k in ("n_records", "n_pairs", "n_members", "n_repacked", "scan_chunks"):
        if getattr(st_a, k) != getattr(st_c, k):
            raise AssertionError(f"ingest stats differ between runs: {k}")
    # The oracle on a prefix of the same corpus.
    n_or = min(ORACLE_PAIRS, n_pairs)
    cut1 = _pair_prefix(r1, n_or)
    cut2 = _pair_prefix(r2, n_or)
    ppaths = write_fastq_inputs(work, cut1, cut2, "prefix")
    t0 = time.perf_counter()
    n_rec_or = ingest_oracle(ppaths[0], out["oracle"], r2=ppaths[1])
    t_or = time.perf_counter() - t0
    st_p, _, _ = timed_ingest(ppaths, out["pc"], f"cpu, {n_or}-pair prefix", device="cpu")
    with open(out["oracle"], "rb") as f:
        o = f.read()
    with open(out["pc"], "rb") as f:
        p = f.read()
    if o != p or n_rec_or != st_p.n_records:
        raise AssertionError("ingest_oracle differs from the cpu ingest on the prefix")
    log(f"ingest_oracle == ingest_fastq(cpu) on {n_or} pairs: {len(o)} bytes, "
        f"oracle {t_or:.1f} s")
    return {"launches": launches, "stats": st_a, "wall": wall_a, "r1": r1}


def timed_variants(path: str, region: str, what: str, trace: bool = False, conf=None,
                   device: str = "cuda"):
    """One ``variants_blob`` with the launch counts zeroed just before it and
    read just after it; with ``trace``, under ``torch.profiler`` (device
    activity only).  Returns ``(blob, wall, launches, counters)``."""
    import contextlib

    import torch

    from hadoop_bam_tpu_torch.device_stream import DeviceStream
    from hadoop_bam_tpu_torch.serve.endpoints import variants_blob
    from hadoop_bam_tpu_torch.utils.backend import resolve_device

    stream = DeviceStream(resolve_device(device), conf=conf)
    on_card = stream.device.type == "cuda"
    reset_counts()
    if on_card:
        torch.cuda.synchronize()
    ctx = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
           if trace else contextlib.nullcontext())
    timings: dict = {}
    with ctx as prof:
        t0 = time.perf_counter()
        blob = variants_blob(path, region, conf=conf, stream=stream, timings=timings)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    c = stream.metrics.counters()
    log(f"variants_blob({what}): {c.get('serve.variants.records', 0)} records, wall {wall:.3f} s, "
        f"{len(blob)} bytes out")
    log("  phases (s): " + json.dumps({k: round(v, 3) for k, v in timings.items()}))
    log(f"  launches: {json.dumps(launches)}")
    log("  counters: " + json.dumps({k: v for k, v in sorted(c.items()) if v and k.startswith(
        ("bcf.", "variants.", "flate.", "device_stream.", "serve."))}))
    log("  transfers: " + json.dumps({k: v for k, v in c.items() if k.startswith("transfers.")}))
    if trace:
        log_device_time(prof, os.path.join(os.path.dirname(path), "variants.trace.json"), wall)
    return blob, wall, launches, c


def variants_phase(work: str, n_sites: int, seed: int) -> dict:
    """Ranged queries of a synthetic call set of ``n_sites`` sites: per
    region of :data:`VARIANT_REGIONS`, ``variants_blob`` on the card with the
    default gates (inflate, chain walk and join on the card; the first
    region under ``torch.profiler``, and on the CPU with the walk and
    inflate gates on, the plain versions, byte-identical), each blob
    decoding to exactly the generator's records of the region.  Returns the
    call set and its generator's columns for :func:`salvage_variants`."""
    from hadoop_bam_tpu_torch.conf import BCF_CHAIN, INFLATE_LANES, Configuration
    from hadoop_bam_tpu_torch.utils.intervals import MAX_END, parse_interval

    path = os.path.join(work, "calls.bcf")
    t0 = time.perf_counter()
    contig, pos, rows, head = synth_bcf(path, n_sites, seed)
    log(f"synthetic BCF call set: {len(pos)} sites, {rows.size} bytes of records, "
        f"{os.path.getsize(path)} bytes BGZF at level 6, built in {time.perf_counter() - t0:.1f} s")
    check_bcf_rows(rows, contig, pos, 2000, seed)
    log("generated records: a sample of 2000 decodes to its sites and re-encodes to its bytes")
    names = [c for c, _ in GRCH38]
    cpu_conf = Configuration({BCF_CHAIN: "true", INFLATE_LANES: "true"})
    first = None
    for k, region in enumerate(VARIANT_REGIONS):
        blob, wall, launches, c = timed_variants(path, region, f"cuda, {region}", trace=(k == 0))
        missing = [x for x in ("inflate_members", "bcf_chain") if launches[x] <= 0]
        if missing:
            raise AssertionError(f"kernels of the variants path never launched: {missing}")
        if c.get("bcf.chain.host_walks", 0) or c.get("flate.lanes_tierdown", 0) \
                or c.get("variants.join_host", 0):
            raise AssertionError(f"the card tiered down on clean input: {c}")
        if k == 0:  # the other regions are held to the generator alone
            blob_cpu, _, _, _ = timed_variants(path, region, f"cpu, {region}", conf=cpu_conf,
                                               device="cpu")
            if blob != blob_cpu:
                raise AssertionError(f"variants {region}: card and cpu blobs differ")
        iv = parse_interval(region)
        keep = (contig == names.index(iv.contig)) & (pos >= iv.start) & (pos <= min(iv.end, MAX_END))
        if bgzf_bytes(blob) != head + rows[keep].tobytes():
            raise AssertionError(f"variants {region}: blob differs from the generator's records")
        log(f"variants {region}: {'cuda == cpu' if k == 0 else 'cuda'} ({len(blob)} bytes), "
            f"decodes to the generator's {int(keep.sum())} records")
        if first is None:
            first = {"launches": launches, "wall": wall}
    return {"path": path, "launches": first["launches"], "contig": contig, "pos": pos,
            "rows": rows, "head": head}


def salvage_variants(work: str, var: dict) -> dict:
    """The salvage phase's BCF read (d): a copy of the call set with one
    member inside :data:`VARIANT_REGIONS`' first window flipped, queried
    with ``hadoopbam.errors=salvage`` on the card (row 5 on every split but
    the torn one) and on the CPU: equal blobs, one member quarantined, and
    exactly the generator's records of the window that lie wholly outside
    the member."""
    from hadoop_bam_tpu_torch.conf import BCF_CHAIN, ERRORS_MODE, INFLATE_LANES, Configuration
    from hadoop_bam_tpu_torch.spec import bgzf
    from hadoop_bam_tpu_torch.utils.intervals import MAX_END, parse_interval

    t0 = time.perf_counter()
    region = VARIANT_REGIONS[0]
    iv = parse_interval(region)
    names = [c for c, _ in GRCH38]
    contig, pos, rows, head = var["contig"], var["pos"], var["rows"], var["head"]
    keep = (contig == names.index(iv.contig)) & (pos >= iv.start) & (pos <= min(iv.end, MAX_END))
    idx = np.nonzero(keep)[0]
    k = int(idx[len(idx) // 2])
    member = (len(head) + k * BCF_RECORD) // bgzf.MAX_PAYLOAD
    with open(var["path"], "rb") as f:
        data = bytearray(f.read())
    co, _, _ = bgzf.scan_blocks(bytes(data))
    # Not a member where a 4 MiB split starts: a split's end member is
    # read by two splits, and each would count it.
    split = 4 << 20
    member = next((m for m in (member, member - 1, member + 1)
                   if all(int(co[j - 1]) // split == int(co[j]) // split for j in (m, m + 1))),
                  member)
    c = int(co[member])
    data[c + 25] ^= 0x01
    path = os.path.join(work, "calls.damaged.bcf")
    with open(path, "wb") as f:
        f.write(bytes(data))
    del data
    log(f"damaged call set: member {member} at {c} (record {k} of the {region} window)")
    salvage = {ERRORS_MODE: "salvage"}
    blob, _, launches, cnt = timed_variants(path, region, f"cuda, salvage, {region}",
                                            conf=Configuration(salvage))
    blob_cpu, _, _, cnt_cpu = timed_variants(
        path, region, f"cpu, salvage, {region}", device="cpu",
        conf=Configuration(dict(salvage, **{BCF_CHAIN: "true", INFLATE_LANES: "true"})))
    _counted(cnt, {"salvage.members_quarantined": 1}, "variants salvage, cuda")
    _counted(cnt_cpu, {"salvage.members_quarantined": 1}, "variants salvage, cpu")
    walks = cnt.get("bcf.chain.device_walks", 0)
    if blob != blob_cpu or launches["bcf_chain"] < 1 or walks != launches["bcf_chain"]:
        raise AssertionError(f"variants salvage: blobs equal {blob == blob_cpu}, row 5 "
                             f"launches {launches['bcf_chain']}, device walks {walks}")
    lo, hi = member * bgzf.MAX_PAYLOAD, (member + 1) * bgzf.MAX_PAYLOAD
    start = len(head) + np.arange(len(contig), dtype=np.int64) * BCF_RECORD
    whole = (start + BCF_RECORD <= lo) | (start >= hi)
    if bgzf_bytes(blob) != head + rows[keep & whole].tobytes():
        raise AssertionError("variants salvage: other records than the generator's survivors")
    log(f"variants salvage: cuda == cpu ({len(blob)} bytes), the generator's "
        f"{int((keep & whole).sum())} of {int(keep.sum())} records; row 5 launched "
        f"{launches['bcf_chain']} times (the torn split took the salvage walk) in "
        f"{time.perf_counter() - t0:.1f} s")
    os.remove(path)
    return {"launches": launches, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# The text formats: SAM input to the sort, VCF text input, the counts join
# ---------------------------------------------------------------------------

TEXT_CHUNK = 250_000  # rows a rendering pass
GZIP_SITES = 500_000  # the plain-gzip VCF's sites: one split by the format's rule
JOIN_WINDOWS = 100_000
TEXT_KERNELS = ("inflate_members", "record_chain", "deflate_members", "gather_stream", "crc32",
                "bcf_chain")


def _rows_text(pieces, n: int) -> bytes:
    """Concatenate ragged pieces ``(uint8 [n, w] or bytes, lengths)`` row
    by row (as :func:`_hcat` does) and join the rows: a piece whose rows
    all fill its width, or a constant, goes in one scatter."""
    lens = [np.full(n, len(p), np.int64) if isinstance(p, bytes) else np.asarray(ln, np.int64)
            for p, ln in pieces]
    row_len = np.sum(lens, axis=0)
    cur = np.cumsum(row_len) - row_len
    out = np.empty(int(row_len.sum()), np.uint8)
    for (p, _), ln in zip(pieces, lens):
        if isinstance(p, bytes):
            out[cur[:, None] + np.arange(len(p))] = np.frombuffer(p, np.uint8)
        elif bool((ln == p.shape[1]).all()):
            out[cur[:, None] + np.arange(p.shape[1])] = p
        else:
            for k in range(p.shape[1]):
                m = ln > k
                out[cur[m] + k] = p[m, k]
        cur += ln
    return out.tobytes()


def _table(words):
    """``(uint8 [k, width], lengths)`` of byte strings, for row lookups."""
    w = max(len(x) for x in words)
    t = np.zeros((len(words), w), np.uint8)
    for i, x in enumerate(words):
        t[i, : len(x)] = np.frombuffer(x, np.uint8)
    return t, np.asarray([len(x) for x in words], np.int64)


def _i32_col(rows: np.ndarray, col: int) -> np.ndarray:
    return rows[:, col : col + 4].copy().view("<i4").reshape(-1).astype(np.int64)


def sam_text(rows: np.ndarray) -> bytes:
    """The SAM lines of :func:`synth_records` rows (no header), rendered by
    array passes: QNAME, FLAG, RNAME, POS, MAPQ, CIGAR (150M or *), RNEXT
    *, PNEXT 0, TLEN 0, SEQ, QUAL and ``NM:i:<n>``."""
    names, name_len = _table([b"*"] + [c.encode() for c, _ in GRCH38])
    cigars, cigar_len = _table([b"*", b"150M"])
    seq_lut = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
    parts = []
    for i in range(0, len(rows), TEXT_CHUNK):
        r = rows[i : i + TEXT_CHUNK]
        n = len(r)
        refid, pos = _i32_col(r, 4), _i32_col(r, 8)
        flag = r[:, 18].astype(np.int64) | (r[:, 19].astype(np.int64) << 8)
        mapped = r[:, 16] == 1
        cig = r[:, 47:51].copy().view("<u4").reshape(-1)
        if not np.all(cig[mapped] == 150 << 4) or np.any(r[~mapped, 16]):
            raise AssertionError("a synthetic record without the 150M or empty CIGAR")
        nib = r[:, 51:126]
        seq = np.empty((n, 150), np.uint8)
        seq[:, 0::2] = seq_lut[nib >> 4]
        seq[:, 1::2] = seq_lut[nib & 0xF]
        full = np.full(n, 150, np.int64)
        parts.append(_rows_text([
            (r[:, 36:50], r[:, 12].astype(np.int64) - 1), (b"\t", None),
            _num_digits(flag), (b"\t", None),
            (names[refid + 1], name_len[refid + 1]), (b"\t", None),
            _num_digits(pos + 1), (b"\t", None),
            _num_digits(r[:, 13]), (b"\t", None),
            (cigars[mapped.astype(np.int64)], cigar_len[mapped.astype(np.int64)]),
            (b"\t*\t0\t0\t", None), (seq, full), (b"\t", None), (r[:, 126:276] + 33, full),
            (b"\tNM:i:", None), ((r[:, 279:280] + 48), np.ones(n, np.int64)), (b"\n", None),
        ], n))
    return b"".join(parts)


def vcf_sites_text(contig: np.ndarray, pos: np.ndarray, bcf_rows: np.ndarray) -> tuple:
    """The call set's sites as VCF text lines (``#CHROM`` to ``INFO``), from
    the generator's BCF rows: REF, ALT, QUAL (two decimals), PASS, INFO AC,
    AF, AN, DP, and ``END`` where the row's rlen differs from the REF's
    length.  Returns ``(bytes, lines with END)``."""
    names, name_len = _table([c.encode() for c, _ in GRCH38])
    afs, af_len = _table([f"{k / 6:g}".encode() for k in range(7)])
    parts = []
    n_end = 0
    for i in range(0, len(pos), TEXT_CHUNK):
        r, c, p = bcf_rows[i : i + TEXT_CHUNK], contig[i : i + TEXT_CHUNK], pos[i : i + TEXT_CHUNK]
        n = len(r)
        rlen = _i32_col(r, 16)
        ref_len = np.ones(n, np.int64)  # the generator's REF is one base
        end_at = rlen != ref_len
        n_end += int(end_at.sum())
        q = np.round(r[:, 20:24].copy().view("<f4").reshape(-1).astype(np.float64) * 100)
        q = q.astype(np.int64)
        one = np.ones(n, np.int64)
        end_digits, end_len = _num_digits(p + rlen - 1)
        pieces = [
            (names[c], name_len[c]), (b"\t", None), _num_digits(p), (b"\t.\t", None),
            (r[:, 34:35], one), (b"\t", None), (r[:, 36:37], one), (b"\t", None),
            _num_digits(q // 100), (b".", None), (_digits(q % 100, 2), np.full(n, 2, np.int64)),
            (b"\tPASS\tAC=", None), _num_digits(r[:, 42]), (b";AF=", None),
            (afs[r[:, 42]], af_len[r[:, 42]]), (b";AN=6;DP=", None), _num_digits(r[:, 57]),
            (np.frombuffer(b";END=", np.uint8)[None, :].repeat(n, 0), np.where(end_at, 5, 0)),
            (end_digits, np.where(end_at, end_len, 0)), (b"\n", None),
        ]
        parts.append(_rows_text(pieces, n))
    return b"".join(parts), n_end


def _text_launches(launches: dict) -> dict:
    return {k: launches[k] for k in TEXT_KERNELS}


def timed_vcf(path: str, what: str, conf=None):
    """Every split of ``path`` through ``VcfInputFormat``, the launch counts
    zeroed just before and read just after: ``(keys, pos, end, splits,
    wall, launches)``."""
    from hadoop_bam_tpu_torch.io.vcf import VcfInputFormat

    reset_counts()
    t0 = time.perf_counter()
    fmt = VcfInputFormat(conf)
    splits = fmt.get_splits([path])
    batches = [fmt.read_split(s) for s in splits]
    wall = time.perf_counter() - t0
    launches = launch_counts()
    cols = [np.concatenate([getattr(b, k) for b in batches]) if batches else np.empty(0, np.int64)
            for k in ("keys", "pos", "end")]
    log(f"VcfInputFormat({what}): {len(cols[0])} records, {len(splits)} splits, "
        f"{os.path.getsize(path)} bytes, wall {wall:.3f} s, {len(cols[0]) / wall:.0f} records/s")
    log(f"  launches: {json.dumps(_text_launches(launches))}")
    return cols[0], cols[1], cols[2], splits, wall, launches


def text_phase(work: str, n: int, seed: int, var: dict, device: str = "cuda") -> dict:
    """The text formats on the card.  (a) The main path's ``n`` input rows
    as SAM text (:func:`sam_text` under :data:`BAM_TEXT`): ``sort_bam`` on
    the card with the default gates (host tokenizer, ``torch.sort``, parts
    through row 3) decompresses to the card sort of its BAM twin (the rows
    with the NM tag's type ``C`` made ``c``, the text encoder's narrowing);
    the first sorted part goes through ``SamOutputWriter`` and back.  (b)
    The call set's sites as VCF text, plain, BGZF and a plain-gzip prefix
    (one split), read through ``VcfInputFormat``: keys, pos and end equal
    the card read of the ``.bcf`` (rows 1 and 5); a malformed line is
    skipped under LENIENT and raises under STRICT.  (c) ``join_counts_device``
    on the card over the call set's ``[pos - 1, end)`` and
    :data:`JOIN_WINDOWS` seeded windows equals ``join_counts_np``.
    ``device="cpu"`` rehearses the phase without a card (no launch is
    counted there)."""
    import gzip

    import torch

    from hadoop_bam_tpu_torch.conf import (BCF_CHAIN, INFLATE_LANES,
                                            VCFRECORDREADER_VALIDATION_STRINGENCY, Configuration)
    from hadoop_bam_tpu_torch.device_stream import DeviceStream
    from hadoop_bam_tpu_torch.io.bcf import BcfInputFormat
    from hadoop_bam_tpu_torch.io.sam import SamInputFormat, SamOutputWriter
    from hadoop_bam_tpu_torch.ops.overlap import join_counts_device, join_counts_np
    from hadoop_bam_tpu_torch.spec import bam, bgzf
    from hadoop_bam_tpu_torch.spec.vcf import FormatException

    on_card = device == "cuda"
    dev = torch.device(device)
    t_phase = time.perf_counter()
    launches = {}
    # (a) SAM input to the sort.
    t0 = time.perf_counter()
    rows = synth_rows(n, seed)
    t_rows = time.perf_counter() - t0
    t0 = time.perf_counter()
    text = BAM_TEXT.encode() + sam_text(rows)
    t_render = time.perf_counter() - t0
    sam_path = os.path.join(work, "in.sam")
    with open(sam_path, "wb") as f:
        f.write(text)
    log(f"SAM text of the main path's {n} rows: {len(text)} bytes "
        f"({(len(text) - len(BAM_TEXT)) / n:.1f} a line), rows {t_rows:.1f} s, rendered in "
        f"{t_render:.1f} s")
    del text
    rows[:, 278] = ord("c")  # the text encoder narrows NM:i:<0..5> to type c
    twin = os.path.join(work, "in.twin.bam")
    synth_bam(twin, n, seed, rows=rows, text=BAM_TEXT.rstrip("\n"))
    del rows
    out_s, out_t = os.path.join(work, "sorted.sam.bam"), os.path.join(work, "sorted.twin.bam")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    st, wall, launches["sam_sort"] = timed_sort(sam_path, out_s, f"{device}, .sam, default gates",
                                                device=device)
    if on_card:
        log(f"  card peak (torch.cuda.max_memory_allocated): "
            f"{torch.cuda.max_memory_allocated()} bytes")
    la, c = launches["sam_sort"], st.counters
    if st.n_records != n or (on_card and (la["deflate_members"] != st.n_splits or any(
            la[k] for k in ("inflate_members", "record_chain", "gather_stream", "crc32")))):
        raise AssertionError(f"SAM sort: {st.n_records} of {n} records, {st.n_splits} splits, "
                             f"launches {la}")
    _, _, launches["sam_twin_sort"] = timed_sort(twin, out_t, f"{device}, BAM twin of the .sam",
                                                 device=device)
    if bgzf_content(out_s) != bgzf_content(out_t):
        raise AssertionError("the .sam sort decompresses to other bytes than its BAM twin's")
    log(f"sort_bam(.sam) decompresses to sort_bam(BAM twin)'s bytes; row 3 launched "
        f"{la['deflate_members']} times for {st.n_splits} parts, rows 1, 2, 3b, 3c "
        f"{[la[k] for k in ('inflate_members', 'record_chain', 'gather_stream', 'crc32')]}")
    os.remove(twin)
    os.remove(out_t)
    # The first sorted part through the text writer and back.
    t0 = time.perf_counter()
    b = bam_batch(out_s)
    k = n // st.n_splits
    back = os.path.join(work, "part0.sam")
    with open(back, "wb") as f:
        w = SamOutputWriter(f, bam.BamHeader(BAM_TEXT.rstrip("\n"), list(GRCH38)))
        w.write_batch(b, range(k))
    fmt = SamInputFormat()
    got = b"".join(np.asarray(fmt.read_split(s).data).tobytes() for s in fmt.get_splits([back]))
    s0 = int(b.soa["rec_off"][0]) - 4
    s1 = int(b.soa["rec_off"][k - 1] + b.soa["rec_len"][k - 1])
    if got != np.asarray(b.data[s0:s1]).tobytes():
        raise AssertionError("the first sorted part does not read back through SamOutputWriter")
    log(f"SamOutputWriter: the first sorted part's {k} records ({os.path.getsize(back)} bytes "
        f"of SAM) read back to the same record bytes in {time.perf_counter() - t0:.1f} s")
    del b
    for x in (back, sam_path, out_s):
        os.remove(x)
    # (b) The call set's sites as VCF text.
    t0 = time.perf_counter()
    contig, pos = var["contig"], var["pos"]
    body, n_end = vcf_sites_text(contig, pos, var["rows"])
    head_lines = [x for x in bcf_header_lines() if not x.startswith("#CHROM")]
    head = ("\n".join(head_lines + ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"])
            + "\n").encode()
    plain = os.path.join(work, "sites.vcf")
    with open(plain, "wb") as f:
        f.write(head + body)
    bgz = os.path.join(work, "sites.vcf.gz")
    with open(bgz, "wb") as f:
        f.write(bgzf.deflate_blocks(head + body, level=1)[0] + bgzf.TERMINATOR)
    n_gz = min(GZIP_SITES, len(pos))
    cut = int(np.flatnonzero(np.frombuffer(body, np.uint8) == 10)[n_gz - 1]) + 1
    gz = os.path.join(work, "sites.head.vcf.gz")
    with open(gz, "wb") as f:
        f.write(gzip.compress(head + body[:cut], compresslevel=1, mtime=0))
    log(f"VCF text of the call set: {len(pos)} sites, {len(head) + len(body)} bytes plain, "
        f"{os.path.getsize(bgz)} BGZF at level 1, the first {n_gz} sites as plain gzip "
        f"({os.path.getsize(gz)} bytes); INFO END on {n_end} lines; built in "
        f"{time.perf_counter() - t0:.1f} s")
    del body
    # The oracle: the card read of the .bcf (rows 1 and 5).
    reset_counts()
    t0 = time.perf_counter()
    # Off the card the walk and inflate gates default off: arm their plain versions.
    stream = DeviceStream(dev, conf=None if on_card else Configuration(
        {BCF_CHAIN: "true", INFLATE_LANES: "true"}))
    bfmt = BcfInputFormat()
    bb = [bfmt.read_split(s, stream=stream) for s in bfmt.get_splits([var["path"]])]
    if on_card:
        torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches["bcf_oracle"] = lb = launch_counts()
    want = [np.concatenate([getattr(x, k) for x in bb]) for k in ("keys", "pos", "end")]
    dev_pos = torch.cat([x.device_columns[1] for x in bb])
    dev_end = torch.cat([x.device_columns[2] for x in bb])
    del bb
    if len(want[0]) != len(pos) or (on_card and min(lb["inflate_members"], lb["bcf_chain"]) <= 0):
        raise AssertionError(f"BCF read ({device}): {len(want[0])} records, launches {lb}")
    log(f"BcfInputFormat({device}): {len(want[0])} records in {wall_b:.3f} s; launches "
        f"{json.dumps(_text_launches(lb))}")
    for job, path, what, m in (("vcf_plain", plain, "plain .vcf", len(pos)),
                               ("vcf_bgzf", bgz, "BGZF .vcf.gz", len(pos)),
                               ("vcf_gzip", gz, "plain-gzip .vcf.gz", n_gz)):
        keys, p, e, splits, _, launches[job] = timed_vcf(path, what)
        if not all(np.array_equal(x, y[:m]) for x, y in zip((keys, p, e), want)):
            raise AssertionError(f"VcfInputFormat({what}): columns differ from the BCF read")
        if path == gz and len(splits) != 1:
            raise AssertionError(f"plain gzip planned as {len(splits)} splits")
        log(f"  keys, pos and end == the BCF read's first {m} rows")
    # A malformed line: LENIENT skips it, STRICT raises.
    with open(plain, "rb") as f:
        small = f.read(len(head) + 4_000_000)
    small = small[: small.rindex(b"\n") + 1]
    at = small.index(b"\n", len(head) + (len(small) - len(head)) // 2) + 1
    bad_path = os.path.join(work, "bad.vcf")
    with open(bad_path, "wb") as f:
        f.write(small[:at] + b"chr1\tBAD\t.\tA\tT\t.\tPASS\t.\n" + small[at:])
    m = small.count(b"\n") - len(head_lines) - 1
    keys = timed_vcf(bad_path, "a malformed line, LENIENT", conf=Configuration(
        {VCFRECORDREADER_VALIDATION_STRINGENCY: "LENIENT"}))[0]
    if not np.array_equal(keys, want[0][:m]):
        raise AssertionError("LENIENT did not skip exactly the malformed line")
    try:
        timed_vcf(bad_path, "a malformed line, STRICT", conf=Configuration(
            {VCFRECORDREADER_VALIDATION_STRINGENCY: "STRICT"}))
    except FormatException as err:
        log(f"  STRICT raised FormatException: {err}")
    else:
        raise AssertionError("STRICT read a malformed line")
    for x in (plain, bgz, gz, bad_path):
        os.remove(x)
    # (c) The counts join on the card, per contig (one coordinate axis).
    rng = np.random.default_rng(seed + 5)
    lens = np.asarray([c[1] for c in GRCH38], dtype=np.int64)
    q_c = np.sort(rng.choice(len(lens), JOIN_WINDOWS, p=lens / lens.sum()))
    q_b = (rng.random(JOIN_WINDOWS) * lens[q_c]).astype(np.int64)
    q_e = q_b + rng.integers(1, 100_000, JOIN_WINDOWS)
    ids = np.arange(len(lens))
    rc = want[0] >> 32
    r_lo, r_hi = np.searchsorted(rc, ids), np.searchsorted(rc, ids, side="right")
    w_lo, w_hi = np.searchsorted(q_c, ids), np.searchsorted(q_c, ids, side="right")
    qb_d, qe_d = torch.from_numpy(q_b).to(dev), torch.from_numpy(q_e).to(dev)
    starts_d = dev_pos - 1

    def join():
        return torch.cat([join_counts_device(starts_d[r_lo[i]:r_hi[i]], dev_end[r_lo[i]:r_hi[i]],
                                             qb_d[w_lo[i]:w_hi[i]], qe_d[w_lo[i]:w_hi[i]])
                          for i in ids])

    join()  # warm
    reset_counts()
    if on_card:
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.perf_counter()
    got = join()
    if on_card:
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    launches["counts_join"] = launch_counts()
    t0 = time.perf_counter()
    plain_c = np.concatenate([join_counts_np(want[1][r_lo[i]:r_hi[i]] - 1, want[2][r_lo[i]:r_hi[i]],
                                             q_b[w_lo[i]:w_hi[i]], q_e[w_lo[i]:w_hi[i]])
                              for i in ids])
    np_ms = (time.perf_counter() - t0) * 1e3
    if got.device.type != dev.type or not np.array_equal(got.cpu().numpy(), plain_c):
        raise AssertionError("join_counts_device differs from join_counts_np")
    log(f"join_counts_device({device}): {JOIN_WINDOWS} windows over {len(pos)} sites on "
        f"{len(lens)} contigs, {ms:.3f} ms ({'CUDA events' if on_card else 'host clock'}, "
        f"columns resident), == join_counts_np ({np_ms:.3f} ms on the host); "
        f"{int(plain_c.sum())} overlaps")
    seconds = time.perf_counter() - t_phase
    log(f"text phase: {seconds:.1f} s")
    return {"launches": launches, "seconds": seconds, "join_ms": ms}


# ---------------------------------------------------------------------------
# The CRAM path
# ---------------------------------------------------------------------------

CRAM_PER_CONTAINER = 10_000  # the CRAM writer's default records per container
ROW = 280  # bytes of every synthetic BAM record (see synth_records)


def cram_container(task) -> bytes:
    """One no-ref rANS CRAM container of BAM record rows; ``task`` is ``(rows
    as bytes, first record's counter)``.  Runs in the generator's spawned
    worker processes."""
    blob, counter = task
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from hadoop_bam_tpu_torch.spec import bam, cram

    recs = [bam.decode_record(blob, k)[0] for k in range(0, len(blob), ROW)]
    return cram.encode_container(recs, counter, 3, codec="rans")


def spawn_pool(workers: int):
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))


def synth_cram(path: str, rows: np.ndarray) -> int:
    """Write ``rows`` as a no-ref rANS CRAM, :data:`CRAM_PER_CONTAINER`
    records per container, the containers encoded by a process pool (the
    rANS encoder runs in Python); returns the number of containers."""
    from hadoop_bam_tpu_torch.spec import cram

    tasks = [(rows[i : i + CRAM_PER_CONTAINER].tobytes(), i)
             for i in range(0, len(rows), CRAM_PER_CONTAINER)]
    with spawn_pool(min(len(tasks), os.cpu_count() or 1)) as pool:
        blobs = list(pool.map(cram_container, tasks))
    with open(path, "wb") as f:
        f.write(cram.MAGIC + bytes([3, 0]) + b"\x00" * 20)
        f.write(cram.encode_file_header_container(BAM_TEXT, 3))
        for b in blobs:
            f.write(b)
        f.write(cram.EOF_V3)
    return len(blobs)


def rans_blocks(data: bytes, offset: int = 0) -> list:
    """The non-empty rANS block payloads of the CRAM containers in ``data``
    from ``offset`` on (a whole file: pass the first data container's)."""
    from hadoop_bam_tpu_torch.spec import cram, cram_codecs

    out = []
    pos = offset
    while pos < len(data) and not cram.is_eof_marker(data, pos):
        ch = cram.parse_container_header(data, pos, 3)
        p = ch.offset + ch.header_size
        while p < ch.next_offset:
            fr, p = cram.Block.read_frame(data, p, 3)
            if fr.method == cram_codecs.METHOD_RANS and fr.payload:
                out.append(fr.payload)
        pos = ch.next_offset
    return out


def _drop_context(enc: bytes, ctx: int) -> bytes:
    """An order-1 stream whose outer table lacks ``ctx`` (a context that is
    neither the first nor inside an RLE run)."""
    from hadoop_bam_tpu_torch.spec import cram_codecs as cc

    p, cur = 10, enc[9]
    while True:
        _, q = cc._read_freq_table0(enc, p)
        nxt = enc[q]
        if nxt == ctx:
            _, r = cc._read_freq_table0(enc, q + 1)
            return enc[:q] + enc[r:]
        if nxt in (0, cur + 1):
            raise ValueError(f"context {ctx} cannot be dropped")
        cur, p = nxt, q + 1


def rans_cases(seed: int, container: bytes) -> dict:
    """``{what: (stream, raw or None)}``: every rANS block of one
    10,000-record container (raw None), edge streams in both orders, and
    the corrupt streams (raw None)."""
    from hadoop_bam_tpu_torch.spec import cram_codecs as cc

    rng = np.random.default_rng(seed)
    xyz = lambda n: rng.choice(np.frombuffer(b"xyz", np.uint8), n).tobytes()  # noqa: E731
    cases = {f"container block {k} ({len(b)} B)": (b, None)
             for k, b in enumerate(rans_blocks(container))}
    edge = {"empty": b"", "1 byte": b"A", "2 bytes": b"AB", "3 bytes": b"ABC",
            "single symbol": b"B" * 5000, "uniform-256": bytes(range(256)) * 16,
            "tail 4093": xyz(4093), "tail 4094": xyz(4094), "tail 4095": xyz(4095)}
    for order in (0, 1):
        for what, raw in edge.items():
            cases[f"{what}, order {order}"] = (cc.rans_encode(raw, order), raw)
    every = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    cases["all 256 contexts, order 1"] = (cc.rans_encode(every, 1), every)
    good = cc.rans_encode(b"QRSTUV" * 300, 0)
    zero = bytearray(good)
    at = len(good) - len(cc.parse_rans_plan(good).payload) - 16
    zero[at : at + 16] = bytes(16)
    cases.update({
        "truncated payload": (good[:-40], None),
        "bad order byte": (bytes([7]) + good[1:], None),
        "zeroed states": (bytes(zero), None),
        "order-1 missing context": (
            _drop_context(cc.rans_encode(b"AC" * 400 + b"AT" * 100, 1), ord("T")), None),
    })
    return cases


#: Initial states at the edges of the 32-bit state arithmetic: 0, the
#: values below which a renorm fails (2^7), reads two bytes (2^15) or one
#: (2^23), and the top of the u32 range.
RANS_STATE_EXTREMES = (0, 2**7 - 1, 2**15 - 1, 2**23 - 1, 2**31, 2**32 - 1)


def _with_states(enc: bytes, states) -> bytes:
    """``enc`` with its four initial states replaced."""
    from hadoop_bam_tpu_torch.spec import cram_codecs as cc

    at = len(enc) - len(cc.parse_rans_plan(enc).payload) - 16
    return enc[:at] + struct.pack("<4I", *states) + enc[at + 16:]


def rans_state_cases(seed: int) -> dict:
    """``{what: stream}``: streams of both orders (and a single-symbol one)
    whose initial states sit at :data:`RANS_STATE_EXTREMES`, all four alike
    and mixed."""
    from hadoop_bam_tpu_torch.spec import cram_codecs as cc

    rng = np.random.default_rng(seed)
    raw = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 3001, p=[.3, .2, .2, .29, .01]).tobytes()
    bases = {"order 0": cc.rans_encode(raw, 0), "order 1": cc.rans_encode(raw, 1),
             "single symbol": cc.rans_encode(b"G" * 1001, 0)}
    cases = {}
    for what, enc in bases.items():
        for v in RANS_STATE_EXTREMES:
            cases[f"{what}, states {v:#x}"] = _with_states(enc, (v,) * 4)
        mixed = rng.permutation(np.asarray(RANS_STATE_EXTREMES[2:], np.uint64)).tolist()
        cases[f"{what}, states mixed"] = _with_states(enc, mixed)
    return cases


def rans_host_tensors(h: dict) -> list:
    """The CPU tensors of a packed rANS batch (:func:`kr.pack`), in the
    order ``rans_decode_device`` takes them."""
    import torch

    host = [torch.from_numpy(np.ascontiguousarray(h[k])) for k in ("payload", "meta", "lookup")]
    return host + [torch.from_numpy(h["fc"].view(np.int32)), torch.from_numpy(h["cmap"])]


def check_rans(seed: int, container: bytes) -> dict:
    """The rANS kernel against its plain version (outputs and verdicts,
    exactly) on every case of :func:`rans_cases`, one launch for all, and
    on :func:`rans_state_cases`; then its time at one container's blocks
    (the launch a sort makes per container) beside the plain version and
    the bound, and the time of the container's largest order-0 and order-1
    streams alone."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import rans as kr
    from hadoop_bam_tpu_torch.spec import cram_codecs as cc

    cases = rans_cases(seed, container)
    datas = [d for d, _ in cases.values()]
    outs_k, st_k = kr.rans_lanes(datas, torch.device("cuda"))
    t0 = time.perf_counter()
    outs_p, st_p = kr.rans_lanes(datas, torch.device("cpu"))
    p_all = time.perf_counter() - t0
    bad = [w for w, a, b in zip(cases, outs_k, outs_p) if a != b]
    if bad or st_k.as_dict() != st_p.as_dict():
        raise AssertionError(f"rans kernel differs from plain: {bad}, {st_k.as_dict()} vs "
                             f"{st_p.as_dict()}")
    wrong = [w for (w, (_, raw)), o in zip(cases.items(), outs_k) if raw is not None and o != raw]
    if wrong:
        raise AssertionError(f"rans kernel decodes other bytes than were encoded: {wrong}")
    failed = [w for w, o in zip(cases, outs_k) if o is None]
    if failed != list(cases)[-4:] or (st_k.tierdown_format, st_k.tierdown_ok0) != (1, 3):
        raise AssertionError(f"rans verdicts: {failed}, {st_k.as_dict()}")
    blocks = rans_blocks(container)
    plans = [cc.parse_rans_plan(b) for b in blocks]
    big = max(p.n_out for p in plans)
    log(f"rans kernel == plain: {len(cases)} streams ({len(blocks)} blocks of one "
        f"{CRAM_PER_CONTAINER}-record container, the largest {big} bytes out; edge and corrupt "
        f"streams), tiers {json.dumps(st_k.as_dict())}, max_abs_err 0; plain {p_all:.1f} s")
    states = rans_state_cases(seed)
    outs_k, st_k = kr.rans_lanes(list(states.values()), torch.device("cuda"))
    outs_p, st_p = kr.rans_lanes(list(states.values()), torch.device("cpu"))
    bad = [w for w, a, b in zip(states, outs_k, outs_p) if a != b]
    if bad or st_k.as_dict() != st_p.as_dict():
        raise AssertionError(f"rans kernel differs from plain at extreme states: {bad}, "
                             f"{st_k.as_dict()} vs {st_p.as_dict()}")
    log(f"rans kernel == plain: {len(states)} streams with initial states at "
        f"{[hex(v) for v in RANS_STATE_EXTREMES]} and mixed, "
        f"{sum(o is not None for o in outs_k)} decode, tiers {json.dumps(st_k.as_dict())}")
    h = kr.pack(plans)
    host = rans_host_tensors(h)
    dev = [t.cuda() for t in host]
    k_ms = cuda_ms(lambda: kr.rans_decode_device(*dev, h["out_total"]), iters=5, warmup=1)
    p_ms = host_ms(lambda: kr.rans_decode_plain(*host, h["out_total"]), iters=1)
    n_in = sum(len(p.payload) for p in plans)
    n_out = sum(p.n_out for p in plans)
    row = {
        "name": "rans", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/rans.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/rans_lanes.py:282",
        "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": (n_in + n_out) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "shape": f"one container: {len(plans)} streams, {n_in} -> {n_out} bytes, "
                 f"the largest {big} bytes",
    }
    log(f"  rans: {k_ms:.4f} ms (plain {p_ms:.3f} ms, bound {row['bound_ms']:.4f} ms) at "
        f"{row['shape']}")
    for order in (0, 1):
        pl = max((p for p in plans if p.order == order),
                 key=lambda p: (p.n_out, len(p.payload)))
        h1 = kr.pack([pl])
        dev1 = [t.cuda() for t in rans_host_tensors(h1)]
        ms = cuda_ms(lambda: kr.rans_decode_device(*dev1, h1["out_total"]), iters=5, warmup=1)
        groups = (pl.n_out + 3) // 4
        row[f"order{order}_ms"] = ms
        row[f"order{order}_ns_per_group"] = ms * 1e6 / groups
        log(f"  rans: the container's largest order-{order} stream alone ({len(pl.payload)} -> "
            f"{pl.n_out} bytes, {len(pl.tables)} tables, {groups} groups): {ms:.4f} ms, "
            f"{ms * 1e6 / groups:.1f} ns a group")
    return row


def cram_phase(work: str, n: int, seed: int) -> dict:
    """Sort a synthetic no-ref rANS CRAM of ``n`` records
    (:data:`CRAM_PER_CONTAINER` per container) on the card with the default
    gates, under ``torch.profiler``, and its BAM twin (the same records,
    level 6): the two outputs decompress to the same bytes; every rANS
    block went through the kernel, one launch per container."""
    import torch

    from hadoop_bam_tpu_torch.device_stream import DeviceStream
    from hadoop_bam_tpu_torch.spec import cram

    t0 = time.perf_counter()
    rows = synth_rows(n, seed + 1)
    bam_path = os.path.join(work, "twin.bam")
    synth_bam(bam_path, n, seed + 1, rows=rows)
    t_rows = time.perf_counter() - t0
    cram_path = os.path.join(work, "twin.cram")
    t0 = time.perf_counter()
    n_cont = synth_cram(cram_path, rows)
    t_cram = time.perf_counter() - t0
    log(f"synthetic CRAM corpus: {n} records of 150 bp over GRCh38 (about 10% unmapped, NM:C); "
        f"BAM twin {os.path.getsize(bam_path)} bytes at level 6 ({t_rows:.1f} s), no-ref rANS "
        f"CRAM {os.path.getsize(cram_path)} bytes in {n_cont} containers of "
        f"{CRAM_PER_CONTAINER} records ({t_cram:.1f} s on {min(n_cont, os.cpu_count() or 1)} "
        f"processes, os.cpu_count() {os.cpu_count()})")
    log("  the size is a targeted-panel sample, not a 30x genome: the host's per-record "
        "decode after the codecs and the Python rANS encoder set it")
    with open(cram_path, "rb") as f:
        data = f.read()
    chs = cram.iter_containers(data)
    got = cram.decode_container(data, chs[1], 3, stream=DeviceStream(torch.device("cuda")))
    if b"".join(r.encode() for r in got) != rows[:CRAM_PER_CONTAINER].tobytes():
        raise AssertionError("the first CRAM container does not decode to its rows")
    log(f"container 1 decodes to its {len(got)} rows byte for byte")
    n_blocks = len(rans_blocks(data, chs[1].offset))
    out_c = os.path.join(work, "sorted.cram.bam")
    out_b = os.path.join(work, "sorted.twin.bam")
    st, wall, launches = timed_sort(cram_path, out_c, "cuda, .cram, default gates", trace=True,
                                    device="cuda")
    c = st.counters
    if launches["rans"] != n_cont or st.n_records != n or st.backend != "single-device":
        raise AssertionError(f"CRAM sort: {launches['rans']} rans launches for {n_cont} "
                             f"containers, {st.n_records} records, backend {st.backend}")
    if c.get("cram.rans.lanes_slices", 0) != n_blocks or c.get("cram.rans.host_slices", 0):
        raise AssertionError(f"CRAM sort: {n_blocks} rANS blocks in the file, counters {c}")
    timed_sort(bam_path, out_b, "cuda, BAM twin, default gates", device="cuda")
    if bgzf_content(out_c) != bgzf_content(out_b):
        raise AssertionError("the CRAM sort decompresses to other bytes than its BAM twin's")
    log(f"sort_bam(.cram) decompresses to sort_bam(BAM twin)'s bytes; {n_blocks} rANS blocks "
        f"all on the kernel in {n_cont} launches")
    os.remove(bam_path)
    return {"launches": launches, "wall": wall, "cram": cram_path, "twin_sorted": out_b}


# ---------------------------------------------------------------------------
# The region path
# ---------------------------------------------------------------------------

#: A 1 Mbp window on chr20, the whole of chr21 and a window past chr1's end
#: (no record reaches it).
REGIONS = ("chr20:10,000,001-11,000,000", "chr21", "chr1:249,000,001-250,000,000")
#: The two intervals of the bounded-traversal sort.
SORT_INTERVALS = "chr20:10000001-11000000,chr21:20000001-25000000"
REC = 280  # bytes of every synthetic record, size word included


def _overlap_case(n: int, k: int, rng):
    """Row 6 inputs: records over the 25 contigs with refid -2/-1 rows, a
    negative start and an end wrapped past 2**31 - 1; K intervals."""
    refid = rng.integers(-2, 25, n).astype(np.int32)
    start = rng.integers(-10, 250_000_000, n).astype(np.int32)
    end = (start.astype(np.int64) + rng.integers(1, 500, n)).astype(np.int32)
    if n >= 3:
        start[:3], end[:3], refid[:3] = [2**31 - 1, -5, 0], [-(2**31), 3, 1], [0, -2, -1]
    iv = np.zeros((k, 3), dtype=np.int32)
    iv[:, 0] = rng.integers(-1, 25, k)
    iv[:, 1] = rng.integers(0, 240_000_000, k)
    iv[:, 2] = iv[:, 1] + rng.integers(0, 5_000_000, k)
    if k:
        iv[0] = [0, 2**31 - 2, 2**31 - 1]
    return iv, refid, start, end


def check_region(seed: int) -> dict:
    """Rows 6, 8 and 9 against their plain versions, exactly: the overlap
    cut's mask form and its view cut (count and rows, at three block sizes)
    with K = 0, 1, 5, 8 and 1,500 (past one shared-memory chunk), no record
    and one record, unplaced starts and wrapped ends; the histogram with out-of-range values, no
    valid position, 128, 256 and 12,288 bins; the unpack with W = 0, no
    row, an odd B and int32 input."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import histogram as kh
    from hadoop_bam_tpu_torch.ops.kernels import overlap as kov
    from hadoop_bam_tpu_torch.ops.kernels import unpack as ku

    rng = np.random.default_rng(seed)

    def both(fn, arrays, **kw):
        got = fn(*[torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays], **kw)
        want = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays], **kw)
        torch.cuda.synchronize()
        got = got.cpu()
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{fn.__name__} kernel != plain at {[a.shape for a in arrays]} {kw}")
        return got

    cases = [(0, 1), (1, 1), (1000, 0), (100_000, 1), (100_000, 5), (100_000, 8), (20_000, 1500)]
    hits = sum(int(both(kov.overlap_mask, _overlap_case(n, k, rng)).sum()) for n, k in cases)
    log(f"overlap_mask kernel == plain: {len(cases)} cases (N up to 100000, K 0-1500), "
        f"{hits} hits, max_abs_err 0")
    hits = 0
    for n, k in cases + [(5000, 2), (33, 1)]:
        iv, refid, start, end = _overlap_case(n, k, rng)
        ln = (end.astype(np.int64) - start).astype(np.int32)  # the wrap rows' lengths wrap too
        if n >= 6:  # unplaced starts on a matching refid, a length that wraps past 2**31 - 1
            refid[3:6], start[3:6], ln[3:6] = 0, [-1, -5, 2**31 - 20], [50, 5, 40]
        arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in (iv, refid, start, ln)]
        want = kov.overlap_rows_plain(*arrays)
        c = int(want[0])
        for threads in (None, kov.THREADS, 32, 1024):
            if threads is None:  # the wrapper, at its own geometry
                got = kov.overlap_rows(*[a.cuda() for a in arrays])
            else:  # the launch into a buffer of garbage
                got = torch.full((n + 1,), -7, dtype=torch.int32, device="cuda")
                kov._launch(*[a.cuda() for a in arrays], got, threads)
            torch.cuda.synchronize()
            got = got.cpu()
            if got.shape != want.shape or not torch.equal(got[: 1 + c], want[: 1 + c]):
                raise AssertionError(f"overlap_rows kernel != plain at N {n}, K {k}, {threads} "
                                     f"threads: count {int(got[0])} vs {c}")
        hits += c
    log(f"overlap_rows kernel == plain: {len(cases) + 2} cases (N up to 100000, K 0-1500, "
        f"unplaced starts, wrapped ends) through the wrapper and at 256, 32 and 1024 threads a "
        f"block, {hits} rows, max_abs_err 0")
    hcases = [(1, 1, 128, 1.0), (1000, 150, 128, 0.9), (777, 33, 256, 0.5), (300, 20, 12288, 0.7),
              (50, 7, 128, 0.0)]
    for b, length, nbins, p in hcases:
        vals = rng.integers(-5, nbins + 30, (b, length)).astype(np.int32)
        vals[:, : min(3, length)] = rng.integers(2, 42, (b, min(3, length)))
        valid = (rng.random((b, length)) < p).astype(np.int32)
        both(kh.quality_histogram, (vals, valid), nbins=nbins)
    log(f"quality_histogram kernel == plain: {len(hcases)} cases (out-of-range values, no valid "
        "position, 128-12288 bins), max_abs_err 0")
    ucases = [(1, 0, np.uint8), (0, 4, np.uint8), (1001, 75, np.uint8), (5, 7, np.int32)]
    for b, w, dt in ucases:
        packed = rng.integers(0, 256, (b, w)).astype(dt)
        if dt == np.int32 and packed.size:
            packed[0, 0] = -1
        both(ku.unpack_nibbles, (packed,))
    log(f"unpack_nibbles kernel == plain: {len(ucases)} cases (W = 0, B = 0, odd B, int32), "
        "max_abs_err 0")
    return {"overlap": 0.0, "histogram": 0.0, "unpack": 0.0}


def flagstat_oracle(rows: np.ndarray) -> dict:
    """The flagstat counts of the generator's records, from their flags."""
    from hadoop_bam_tpu_torch.serve.endpoints import FLAGSTAT_KEYS
    from hadoop_bam_tpu_torch.spec import bam

    flag = rows[:, 18].astype(np.int64) | (rows[:, 19].astype(np.int64) << 8)
    mapped = (flag & bam.FLAG_UNMAPPED) == 0
    paired = (flag & bam.FLAG_PAIRED) != 0
    mate_mapped = (flag & bam.FLAG_MATE_UNMAPPED) == 0
    bit = lambda b: (flag & b) != 0  # noqa: E731
    vals = [len(flag), bit(bam.FLAG_SECONDARY).sum(), bit(bam.FLAG_SUPPLEMENTARY).sum(),
            bit(bam.FLAG_DUPLICATE).sum(), mapped.sum(), paired.sum(),
            (paired & bit(bam.FLAG_FIRST_OF_PAIR)).sum(), (paired & bit(bam.FLAG_SECOND_OF_PAIR)).sum(),
            (paired & mapped & bit(bam.FLAG_PROPER_PAIR)).sum(), (paired & mapped & mate_mapped).sum(),
            (paired & mapped & ~mate_mapped).sum()]
    return dict(zip(FLAGSTAT_KEYS, (int(v) for v in vals)))


def _i32(rows: np.ndarray, col: int) -> np.ndarray:
    return np.ascontiguousarray(rows[:, col : col + 4]).view("<i4").ravel().astype(np.int64)


def file_records(path: str):
    """A BAM of synthetic records in file order: uint8 ``[n, 280]`` rows and
    each record's start virtual offset (member start << 16 | offset in its
    payload)."""
    from hadoop_bam_tpu_torch.io.bam import read_header_voffset
    from hadoop_bam_tpu_torch.spec import bgzf

    with open(path, "rb") as f:
        raw = f.read()
    co, cs, us = bgzf.scan_blocks(raw)
    out, uoffs = bgzf.inflate_blocks(raw, co, cs, us)
    _, v0 = read_header_voffset(path)
    p0 = int(uoffs[int(np.searchsorted(co, v0 >> 16))]) + (v0 & 0xFFFF)
    recs = out[p0:].reshape(-1, REC)
    if not np.all(_i32(recs, 0) == REC - 4):
        raise AssertionError(f"{path}: a record is not {REC} bytes")
    offs = p0 + REC * np.arange(len(recs), dtype=np.int64)
    bi = np.searchsorted(uoffs[:-1], offs, side="right") - 1
    return recs, (co.astype(np.int64)[bi] << 16) | (offs - uoffs[bi])


def overlap_oracle(recs: np.ndarray, region: str):
    """``(rid, beg0, end0, mask)``: the records that overlap ``region``
    (placed, span ``[pos, pos + max(ref_len, 1))``), in NumPy."""
    from hadoop_bam_tpu_torch.utils.intervals import MAX_END, parse_interval

    iv = parse_interval(region)
    rid = [c for c, _ in GRCH38].index(iv.contig)
    beg0, end0 = iv.start - 1, min(iv.end, MAX_END)
    refid, pos = _i32(recs, 4), _i32(recs, 8)
    n_cig = recs[:, 16].astype(np.int64) | (recs[:, 17].astype(np.int64) << 8)
    span = np.where(n_cig > 0, _i32(recs, 47) >> 4, 0)  # one M op, or none
    mask = (refid == rid) & (pos >= 0) & (pos < end0) & (pos + np.maximum(span, 1) > beg0)
    return rid, beg0, end0, mask


def in_chunks(vstart: np.ndarray, chunks) -> np.ndarray:
    """Records whose start voffset lies in one of the (sorted, disjoint)
    chunk spans of a ``.bai`` query."""
    if not chunks:
        return np.zeros(len(vstart), dtype=bool)
    begs = np.asarray([c.beg for c in chunks], dtype=np.int64)
    ends = np.asarray([c.end for c in chunks], dtype=np.int64)
    k = np.searchsorted(begs, vstart, side="right") - 1
    return (k >= 0) & (vstart < ends[np.maximum(k, 0)])


def check_view(blob: bytes, header: bytes, recs, vstart, bai, region: str) -> int:
    """The view holds exactly, in file order, the records that overlap the
    region and start inside the ``.bai``'s chunk spans of it.  Overlapping
    records outside every span must be unmapped: the sort keys unmapped
    reads with a sign-extended hash, so half of them sit at the file's head,
    before the linear index's offset of their window.  Returns their count."""
    rid, beg0, end0, ov = overlap_oracle(recs, region)
    inc = in_chunks(vstart, bai.query(rid, beg0, end0))
    if bgzf_bytes(blob) != header + recs[ov & inc].tobytes():
        raise AssertionError(f"view {region}: the blob is not the oracle's records")
    out = ov & ~inc
    if np.any((recs[out, 18] & 4) == 0):
        raise AssertionError(f"view {region}: a mapped overlapping record lies outside the chunks")
    return int(out.sum())


def blob_records(blob: bytes) -> np.ndarray:
    """A view blob's records as sorted ``V280``."""
    content = bgzf_bytes(blob)
    head = len(read_header_of_blob(content))
    if (len(content) - head) % REC:
        raise AssertionError("view blob: a record is not 280 bytes")
    return np.sort(np.frombuffer(content[head:], dtype=f"V{REC}"))


def timed_region(fn, what: str, device: str, trace: str = "", conf=None):
    """One region call ``fn(stream, timings)`` with the launch counts zeroed
    just before and read just after; with a ``trace`` path, under
    ``torch.profiler`` (device activity only).  Returns ``(result, wall,
    launches, counters)``."""
    import contextlib

    import torch

    from hadoop_bam_tpu_torch.device_stream import DeviceStream

    stream = DeviceStream(torch.device(device), conf=conf)
    on_card = device == "cuda"
    reset_counts()
    if on_card:
        torch.cuda.synchronize()
    ctx = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
           if trace else contextlib.nullcontext())
    timings: dict = {}
    with ctx as prof:
        t0 = time.perf_counter()
        out = fn(stream, timings)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    c = stream.metrics.counters()
    log(f"{what}: wall {wall:.3f} s")
    log("  phases (s): " + json.dumps({k: round(v, 4) for k, v in timings.items()}))
    log(f"  launches: {json.dumps(launches)}")
    log("  counters: " + json.dumps({k: v for k, v in sorted(c.items()) if v and k.startswith(
        ("serve.", "pileup.", "flate.", "device_stream.", "bam.", "cram."))}))
    log("  transfers: " + json.dumps({k: v for k, v in c.items() if k.startswith("transfers.")}))
    if trace:
        log_device_time(prof, trace, wall)
    return out, wall, launch_counts(), c


def kernel_device_ms(trace_path: str, name: str):
    """``(launches, ms)`` of the kernels whose name starts with ``name`` in
    a ``torch.profiler`` chrome trace."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    n, us = 0, 0.0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel" and e["name"].replace(
                "(anonymous namespace)::", "").startswith(name):
            n += 1
            us += float(e.get("dur", 0.0))
    return n, us / 1e3


CHR21 = [[20, 0, 46709983]]  # the chr21 view's interval (refid, beg, end)
CUT_KERNELS = ("cut_count_kernel", "cut_scan_kernel", "cut_scatter_kernel")


def wrapped_end(pos: np.ndarray, ref_len: np.ndarray) -> np.ndarray:
    """The view's record end: ``pos + max(ref_len, 1)`` wrapping in int32."""
    return ((pos.astype(np.int64) + np.maximum(ref_len, 1) + 2**31) % 2**32 - 2**31).astype(
        np.int32)


def overlap_device_time(path: str, view_cols) -> dict:
    """Row 6 in the chr21 view: the one cut's device time (its three
    launches, from ``torch.profiler`` over a whole ``view_blob``), the
    wrapper's host time a call (``overlap_rows`` on the view's records,
    enqueued 200 times without a sync), the view's whole cut
    (``serve.endpoints._cut_view``: packing, upload, cut, read-back, the
    split per batch; host clock) and, as a yardstick, the mask form and
    ``torch.nonzero`` on the same columns (CUDA events)."""
    import torch

    from hadoop_bam_tpu_torch.device_stream import DeviceStream
    from hadoop_bam_tpu_torch.ops.kernels import overlap as kov
    from hadoop_bam_tpu_torch.serve.endpoints import _cut_view, view_blob, view_records

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        view_blob(path, REGIONS[1], device="cuda")
        torch.cuda.synchronize()
    trace = path + ".row6.trace.json"
    prof.export_chrome_trace(trace)
    per_kernel = {name: kernel_device_ms(trace, name) for name in CUT_KERNELS}
    os.remove(trace)
    if any(n != 1 for n, _ in per_kernel.values()):
        raise AssertionError(f"the traced chr21 view's cut: {per_kernel}")
    device = sum(ms for _, ms in per_kernel.values())
    iv = torch.tensor(CHR21, dtype=torch.int32, device="cuda")
    cols = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in view_cols]
    for _ in range(3):
        kov.overlap_rows(iv, *cols)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kov.overlap_rows(iv, *cols)
    host = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    end = torch.from_numpy(wrapped_end(view_cols[1], view_cols[2])).cuda()
    yard = cuda_ms(lambda: torch.nonzero(kov.overlap_mask(iv, cols[0], cols[1], end)), iters=50)
    batches = [bt for bt, _ in view_records(path, REGIONS[1], device="cpu")[1]]
    stream = DeviceStream(torch.device("cuda"))
    _cut_view(batches, *CHR21[0], stream)
    t0 = time.perf_counter()
    for _ in range(20):
        _cut_view(batches, *CHR21[0], stream)
    cut_view = (time.perf_counter() - t0) * 1e3 / 20
    out = {"device_ms_per_view": device,
           **{f"device_ms_{k.split('_')[1]}": ms for k, (_, ms) in per_kernel.items()},
           "host_ms_per_call": host, "cut_view_ms": cut_view, "batches": len(batches),
           "mask_nonzero_ms": yard}
    log(f"  overlap_rows in the chr21 view: one cut, device {device:.5f} ms (count "
        f"{per_kernel[CUT_KERNELS[0]][1]:.5f}, scan {per_kernel[CUT_KERNELS[1]][1]:.5f}, scatter "
        f"{per_kernel[CUT_KERNELS[2]][1]:.5f}; torch.profiler), wrapper host {host:.5f} ms a call "
        f"at {len(view_cols[0])} records; the view's whole cut of {len(batches)} batches "
        f"(_cut_view, host clock) {cut_view:.4f} ms; yardstick overlap_mask + torch.nonzero "
        f"{yard:.4f} ms (CUDA events)")
    return out


def time_region_kernels(path: str, view_cols, checks: dict, launches: int,
                        mask_launches: int) -> list:
    """Rows 6, 8 and 9 at the region path's shapes: row 6's view cut over the
    chr21 view's records (K = 1) and over the sorted file's first 32 MiB
    split (K = 1 and 8), its mask form at the same shapes; rows 8 and 9 over
    that split's quality and packed sequence columns.  Beside each: the
    plain version (host), the bound and, for row 8, ``torch.bincount`` of
    the masked in-range values."""
    import torch

    from hadoop_bam_tpu_torch.io.bam import BamInputFormat
    from hadoop_bam_tpu_torch.ops import cigar
    from hadoop_bam_tpu_torch.ops.kernels import histogram as kh
    from hadoop_bam_tpu_torch.ops.kernels import overlap as kov
    from hadoop_bam_tpu_torch.ops.kernels import unpack as ku

    fmt = BamInputFormat()
    b = fmt.read_split(fmt.get_splits([path], split_size=32 << 20)[0], with_keys=False)
    soa, n = b.soa, b.n_records
    refid = soa["refid"].astype(np.int32)
    pos = soa["pos"].astype(np.int32)
    ln = cigar.reference_lengths_np(b.data, soa).astype(np.int32)
    chr21 = np.asarray(CHR21, dtype=np.int32)
    k8 = np.asarray([CHR21[0], [19, 10_000_000, 11_000_000], [0, 0, 1_000_000],
                     [1, 5_000_000, 6_000_000], [5, 0, 170_000_000], [22, 100, 200],
                     [24, 0, 16569], [23, 1_000_000, 2_000_000]], dtype=np.int32)
    t = lambda a, dev: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    times = {}
    for what, (iv, r, p, l) in (("chr21 view, K=1", (chr21, *view_cols)),
                                ("one split, K=1", (chr21, refid, pos, ln)),
                                ("one split, K=8", (k8, refid, pos, ln))):
        nr, k = len(r), len(iv)
        hits = int(kov.overlap_rows_plain(*[t(a, "cpu") for a in (iv, r, p, l)])[0])
        for fn, args in ((kov.overlap_rows, (iv, r, p, l)),
                         (kov.overlap_mask, (iv, r, p, wrapped_end(p, l)))):
            g = [t(a, "cuda") for a in args]
            c = [t(a, "cpu") for a in args]
            out_bytes = 4 * (hits + 1) if fn is kov.overlap_rows else nr
            times[fn.__name__, what] = (cuda_ms(lambda: fn(*g), iters=50),
                                        host_ms(lambda: fn(*c), iters=3),
                                        (12 * nr + 12 * k + out_bytes) / HBM_BYTES_PER_S * 1e3,
                                        nr, hits)
            log(f"  {fn.__name__} at {what} ({nr} records, {hits} hits): "
                f"{times[fn.__name__, what][0]:.4f} ms (plain {times[fn.__name__, what][1]:.3f} "
                f"ms, bound {times[fn.__name__, what][2]:.5f} ms)")
    row6 = overlap_device_time(path, view_cols)
    k_ms, p_ms, bound, nv, hits = times["overlap_rows", "chr21 view, K=1"]
    rows = [{
        "name": "overlap_rows", "route": "cuda", "source": "hadoop_bam_tpu_torch/csrc/region.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/overlap.py:46", "launches": launches,
        "launches_from": f"view_blob(cuda), {REGIONS[0]}", "max_abs_err": checks["overlap"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
        "shape": f"the chr21 view's {nv} records, K = 1, {hits} rows",
        "ms_split_k1": times["overlap_rows", "one split, K=1"][0],
        "ms_split_k8": times["overlap_rows", "one split, K=8"][0], "split_records": n, **row6,
    }]
    k_ms, p_ms, bound, nv, _ = times["overlap_mask", "chr21 view, K=1"]
    rows.append({
        "name": "overlap_mask", "route": "cuda", "source": "hadoop_bam_tpu_torch/csrc/region.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/overlap.py:46", "launches": mask_launches,
        "launches_from": "the region phase's card calls (views, depth, the CRAM view): no path "
                         "calls it, the views cut with overlap_rows",
        "max_abs_err": checks["overlap"], "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None,
        "shape": f"the chr21 view's {nv} records, K = 1 (the mask form)",
        "ms_split_k1": times["overlap_mask", "one split, K=1"][0],
        "ms_split_k8": times["overlap_mask", "one split, K=8"][0],
    })
    # The split's quality and packed-sequence columns (every record 150 bp).
    l_seq = soa["l_seq"].astype(np.int64)
    if not np.all(l_seq == 150):
        raise AssertionError("the synthetic split holds a record that is not 150 bp")
    seq_off = soa["rec_off"].astype(np.int64) + 32 + soa["l_read_name"] + 4 * soa["n_cigar_op"]
    seq = b.data[seq_off[:, None] + np.arange(75)]
    qual = b.data[seq_off[:, None] + 75 + np.arange(150)].astype(np.int32)
    valid = np.ones_like(qual)
    gv, gm = t(qual, "cuda"), t(valid, "cuda")
    cv, cm = t(qual, "cpu"), t(valid, "cpu")
    k_ms = cuda_ms(lambda: kh.quality_histogram(gv, gm), iters=20)
    p_ms = host_ms(lambda: kh.quality_histogram(cv, cm), iters=1)
    lib_ms = cuda_ms(lambda: torch.bincount(gv[(gm != 0) & (gv >= 0) & (gv < 128)], minlength=128),
                     iters=20)
    rows.append({
        "name": "quality_histogram", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/region.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/histogram.py:71", "launches": 0,
        "launches_from": "no path calls it (an export, as in the reference)",
        "max_abs_err": checks["histogram"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": (8 * qual.size + 4 * 128) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": lib_ms, "shape": f"one split's quality column: {n} x 150, 128 bins",
    })
    gs, cs = t(seq, "cuda"), t(seq, "cpu")
    k_ms = cuda_ms(lambda: ku.unpack_nibbles(gs), iters=20)
    p_ms = host_ms(lambda: ku.unpack_nibbles(cs), iters=3)
    rows.append({
        "name": "unpack_nibbles", "route": "cuda", "source": "hadoop_bam_tpu_torch/csrc/region.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/unpack.py:38", "launches": 0,
        "launches_from": "no path calls it (an export, as in the reference)",
        "max_abs_err": checks["unpack"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": (seq.size + 8 * seq.size) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shape": f"one split's packed sequence: {n} x 75 bytes",
    })
    for r in rows[2:]:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms, library {r['library_ms']}) at {r['shape']}")
    return rows


def region_phase(work: str, census: dict, path: str, cram_path: str, twin_sorted: str,
                 checks: dict) -> list:
    """The region reads on the main path's sorted BAM (``census``: its
    generator's flagstat counts): build its ``.bai``; ``flagstat`` on the
    card (equal to the census); ``view_blob`` of :data:`REGIONS` on the card
    (the first traced, and that one on the CPU too, byte-identical), each
    exactly the records a NumPy overlap oracle over the sorted file keeps,
    row 6 launched; ``depth_stat`` per base on the chr20 window (card
    against CPU) and binned on chr21 (the card); a bounded-traversal
    ``sort_bam`` of :data:`SORT_INTERVALS`, card against CPU byte for byte;
    ``view_blob`` of chr21 of the CRAM phase's file (every record that
    overlaps) against its BAM twin's.  Returns the kernel rows 6, 8 and 9."""
    from hadoop_bam_tpu_torch.conf import (BAM_BOUNDED_TRAVERSAL, BAM_INTERVALS, DEFLATE_LANES,
                                            INFLATE_LANES, WRITE_DEVICE, Configuration)
    from hadoop_bam_tpu_torch.io.bam import read_header
    from hadoop_bam_tpu_torch.ops import cigar
    from hadoop_bam_tpu_torch.serve.endpoints import depth_stat, flagstat, view_blob, view_records
    from hadoop_bam_tpu_torch.spec import indices
    from hadoop_bam_tpu_torch.utils.intervals import MAX_END, parse_interval

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    bai = indices.build_bai(path)
    with open(path + ".bai", "wb") as f:
        bai.save(f)
    log(f"build_bai: {census['total']} records, {os.path.getsize(path + '.bai')} bytes of .bai "
        f"in {time.perf_counter() - t0:.3f} s ({bai.n_no_coor} without coordinates)")
    header = read_header(path).encode()
    # The CPU twins of flagstat and of the views past the first are cut
    # (the generator's census and the overlap oracle hold them).
    fs, _, launches, _ = timed_region(
        lambda st, tm: flagstat(path, stream=st, timings=tm), "flagstat(cuda)", "cuda")
    if launches["inflate_members"] <= 0:
        raise AssertionError("flagstat(cuda) never launched the inflate kernel")
    if fs != census:
        raise AssertionError(f"flagstat: cuda {fs} generator {census}")
    log(f"flagstat cuda == the generator's census: {json.dumps(fs)}")
    recs, vstart = file_records(path)
    first = None
    mask_launches = 0  # the mask form's launches in the phase's card calls: no path calls it
    for k, region in enumerate(REGIONS):
        blob, wall, launches, c = timed_region(
            lambda st, tm: view_blob(path, region, stream=st, timings=tm),
            f"view_blob(cuda, {region})", "cuda",
            trace=os.path.join(work, "region.trace.json") if k == 0 else "")
        c_cpu = c
        if k == 0:
            blob_cpu, _, _, c_cpu = timed_region(
                lambda st, tm: view_blob(path, region, stream=st, timings=tm),
                f"view_blob(cpu, {region})", "cpu")
            if blob != blob_cpu:
                raise AssertionError(f"view {region}: card and cpu blobs differ")
        # Row 6 cuts a view once; each of its .bai chunk spans is one batch
        # cut (serve.view.overlap_device, as the reference counts windows).
        # The empty window's query yields no chunk: no batch, no launch.
        iv = parse_interval(region)
        spans = len(bai.query([c for c, _ in GRCH38].index(iv.contig), iv.start - 1,
                              min(iv.end, MAX_END)))
        cuts = (c.get("serve.view.overlap_device", 0), c_cpu.get("serve.view.overlap_device", 0))
        mask_launches += launches["overlap_mask"]
        if launches["overlap_rows"] != (1 if spans else 0) or cuts != (spans, spans) or (
                launches["overlap_mask"] != 0) or (not spans and region != REGIONS[2]):
            raise AssertionError(f"view {region}: {launches['overlap_rows']} row 6 launches, cuts "
                                 f"(cuda, cpu) {cuts} for {spans} chunk spans")
        head = check_view(blob, header, recs, vstart, bai, region)
        log(f"view {region}: {'cuda == cpu' if k == 0 else 'cuda'} ({len(blob)} bytes), "
            f"{c.get('serve.view.records', 0)} "
            f"records == the NumPy overlap oracle's; {head} overlapping unmapped records at the "
            f"file's head lie outside the .bai's chunks; row 6 launched "
            f"{launches['overlap_rows']} time(s) for {spans} chunk spans")
        if first is None:
            first = launches["overlap_rows"]
    del recs, vstart
    for region, kw in ((REGIONS[0], {"per_base": True}), (REGIONS[1], {})):
        res = {}
        # The binned chr21 profile's CPU twin is cut (the salvage phase's).
        for dev in ("cuda", "cpu") if kw else ("cuda",):
            res[dev], _, launches, c = timed_region(
                lambda st, tm: depth_stat(path, region, stream=st, timings=tm, **kw),
                f"depth_stat({dev}, {region}, {kw})", dev)
            if dev == "cuda":
                mask_launches += launches["overlap_mask"]
                if launches["overlap_rows"] != 1 or launches["overlap_mask"] != 0 or not c.get(
                        "pileup.device_chunks"):
                    raise AssertionError(f"depth {region}: row 6 launches {launches}, or the "
                                         "device profile never ran")
        if res["cuda"] != res.get("cpu", res["cuda"]):
            raise AssertionError(f"depth {region}: card and cpu dicts differ")
        log(f"depth {region}: {'cuda == cpu' if kw else 'cuda'}: {res['cuda']['n_records']} "
            f"records, max depth {res['cuda']['max_depth']}, mean {res['cuda']['mean_depth']}, "
            f"covered "
            f"{res['cuda']['covered_bases']} of {res['cuda']['total_bases']}")
    bounded = Configuration({BAM_BOUNDED_TRAVERSAL: "true", BAM_INTERVALS: SORT_INTERVALS,
                             INFLATE_LANES: "true", DEFLATE_LANES: "false", WRITE_DEVICE: "false"})
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(work, f"bounded.{dev}.bam")
        st, _, launches = timed_sort(path, outs[dev], f"{dev}, bounded traversal of "
                                     f"{SORT_INTERVALS}", conf=bounded, device=dev)
        if st.n_records <= 0 or st.counters.get("bam.records_kept") != st.n_records:
            raise AssertionError(f"bounded sort ({dev}): {st.n_records} records, {st.counters}")
    with open(outs["cuda"], "rb") as f:
        a = f.read()
    with open(outs["cpu"], "rb") as f:
        b = f.read()
    if a != b:
        raise AssertionError("bounded-traversal sort: card and cpu outputs differ")
    log(f"bounded-traversal sort: cuda == cpu ({len(a)} bytes, {st.n_records} records)")
    with open(twin_sorted + ".bai", "wb") as f:
        indices.build_bai(twin_sorted).save(f)
    cram_blob, _, launches, c = timed_region(
        lambda st, tm: view_blob(cram_path, REGIONS[1], stream=st, timings=tm),
        f"view_blob(cuda, .cram, {REGIONS[1]})", "cuda")
    mask_launches += launches["overlap_mask"]
    # A CRAM view reads every split and cuts each VIEW_CUT_BYTES of them.
    cram_splits = c.get("serve.view.overlap_device", 0)
    twin_blob, _, _, _ = timed_region(
        lambda st, tm: view_blob(twin_sorted, REGIONS[1], stream=st, timings=tm),
        f"view_blob(cuda, BAM twin, {REGIONS[1]})", "cuda")
    twin_recs, twin_v = file_records(twin_sorted)
    head = check_view(twin_blob, read_header_of_blob(bgzf_bytes(twin_blob)), twin_recs, twin_v,
                      indices.Bai.load(twin_sorted + ".bai"), REGIONS[1])
    ov = overlap_oracle(twin_recs, REGIONS[1])[3]
    want = np.sort(np.ascontiguousarray(twin_recs[ov]).view(f"V{REC}").ravel())
    got = blob_records(cram_blob)
    if not 1 <= launches["overlap_rows"] <= cram_splits or launches["overlap_mask"] != 0 or (
            launches["rans"] <= 0) or not np.array_equal(got, want):
        raise AssertionError(f"CRAM view: {len(got)} records, the oracle {len(want)}, "
                             f"launches {launches}, {cram_splits} splits cut")
    log(f"view of the CRAM ({len(got)} records) == every overlapping record of its BAM twin; "
        f"the twin's view, the same less the {head} unmapped records at its head; row 6 "
        f"launched {launches['overlap_rows']} time(s) for {cram_splits} splits")
    # The same view held to a 16 MiB budget: several cuts, the same bytes.
    from hadoop_bam_tpu_torch.serve import endpoints

    budget, endpoints.VIEW_CUT_BYTES = endpoints.VIEW_CUT_BYTES, 16 << 20
    try:
        small_blob, _, launches, _ = timed_region(
            lambda st, tm: view_blob(cram_path, REGIONS[1], stream=st, timings=tm),
            f"view_blob(cuda, .cram, {REGIONS[1]}, 16 MiB held)", "cuda")
    finally:
        endpoints.VIEW_CUT_BYTES = budget
    mask_launches += launches["overlap_mask"]
    if small_blob != cram_blob or launches["overlap_rows"] < 2 or launches["overlap_mask"] != 0:
        raise AssertionError(f"CRAM view cut each 16 MiB: launches {launches}, the same bytes "
                             f"{small_blob == cram_blob}")
    log(f"view of the CRAM cut each 16 MiB held: the same bytes, row 6 launched "
        f"{launches['overlap_rows']} times")
    # Row 6's inputs in the chr21 view: every record of the windows it read.
    bs = [bt for bt, _ in view_records(path, REGIONS[1], device="cpu")[1]]
    refid = np.concatenate([bt.soa["refid"] for bt in bs]).astype(np.int32)
    pos = np.concatenate([bt.soa["pos"] for bt in bs]).astype(np.int32)
    span = np.concatenate([cigar.reference_lengths_np(bt.data, bt.soa) for bt in bs])
    view_cols = (refid, pos, span.astype(np.int32))
    log(f"region phase: {time.perf_counter() - t_phase:.1f} s before the kernel timings")
    return time_region_kernels(path, view_cols, checks, first, mask_launches)


def read_header_of_blob(content: bytes) -> bytes:
    """The BAM header bytes (magic through the reference dictionary) at the
    start of a decompressed BAM."""
    import struct

    l_text = struct.unpack_from("<i", content, 4)[0]
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", content, p)[0]
    p += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", content, p)[0]
        p += 4 + l_name + 4
    return content[:p]


def bgzf_bytes(blob: bytes) -> bytes:
    from hadoop_bam_tpu_torch.spec import bgzf

    return bgzf.inflate_blocks(blob, *bgzf.scan_blocks(blob))[0].tobytes()


def _pair_prefix(text: bytes, n_pairs: int) -> bytes:
    """The first ``n_pairs`` records of a FASTQ text (4 lines each)."""
    pos = 0
    for _ in range(4 * n_pairs):
        pos = text.index(b"\n", pos) + 1
    return text[:pos]


def _part_like(host, up0, seed):
    """A main-path part's records from the input's first split, in a
    random order (a coordinate sort scatters them so): size-word starts
    and lengths in the window."""
    from hadoop_bam_tpu_torch.spec import bam

    offs_h, _ = bam.record_chain_partial(host, up0, len(host))
    soa = bam.soa_decode(host, offs_h)
    order = np.random.default_rng(seed).permutation(len(offs_h))
    return (soa["rec_off"] - 4)[order], (soa["rec_len"] + 4)[order]


def time_write_kernels(inflated, host, up0, checks: dict, launches: dict,
                       launches_r: dict, seed: int) -> list:
    """The write side's kernels at a main-path part's shapes: the gather of
    one split's records, the deflate and CRC32 of the gathered stream's
    DEV_LZ_PAYLOAD members.  Every member is also held against the plain
    version and decoded through zlib and the inflate kernel."""
    import torch

    from hadoop_bam_tpu_torch.ops import flate
    from hadoop_bam_tpu_torch.ops.kernels import crc32 as kcrc
    from hadoop_bam_tpu_torch.ops.kernels import deflate as kd
    from hadoop_bam_tpu_torch.ops.kernels import gather as kg

    src, ln = _part_like(host, up0, seed)
    host_t = torch.from_numpy(host)
    g, total = kg.gather_stream_device(inflated, src, ln)
    gp, _ = kg.gather_stream_device(host_t, src, ln)
    if not np.array_equal(g.cpu().numpy(), gp.numpy()):
        raise AssertionError("gather kernel differs from plain at the main path's shape")
    rows = []
    n_rec = len(src)
    k_ms = cuda_ms(lambda: kg.gather_stream_device(inflated, src, ln), iters=10)
    cols = kg._columns(src, ln, None, inflated.device)
    out = torch.empty(total, dtype=torch.uint8, device="cuda")
    tf = torch.empty(-(-total // kg.TILE), dtype=torch.int32, device="cuda")
    bare_ms = cuda_ms(lambda: kg._launch(inflated, *cols, kg.FLAG_DUPLICATE, out, tf))
    if not torch.equal(out, g):
        raise AssertionError("gather kernel's bare launch differs from its wrapper's")
    del out, tf, cols
    p_ms = host_ms(lambda: kg.gather_stream_device(host_t, src, ln), iters=1)
    rows.append({
        "name": "gather_stream", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/write.cu + hadoop_bam_tpu_torch/csrc/write_core.cuh",
        "replaces": "hadoop_bam_tpu/ops/pallas/gather_stream.py:93",
        "launches": launches_r["gather_stream"], "launches_from": "sort_bam(cuda), one split",
        "max_abs_err": checks["gather"], "ms": k_ms, "kernel_ms": bare_ms, "plain_ms": p_ms,
        "bound_ms": (2 * total + 12 * n_rec) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shape": f"{n_rec} records, {total} bytes",
        "geometry": f"tile {kg.TILE} bytes, {kg.THREADS} threads",
    })
    lens = flate._block_lens(total, flate.DEV_LZ_PAYLOAD)
    offs = np.arange(len(lens), dtype=np.int64) * flate.DEV_LZ_PAYLOAD
    gh = g.cpu()
    kc, kl, ko = [t.cpu().numpy() for t in kd.deflate_lanes_stream(g, lens, offs=offs)]
    t0 = time.perf_counter()
    pc, pl, po = [t.numpy() for t in kd.deflate_lanes_stream(gh, lens, offs=offs)]
    p_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(kl, pl) and np.array_equal(ko, po) and np.array_equal(kc, pc)):
        raise AssertionError("deflate kernel differs from plain on the gathered part")
    if not ko.all():
        raise AssertionError("deflate declined members of the gathered part")
    ghn = gh.numpy()
    check_deflate_rows([ghn[o : o + n].tobytes() for o, n in zip(offs, lens)], kc, kl, ko,
                       "deflate, gathered part")
    k_ms = cuda_ms(lambda: kd.deflate_lanes_stream(g, lens, offs=offs), iters=3, warmup=1)
    out_b = int(kl.astype(np.int64).sum())
    mx = int(lens.max())
    counts = torch.zeros((len(lens), 3), dtype=torch.int32, device="cuda")
    P = kd.round_up(mx, kd.DEFAULT_CHUNK)
    kd.deflate_members(g, torch.from_numpy(offs).cuda(),
                       torch.from_numpy(lens.astype(np.int32)).cuda(), mx, kd.hash_bits(P),
                       kd.out_bytes(P), counts=counts)
    lit, cpy, win = counts.cpu().numpy().astype(np.int64).sum(axis=0).tolist()
    rows.append({
        "name": "deflate_members", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/deflate.cu + hadoop_bam_tpu_torch/csrc/deflate_core.cuh",
        "replaces": "hadoop_bam_tpu/ops/pallas/deflate_lanes.py:328",
        "launches": launches["deflate_members"], "launches_from": "sort_bam(cuda), default gates",
        "max_abs_err": float(np.count_nonzero(kc != pc)), "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": (total + out_b + 20 * len(lens)) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "shape": f"{len(lens)} members, {total} -> {out_b} bytes",
        "literals": lit, "copies": cpy, "windows": win,
    })
    log(f"deflate kernel == plain on the gathered part: {len(lens)} full-size members, every "
        "row inflates through zlib and the inflate kernel")
    log(f"  row 3 (deflate_members) at the part's shape: {k_ms:.4f} ms, "
        f"{launches['deflate_members']} launches a sort, bound {rows[-1]['bound_ms']:.4f} ms; "
        f"kernel counts: {lit} literals, {cpy} copies, {win} windows "
        f"({win / len(lens):.1f} a member); {sm_clocks()}")
    kcr = kcrc.crc32_device(g, offs, lens).cpu()
    pcr = kcrc.crc32_device(gh, offs, lens)
    want = np.array([zlib.crc32(ghn[o : o + n]) for o, n in zip(offs, lens)], dtype=np.int64)
    got = kcr.view(torch.int32).numpy().view(np.uint32).astype(np.int64)
    if not (torch.equal(kcr.view(torch.int32), pcr.view(torch.int32)) and np.array_equal(got, want)):
        raise AssertionError("crc32 kernel differs from plain / zlib on the gathered part")
    k_ms = cuda_ms(lambda: kcrc.crc32_device(g, offs, lens), iters=10)
    ot, lt = kcrc._columns(offs, lens, g.device)
    cout = torch.empty(len(lens), dtype=torch.int32, device="cuda")
    bare_ms = cuda_ms(lambda: kcrc._launch(g, ot, lt, cout))
    if not torch.equal(cout, kcr.view(torch.int32).cuda()):
        raise AssertionError("crc32 kernel's bare launch differs from its wrapper's")
    p_ms = host_ms(lambda: kcrc.crc32_device(gh, offs, lens), iters=1)
    rows.append({
        "name": "crc32", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/write.cu + hadoop_bam_tpu_torch/csrc/write_core.cuh",
        "replaces": "hadoop_bam_tpu/ops/pallas/crc32.py:131",
        "launches": launches_r["crc32"], "launches_from": "sort_bam(cuda), one split",
        "max_abs_err": checks["crc32"], "ms": k_ms, "kernel_ms": bare_ms, "plain_ms": p_ms,
        "bound_ms": (total + 16 * len(lens)) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shape": f"{len(lens)} members, {total} bytes",
        "geometry": f"{kcrc.THREADS} threads, {kcrc.W} bytes a thread a round",
    })
    for r in rows:
        if "kernel_ms" in r:
            log(f"  {r['name']}: {r['ms']:.4f} ms with its wrapper, {r['kernel_ms']:.4f} ms bare "
                f"(plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms) at {r['shape']}, "
                f"{r['geometry']}")
        else:
            log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.4f} ms) at {r['shape']}")
    copy = torch.empty_like(g)
    copy_ms = cuda_ms(lambda: copy.copy_(g))
    sum_ms = cuda_ms(lambda: torch.sum(g))
    del copy
    log(f"  yardsticks at the part's {total} bytes: device copy_ {copy_ms:.4f} ms, torch.sum "
        f"{sum_ms:.4f} ms")
    return rows


def time_kernels(src: str, checks: dict, launches: dict, launches_r: dict, seed: int) -> list:
    """Each kernel at the main path's shapes (the input's first split and a
    part of its records), beside its plain version and its bound."""
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
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        out = torch.empty(total, dtype=torch.uint8, device=dev)
        return (comp, t(comp_off), t(clens), t(out_off), t(us.astype(np.int32)), out,
                int(clens.max()))

    ga, ca = args("cuda"), args("cpu")
    rows = []
    k_ms = cuda_ms(lambda: kin.inflate_members(*ga), iters=5, warmup=1)
    p_ms = host_ms(lambda: kin.inflate_members_plain(*ca[:6]), iters=1)
    # One full member alone: the shape of a region read's chunk span.
    one = (ga[0], *(t[:1] for t in ga[1:5]), ga[5], int(clens[0]))
    one_ms = cuda_ms(lambda: kin.inflate_members(*one), iters=20, warmup=3)
    inflated = ga[5]
    n_in = int(clens.astype(np.int64).sum())
    log(f"  inflate_members: one member ({int(clens[0])} compressed -> {int(us[0])} bytes) "
        f"{one_ms:.4f} ms a launch")
    rows.append({
        "name": "inflate_members", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/inflate.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/inflate_lanes.py:830",
        "launches": launches["inflate_members"], "max_abs_err": checks["inflate"],
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": (n_in + total) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "one_member_ms": one_ms,
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
    # The sort runs the walk with its fused keys; the walk alone beside it.
    n_b = s1 - s0
    k_ms = cuda_ms(lambda: kch.record_chain_keys(g_stream, n_b, n_rec), iters=20, warmup=3)
    alone_ms = cuda_ms(lambda: kch.record_chain(g_stream, n_b), iters=20, warmup=3)
    p_ms = host_ms(lambda: kch.record_chain_keys(c_stream, n_b, n_rec), iters=1)
    phase_us = {}
    for label, n_rows in (("", n_rec), ("alone_", None)):
        runs = [kch.record_chain_phases(g_stream, n_b, n_rows=n_rows)[2] for _ in range(5)]
        phase_us.update({f"{label}{k}_us": 1e3 * sum(r[f"{k}_ms"] for r in runs) / len(runs)
                         for k in kch.PHASES})
        log(f"  record_chain {'walk alone' if label else 'with keys'} phases (CUDA events, mean "
            "of 5, us): " + ", ".join(f"{k} {phase_us[label + k + '_us']:.1f}" for k in kch.PHASES)
            + f"; {runs[0]['segments']} segments of {kch.SEG} bytes, {runs[0]['hops']} hops")
    rows.append({
        "name": "record_chain", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/chain.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/chain.py:113 and hadoop_bam_tpu/ops/decode.py:88",
        "launches": launches["record_chain"], "max_abs_err": checks["chain"],
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": n_rec * (4 + 8 + 10 + 9) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shape": f"{n_rec} records, {n_b} bytes, with the keys",
        "ms_walk_alone": alone_ms,
        "bound_ms_walk_alone": n_rec * (4 + 8) / HBM_BYTES_PER_S * 1e3,
        **phase_us, "hops": runs[0]["hops"],
    })
    offs, meta = kch.record_chain(g_stream, n_b)
    k_ms = cuda_ms(lambda: kch.stream_keys(g_stream, n_b, offs, meta, n_rec), iters=20)
    p_ms = cuda_ms(lambda: kch.stream_keys_plain(g_stream, n_b, offs, meta, n_rec), iters=5)
    rows.append({
        "name": "stream_keys", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/chain.cu",
        "replaces": "hadoop_bam_tpu/ops/decode.py:88",
        "launches": launches["stream_keys"],
        "launches_from": "the sort's keys ride record_chain's emit; the standalone gather is "
                         "the yardstick",
        "max_abs_err": checks["chain"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": n_rec * (8 + 10 + 8 + 1) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shape": f"{n_rec} records",
    })
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms) at {r['shape']}")
    return rows + time_write_kernels(inflated, host, up0, checks, launches, launches_r, seed)


# ---------------------------------------------------------------------------
# Codec phase: the literal-only round trip, the general inflate programs and
# the serve warm-up (kernel rows 10 and 11)
# ---------------------------------------------------------------------------

CODEC_MIB = 64  # the round trip's input: the sort generator's record bytes
XLA_MIB = 8  # the general programs' inputs
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 peak, the CUDA cores' rate
OPS_PER_SYMBOL = 20  # integer operations to decode one fixed-Huffman symbol (row 10's function)
OPS_PER_WAVE = 80  # row 11's integer operations per lane and wave (the reference's function)
PROBE_CHAIN_STEPS = 1 << 20  # steps of row 11's dependent chain timed alone for its floor


def fixed_literal_cases(seed: int):
    """Row 10's check corpus: 296 literal-only members of 0-24,000 bytes
    plus 0-, 1-, 144- and 24,000-byte ones (``deflate_fixed`` on the card),
    an LZ77 member, a truncated member followed by a valid one, a
    ``btype=10`` header and a 57,088-byte member.  Returns ``(comp [B, C],
    clens, isizes, payloads)``; ``payloads[i]`` is None where the member
    must come back ``ok = False``."""
    import torch

    from hadoop_bam_tpu_torch.ops import flate

    rng = np.random.default_rng(seed + 10)
    src = synth_rows(240, seed).reshape(-1)  # 67,200 record bytes
    sizes = [int(s) for s in rng.integers(0, 24001, 296)] + [0, 1, 144, 24000,
                                                              flate.DEV_MAX_PAYLOAD]
    starts = [int(s) for s in rng.integers(0, len(src) - flate.DEV_MAX_PAYLOAD, len(sizes))]
    payloads = [src[s : s + n].tobytes() for s, n in zip(starts, sizes)]
    P = max(sizes)
    mat = np.zeros((len(sizes), P), dtype=np.uint8)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
    comp, cl = flate._deflate_fixed_rows(torch.from_numpy(mat).cuda(),
                                          torch.tensor(sizes, dtype=torch.int32).cuda())
    cl = cl.cpu().numpy()
    comps = [comp[i, : cl[i]].cpu().numpy().tobytes() for i in range(len(sizes))]
    lz = flate.encode_tokens_fixed([("lit", 65)] * 8 + [("copy", 5, 3)])
    cut_src = src[:900].tobytes()
    cut = flate.encode_tokens_fixed([("lit", b) for b in cut_src])
    comps += [lz, cut[: len(cut) // 2], comps[0], bytes([0b101]) + bytes(7)]
    payloads += [None, None, payloads[0], None]
    isz = sizes + [13, 900, sizes[0], 4]
    C = max(len(c) for c in comps)
    C += -C % 8
    rows = np.zeros((len(comps), C), dtype=np.uint8)
    for i, c in enumerate(comps):
        rows[i, : len(c)] = np.frombuffer(c, np.uint8)
    return rows, np.asarray([len(c) for c in comps], np.int32), np.asarray(isz, np.int32), payloads


def _bits_to(q: int) -> list:
    """Literal bytes whose fixed codes, from bit 3, end exactly at bit q:
    'A' (8 bits) and 200 (9 bits); any q >= 59 is reached."""
    n = q - 3
    for nine in range(n // 9 + 1):
        if (n - 9 * nine) % 8 == 0:
            return [200] * nine + [65] * ((n - 9 * nine) // 8)
    raise ValueError(f"no literal run ends at bit {q}")


def _fixed_batch(members, C: int = 0, fill=None):
    """Rows ``(comp [B, C] uint8, clens, isizes)`` of ``(stream, clen,
    isize)`` members; C defaults to the longest stream rounded up to 16
    bytes; bytes past each stream are zeros, or ``fill``'s."""
    C = C or -(-max([len(s) for s, _, _ in members] + [1]) // 16) * 16
    comp = np.zeros((len(members), C), np.uint8) if fill is None else fill[: len(members), :C].copy()
    for i, (s, _, _) in enumerate(members):
        s = s[:C]
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
    return (comp, np.asarray([c for _, c, _ in members], np.int32),
            np.asarray([z for _, _, z in members], np.int32))


def fixed_literal_trouble_cases(seed: int) -> dict:
    """Row 10's trouble cases, each a batch ``(comp [B, C] uint8, clens,
    isizes)`` for the kernel and its plain version: symbols that end, start
    or straddle segment and round seams (a 9-bit literal ending at each bit
    of a sweep, an EOB and a length code starting there, around the seams of
    256- and 512-bit segments and of 32,768- and 65,536-bit rounds), runs
    whose 9 entries never meet, ISIZE that lies (by one either way on the
    largest and on a smaller member; far below the literals; below 0 beside
    valid members), the ends of the stream (clens cut mid-symbol, garbage
    past clens, clens past C, no EOB before C), small members (ISIZE 0, 1, 15, 16, 17; bad headers), an empty batch, the
    57,088-byte member and random streams."""
    import torch

    from hadoop_bam_tpu_torch.ops import flate

    rng = np.random.default_rng(seed + 15)
    enc = flate.encode_tokens_fixed

    def lits(payloads, isizes=None):
        """``(stream, clen, isize)`` of literal-only members, by
        ``deflate_fixed`` on the CPU."""
        payloads = [bytes(p) for p in payloads]
        mat = np.zeros((len(payloads), max(len(p) for p in payloads) or 1), np.uint8)
        for i, p in enumerate(payloads):
            mat[i, : len(p)] = np.frombuffer(p, np.uint8)
        comp, cl = flate._deflate_fixed_rows(
            torch.from_numpy(mat), torch.tensor([len(p) for p in payloads], dtype=torch.int32))
        comp, cl = comp.numpy(), cl.numpy()
        isizes = [len(p) for p in payloads] if isizes is None else isizes
        return [(comp[i, : cl[i]].tobytes(), int(cl[i]), int(z)) for i, z in enumerate(isizes)]

    def lit(payload, isize=None):
        return lits([payload], None if isize is None else [isize])[0]

    def rand(n, lo=0, hi=256):
        return bytes(rng.integers(lo, hi, n, dtype=np.uint8))

    sweep = list(range(68, 68 + 144)) + [p + d for p in (256, 512, 4096, 32768, 65536)
                                         for d in range(-9, 10)]
    cases = {
        "a 9-bit literal ends at each bit of the sweep": _fixed_batch(
            lits([_bits_to(q - 9) + [255, 66, 201] for q in sweep])),
        "an EOB starts at each bit of the sweep": _fixed_batch(lits([_bits_to(q) for q in sweep])),
        "a length code starts at each bit of the sweep": _fixed_batch(
            [(s, len(s), len(_bits_to(q)) + 4) for q in sweep[:40] + sweep[144::4]
             for s in [enc([("lit", b) for b in _bits_to(q)] + [("copy", 3, 1), ("lit", 7)])]]),
        "runs whose entries never meet": _fixed_batch(
            lits([bytes([37]) * n for n in (1, 31, 32, 33, 255, 256, 257, 4095, 4096, 4097)]
                 + [bytes([37, 122]) * 300 + rand(40)])),
    }
    big, small = rand(3000), rand(100)
    for what, dbig, dsmall in (("largest one below", -1, 0), ("largest one above", 1, 0),
                               ("smaller one below", 0, -1), ("smaller one above", 0, 1)):
        cases[f"ISIZE lies: {what}"] = _fixed_batch(
            [lit(big, isize=len(big) + dbig), lit(small, isize=len(small) + dsmall)])
    cases["ISIZE lies: far below, beside a short member"] = _fixed_batch(
        [lit(rand(2000), isize=40), lit(rand(60)), lit(rand(6000), isize=17)])
    cases["ISIZE lies: far above"] = _fixed_batch([lit(rand(100), isize=5000), lit(rand(40))])
    cases["ISIZE below 0 beside valid members"] = _fixed_batch(
        [lit(rand(5)), (bytes([0x03, 0x00]), 2, -1), lit(rand(40), isize=-1), lit(b"")])
    full = lit(rand(500))
    cases["clens cut mid-symbol, the rest of the stream after it"] = _fixed_batch(
        [(full[0], full[1] - k, full[2]) for k in (1, 2, 3, 60, len(full[0]) - 1)] + [full])
    garbage = rng.integers(0, 256, (8, 2048), dtype=np.uint8)
    cases["garbage bytes past clens"] = _fixed_batch(
        lits([rand(n) for n in (0, 1, 17, 500, 1500)]) + [(full[0], full[1] - 2, full[2])],
        C=2048, fill=garbage)
    edge = lit(_bits_to(8 * 64))[0][:64]  # literals to bit 512, no EOB
    cases["clens past C: the EOB comes from the zeros past C"] = _fixed_batch(
        [(edge, c, len(_bits_to(512))) for c in (64, 65, 70, 1 << 27, -1, 0)], C=64)
    cases["no EOB before C"] = _fixed_batch([(lit(rand(300))[0][:80], 80, 300),
                                             (lit(rand(300))[0][:80], 1000, 300)], C=80)
    smalls = lits([rand(n) for n in (0, 1, 15, 16, 17)])
    bad = []
    for hdr in (0b010, 0b101, 0b111, 0b001, 0b000):
        s = bytearray(lit(rand(20))[0])
        s[0] = (s[0] & ~7) | hdr
        bad.append((bytes(s), len(s), 20))
    cases["small members and bad headers"] = _fixed_batch(smalls + bad)
    cases["an empty batch"] = (np.zeros((0, 16), np.uint8), np.zeros(0, np.int32),
                               np.zeros(0, np.int32))
    cases["the 57,088-byte member and two of 24,000 bytes"] = _fixed_batch(
        lits([rand(flate.DEV_MAX_PAYLOAD), rand(24000, 0, 144), rand(24000, 144, 256)]))
    streams = []
    for n in (16, 64, 300, 1000):
        s = bytearray(rand(n))
        s[0] = (s[0] & ~7) | 3
        streams.append((bytes(s), n, int(rng.integers(0, 8 * n))))
    cases["random streams"] = _fixed_batch(streams)
    return cases


def check_inflate_fixed(seed: int) -> dict:
    """Row 10 against its plain version, exactly, and against the
    payloads."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed as kfix

    comp, clens, isz, payloads = fixed_literal_cases(seed)
    res = []
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        out, ok = kfix.inflate_fixed_literal(t(comp), t(clens), t(isz))
        res.append((out.cpu().numpy(), ok.cpu().numpy()))
    (ko, kk), (po, pk) = res
    want = np.asarray([p is not None for p in payloads])
    if not np.array_equal(kk, pk) or not np.array_equal(kk, want):
        raise AssertionError(f"inflate_fixed_literal ok: kernel {np.nonzero(kk != want)[0]} "
                             f"plain {np.nonzero(pk != want)[0]} differ from the expected")
    bad = int(np.count_nonzero(ko != po))
    if bad or any(p is not None and ko[i, : len(p)].tobytes() != p for i, p in enumerate(payloads)):
        raise AssertionError(f"inflate_fixed_literal kernel != plain or payload ({bad} bytes)")
    log(f"inflate_fixed_literal kernel == plain: {len(isz)} members (0-{int(isz.max())} bytes; "
        f"LZ77, truncated-then-valid, btype=10), {int(kk.sum())} ok, {int((~kk).sum())} rejected, "
        f"max_abs_err {bad}")
    check_fixed_trouble(seed)
    return {"max_abs_err": float(bad)}


#: Row 10's geometries checked on the card, (seg bits, threads): the
#: default, 256-bit segments, tiny ones whose short members cross many
#: segments and rounds, and the largest (shared memory past 48 KB).
FIXED_GEOMETRIES = ((512, 128), (256, 128), (32, 32), (64, 64), (1024, 256))


def check_fixed_trouble(seed: int) -> None:
    """Row 10 on ``fixed_literal_trouble_cases`` against its plain version,
    exactly (ok and every byte of every row), at each of
    ``FIXED_GEOMETRIES``: the default through ``inflate_fixed_literal``,
    the others through ``_launch``."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed as kfix

    t0 = time.perf_counter()
    cases = fixed_literal_trouble_cases(seed)
    members = rejected = 0
    for what, (comp, clens, isz) in cases.items():
        c = [torch.from_numpy(a) for a in (comp, clens, isz)]
        po, pk = (a.numpy() for a in kfix.inflate_fixed_literal(*c))
        g = [a.cuda() for a in c]
        for seg, threads in FIXED_GEOMETRIES:
            if (seg, threads) == (kfix.SEG, kfix.THREADS):
                ko, kk = kfix.inflate_fixed_literal(*g)
            else:
                gc, out, kk, max_out = kfix._prepare(g[0], g[2])
                kfix._launch(gc, g[1], g[2], out, kk, seg, threads)
                ko = out[:, :max_out]
            ko, kk = ko.cpu().numpy(), kk.cpu().numpy()
            if not (np.array_equal(kk, pk) and np.array_equal(ko, po)):
                raise AssertionError(f"inflate_fixed_literal at seg {seg}, {threads} threads != "
                                     f"plain on {what}")
        members += len(isz)
        rejected += int((~pk).sum())
    log(f"inflate_fixed_literal kernel == plain on {len(cases)} trouble cases ({members} members, "
        f"{rejected} rejected) at (seg, threads) {list(FIXED_GEOMETRIES)}, max_abs_err 0 "
        f"({time.perf_counter() - t0:.1f} s)")


def probe_cases(seed: int) -> dict:
    """Row 11's cursor cases over one R = 256 stream: ``{name: (streams
    int32 [R, 128], cursors int32 [1, 128], T)}``.  Lanes all equal, spread
    over the whole stream, negative (some walk into it), at -1, -33, R * 32 -
    1 and R * 32, within 2**10 of INT32_MAX (the cursor wraps), lanes whose
    every wave advances the most, 22 bits (a stream built for them), and T =
    0, 1 and odd Ts that are not a multiple of the kernel's 8-wave blocks."""
    rng = np.random.default_rng(seed + 11)
    R, lanes, imax = 256, 128, 2**31 - 1
    end = R * 32
    streams = rng.integers(-(1 << 31), 1 << 31, (R, lanes), dtype=np.int32)
    spread = rng.integers(-4096, end + 4096, (1, lanes), dtype=np.int32)
    edges = spread.copy()
    edges[0, :4] = [-1, -33, end - 1, end]
    # From each lane's start, every 22 bits: low bits 111, bits 7-13 clear
    # and bit 14 set (the length class 15): each wave advances 15 + 7.
    starts = rng.integers(0, 64, lanes)
    bits = rng.integers(0, 2, (lanes, end), dtype=np.uint8)
    for lane, s0 in enumerate(starts):
        at = np.arange(s0, end - 15, 22)
        for k, b in [(0, 1), (1, 1), (2, 1), *((k, 0) for k in range(7, 14)), (14, 1)]:
            bits[lane, at + k] = b
    fast = np.packbits(bits.reshape(lanes, R, 32), axis=-1, bitorder="little")
    fast = fast.view("<u4")[..., 0].T.astype(np.uint32).view(np.int32).copy()
    return {
        "all lanes equal": (streams, np.full((1, lanes), 1000, np.int32), 97),
        "lanes over the whole stream": (streams, rng.integers(0, end, (1, lanes), dtype=np.int32),
                                        301),
        "negative cursors": (streams, rng.integers(-1500, 0, (1, lanes), dtype=np.int32), 301),
        "-1, -33, R * 32 - 1, R * 32": (streams, edges, 64),
        "every wave advancing 22 bits": (fast, starts.astype(np.int32)[None, :], 301),
        "within 2**10 of INT32_MAX": (
            streams, (imax - rng.integers(0, 1 << 10, (1, lanes))).astype(np.int32), 97),
        "T = 0": (streams, spread, 0),
        "T = 1": (streams, spread, 1),
        "T = 13": (streams, spread, 13),
    }


def check_inflate_probe(seed: int) -> dict:
    """Row 11 against its plain version and the NumPy oracle, exactly:
    ``probe_cases`` and R = 4096, T = 2048."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import inflate_probe as kip

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 11)
    big = rng.integers(-(1 << 31), 1 << 31, (4096, kip.LANES), dtype=np.int32)
    cases = dict(probe_cases(seed), **{"R = 4096, T = 2048": (
        big, rng.integers(0, 4096 * 32, (1, kip.LANES), dtype=np.int32), 2048)})
    u32 = lambda a: a.astype(np.int64) & 0xFFFFFFFF  # noqa: E731
    for name, (streams, cursors, T) in cases.items():
        R = streams.shape[0]
        c_ref, a_ref = kip.reference_walk(streams, cursors, T)
        p_cur, p_acc = kip.make_walk(R, T, "cpu")(torch.from_numpy(streams),
                                                  torch.from_numpy(cursors))
        if not (np.array_equal(u32(p_cur.numpy()), c_ref & 0xFFFFFFFF)
                and np.array_equal(u32(p_acc.numpy()), a_ref)):
            raise AssertionError(f"inflate_probe walk_plain != reference_walk: {name}")
        gs, gc = torch.from_numpy(streams).cuda(), torch.from_numpy(cursors).cuda()
        cur, acc = kip.make_walk(R, T, "cuda")(gs, gc)
        if not (torch.equal(cur.cpu(), p_cur) and torch.equal(acc.cpu(), p_acc)):
            raise AssertionError(f"inflate_probe_walk != walk_plain: {name}")
    log(f"inflate_probe_walk kernel == plain == reference_walk, cases {sorted(cases)}, "
        f"max_abs_err 0 ({time.perf_counter() - t0:.1f} s)")
    return {"max_abs_err": 0.0}


def fixed_phase_shares(args) -> dict:
    """Row 10's phases' shares of its blocks' clock cycles (thread 0's
    stamps summed over blocks) in one launch of ``kfix._launch(*args)``."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed as kfix

    cyc = torch.zeros(len(kfix.PHASES), dtype=torch.int64, device="cuda")
    kfix._launch(*args, cycles=cyc)
    cyc = cyc.cpu().numpy().astype(np.float64)
    return {k: round(float(v / cyc.sum()), 4) for k, v in zip(kfix.PHASES, cyc)}


def timed_codec(fn, what: str, trace: str = ""):
    """One codec call with the launch counts zeroed just before and read
    just after, the peak device memory reset before it; with a ``trace``
    path, under ``torch.profiler``.  Returns ``(result, wall, launches,
    traced)``, ``traced`` False when the trace held no device event."""
    import contextlib

    import torch

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
           if trace else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    log(f"{what}: wall {wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches {json.dumps(launches)}")
    traced = log_device_time(prof, trace, wall) if trace else False
    return out, wall, launches, traced


def traced_again(fn, trace: str, tries: int = 3) -> None:
    """Trace ``fn`` under ``torch.profiler`` (host and device activity)
    until the trace holds device events, at most ``tries`` times: a short
    traced window has come back without them."""
    import torch

    for k in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log(f"  traced again (try {k + 1}):")
        if log_device_time(prof, trace, wall):
            return


def codec_rows(blob: bytes):
    """The members of a BGZF blob as ``bgzf_decompress_device`` hands
    them to row 10: ``(comps, comp [B, C] uint8 with C a power of two,
    clens, isizes)``."""
    from hadoop_bam_tpu_torch.spec import bgzf

    raw = np.frombuffer(blob, np.uint8)
    co, cs, us = bgzf.scan_blocks(raw)
    keep = np.nonzero(us > 0)[0]
    comps = [raw[co[i] + 18 : co[i] + cs[i] - 8].tobytes() for i in keep]
    clens = np.asarray([len(c) for c in comps], np.int32)
    C = 512
    while C < clens.max():
        C *= 2
    comp = np.zeros((len(comps), C), np.uint8)
    for k, c in enumerate(comps):
        comp[k, : len(c)] = np.frombuffer(c, np.uint8)
    return comps, comp, clens, us[keep].astype(np.int32)


def once_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def codec_phase(work: str, seed: int, checks: dict, mib: int):
    """The device codec's literal-only round trip at full width: ``mib`` MiB
    of the sort generator's record bytes compressed by
    ``bgzf_compress_device(level=1, use_lanes=False)`` on the card (gzip
    reads it back; its first 4 MiB equal the CPU run's blob) and
    decompressed by ``bgzf_decompress_device`` with the inflate gate off
    (every member through row 10, traced) and with the default gates (row
    1); the general programs on the card with the gate off (zlib-6 members
    through ``inflate_dynamic``, deflate-lanes members rejected by row 10
    and decoded by ``inflate_fixed``); the salvage phase's forced member
    tier-downs on the card (``flate.inflate.tierdown:members=0-7,n=8``,
    8 MiB of zlib-6 members through row 1 and of literal-only members
    through row 10, each the clean decode's bytes); ``warm_kernels`` twice;
    row 10 and row 1 timed on the round trip's members, row 11 by
    ``bench_marginal``.  Returns the kernel rows 10 and 11, and the launches
    of the forced decodes by the name of the row each drives."""
    import gzip
    import io

    import torch

    from hadoop_bam_tpu_torch.conf import INFLATE_LANES, Configuration
    from hadoop_bam_tpu_torch.ops import flate
    from hadoop_bam_tpu_torch.ops.kernels import inflate as kin
    from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed as kfix
    from hadoop_bam_tpu_torch.serve import warm_kernels
    from hadoop_bam_tpu_torch.spec import bgzf
    from hadoop_bam_tpu_torch.utils.tracing import Metrics

    t_phase = time.perf_counter()
    n = mib << 20
    data = synth_rows(-(-n // ROW), seed + 2).reshape(-1)[:n].tobytes()
    off = Configuration({INFLATE_LANES: "false"})

    st = flate.CodecTierStats()
    blob, wall, _, _ = timed_codec(lambda: flate.bgzf_compress_device(
        data, level=1, use_lanes=False, device="cuda", stats=st), f"bgzf_compress_device(cuda, "
        f"level=1, use_lanes=False): {n} bytes")
    members = -(-n // flate.DEV_DEFAULT_PAYLOAD)
    log(f"  {len(blob)} bytes, {members} members, stats {json.dumps(st.as_dict())}, "
        f"{n / wall / 1e6:.1f} MB/s")
    if st.xla != members or gzip.GzipFile(fileobj=io.BytesIO(blob)).read() != data:
        raise AssertionError("the literal-only blob does not gzip-decompress to its input")
    head = data[: 4 << 20]
    if (flate.bgzf_compress_device(head, level=1, use_lanes=False, device="cpu")
            != flate.bgzf_compress_device(head, level=1, use_lanes=False, device="cuda")):
        raise AssertionError("the literal-only blob of the first 4 MiB differs from the CPU run's")
    log("  gzip reads it back; its first 4 MiB equal the CPU run's blob")

    for what, conf, tier in (("inflate gate off: row 10", off, kfix.LAUNCHES.name),
                             ("default gates: row 1", None, kin.LAUNCHES.name)):
        st, m = flate.CodecTierStats(), Metrics()
        out, wall, launches, traced = timed_codec(
            lambda: flate.bgzf_decompress_device(blob, conf=conf, device="cuda", stats=st,
                                                 metrics=m),
            f"bgzf_decompress_device(cuda, {what})",
            trace=os.path.join(work, "codec.trace.json") if conf is off else "")
        log(f"  stats {json.dumps(st.as_dict())}, {n / wall / 1e6:.1f} MB/s, transfers "
            + json.dumps({k: v for k, v in m.counters().items() if k.startswith("transfers.")}))
        if out != data or st.lanes != members or st.xla or st.host or launches.get(tier, 0) < 1:
            raise AssertionError(f"bgzf_decompress_device({what}) missed its tier or its bytes")
        if conf is off:
            fixed_launches = launches[tier]
            if not traced:
                traced_again(lambda: flate.bgzf_decompress_device(blob, conf=off, device="cuda"),
                             os.path.join(work, "codec.trace.json"))

    xla_n = XLA_MIB << 20
    for what, src in (("zlib-6 members: inflate_dynamic", bgzf.deflate_blocks(data[:xla_n], 6)[0]),
                      ("deflate-lanes members: row 10 rejects, inflate_fixed",
                       flate.bgzf_compress_device(data[:xla_n], level=1, use_lanes=True,
                                                  device="cuda", append_terminator=False))):
        st, m = flate.CodecTierStats(), Metrics()
        k = len(bgzf.scan_blocks(src)[0])
        out, wall, _, _ = timed_codec(
            lambda: flate.bgzf_decompress_device(src + bgzf.TERMINATOR, conf=off, device="cuda",
                                                 stats=st, metrics=m),
            f"bgzf_decompress_device(cuda, inflate gate off, {what}): {k} members, {xla_n} bytes")
        down = m.get("flate.lockstep_tierdown")
        log(f"  stats {json.dumps(st.as_dict())}, flate.lockstep_tierdown {down}, "
            f"{xla_n / wall / 1e6:.2f} MB/s")
        if out != data[:xla_n] or st.xla != k or st.host or st.lanes:
            raise AssertionError(f"the general programs missed {what}")
        if "lanes" in what and down != k:
            raise AssertionError("row 10 took a member with LZ77 copies")

    # The salvage phase's forced tier-downs (e): members 0-7 to the host,
    # the rest through row 1 (zlib-6 members, default gates) or row 10
    # (literal-only members, inflate gate off).
    from hadoop_bam_tpu_torch import faults

    t0 = time.perf_counter()
    plan = "flate.inflate.tierdown:members=0-7,n=8"
    forced = {}
    for what, src, conf, tier in (
            ("zlib-6 members, default gates: row 1",
             bgzf.deflate_blocks(data[:xla_n], 6)[0] + bgzf.TERMINATOR, None, kin.LAUNCHES.name),
            ("literal-only members, inflate gate off: row 10",
             flate.bgzf_compress_device(data[:xla_n], level=1, use_lanes=False, device="cuda"),
             off, kfix.LAUNCHES.name)):
        st, m = flate.CodecTierStats(), Metrics()
        k = len(bgzf.scan_blocks(src)[0]) - 1  # the terminator is empty
        faults.arm(plan)
        try:
            out, _, launches, _ = timed_codec(
                lambda: flate.bgzf_decompress_device(src, conf=conf, device="cuda", stats=st,
                                                     metrics=m),
                f"bgzf_decompress_device(cuda, {what}, {plan}): {k} members")
        finally:
            faults.disarm()
        fired = m.get("faults.fired.flate.inflate.tierdown")
        log(f"  stats {json.dumps(st.as_dict())}, faults.fired.flate.inflate.tierdown {fired}")
        if out != data[:xla_n] or fired != 8 or st.host != 8 or st.lanes != k - 8 or \
                launches.get(tier, 0) < 1:
            raise AssertionError(f"forced tier-downs ({what}): the clean decode's bytes "
                                 f"{out == data[:xla_n]}, {fired} fired, stats {st.as_dict()}")
        forced[tier] = launch_counts()
    log(f"forced tier-downs: 8 members a decode to the host, the same bytes ({xla_n}), in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rep = warm_kernels(device="cuda")
    rep2 = warm_kernels(device="cuda")
    log(f"warm_kernels(cuda) twice in {time.perf_counter() - t0:.3f} s: warmed "
        f"{json.dumps(rep['warmed'])}, compiles {rep['compiles']} then {rep2['compiles']}")
    if rep["warmed"] != {"overlap": 4, "keys": 4, "codec": 3} or rep2["compiles"] != 0:
        raise AssertionError("warm_kernels did not warm every family, or a warm call compiled")

    # Row 10 and row 1 on the round trip's members.
    comps, comp, clens, isz = codec_rows(blob)
    g = [torch.from_numpy(a).cuda() for a in (comp, clens, isz)]
    c = [torch.from_numpy(a) for a in (comp, clens, isz)]
    k_ms = cuda_ms(lambda: kfix.inflate_fixed_literal(*g), iters=20, warmup=3)
    prep = kfix._prepare(g[0], g[2])
    bare = (prep[0], g[1], g[2], prep[1], prep[2])
    bare_ms = cuda_ms(lambda: kfix._launch(*bare), iters=20, warmup=3)
    shares = fixed_phase_shares(bare)
    p_ms = once_ms(lambda: kfix.inflate_fixed_literal(*c))
    in_args = pack_members(comps, isz, "cuda")
    r1_ms = cuda_ms(lambda: kin.inflate_members(*in_args), iters=3, warmup=1)
    nbytes = int(clens.sum()) + 8 * len(isz) + int(isz.size) * int(isz.max()) + len(isz)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = OPS_PER_SYMBOL * int(isz.sum()) / INT_OPS_PER_S * 1e3
    log(f"  inflate_fixed_literal: {k_ms:.4f} ms a launch over {len(isz)} members (plain "
        f"{p_ms:.1f} ms; bound {max(b_bytes, b_ops):.5f} ms: bytes {b_bytes:.5f}, operations "
        f"{b_ops:.5f}); inflate_members (row 1) on the same members {r1_ms:.3f} ms")
    log(f"  inflate_fixed_literal: kernel_ms {bare_ms:.4f} (the bare launch), phase shares of "
        f"the blocks' cycles {json.dumps(shares)}")
    rows = [{
        "name": "inflate_fixed_literal", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/inflate_fixed.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/inflate_fixed.py:140", "launches": fixed_launches,
        "launches_from": "bgzf_decompress_device(cuda), inflate gate off",
        "max_abs_err": checks["inflate_fixed"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None, "row1_ms": r1_ms, "kernel_ms": bare_ms, "phase_shares": shares,
        "shape": f"{len(isz)} members of <= {int(isz.max())} bytes, C = {comp.shape[1]}",
    }]

    rows.append(time_inflate_probe(checks, seed))
    log(f"codec phase: {time.perf_counter() - t_phase:.1f} s")
    return rows, forced


def probe_chain() -> dict:
    """Row 11's dependent chain a wave timed alone on the card:
    ``tools/inflate_probe_chain.py`` built and run (``measure``) at
    ``PROBE_CHAIN_STEPS`` steps a chain, in a directory of its own."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "inflate_probe_chain", os.path.join(REPO, "tools", "inflate_probe_chain.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with tempfile.TemporaryDirectory(prefix="chip_smoke.chain.", dir=REPO) as d:
        return tool.measure(tool.build(d), PROBE_CHAIN_STEPS)


def probe_walk_ms(kip, R: int, gs, gc) -> dict:
    """Row 11 on ``gs``, ``gc``: ``ms`` at
    T = 2,048 (CUDA events, 20 launches), ``kernel_ms`` the bare launch (the
    C entry on preallocated outputs, no wrapper), ``ns_per_wave_in_stream``
    from T = 2,048 and 16,384 (every cursor in the stream) and
    ``ns_per_wave_past`` from T = 32,768 and 131,072 (bench_marginal's fit,
    the cursors past the stream)."""
    import torch

    from hadoop_bam_tpu_torch import _build

    def walk(T):
        w = kip.make_walk(R, T, "cuda")
        return lambda: w(gs, gc)

    lib = _build.load("inflate_probe")
    out = torch.empty((2, kip.LANES), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        _build.check(lib.hbt_inflate_probe_walk(gs.data_ptr(), R, gc.data_ptr(), 2048,
                                                out[0].data_ptr(), out[1].data_ptr(), stream),
                     "inflate_probe_walk")

    k_ms = cuda_ms(walk(2048), iters=20, warmup=3)
    t = {T: cuda_ms(walk(T), iters=5, warmup=1) for T in (16384, 32768, 131072)}
    return {"ms": k_ms, "kernel_ms": cuda_ms(bare, iters=20, warmup=3),
            "ns_per_wave_in_stream": (t[16384] - k_ms) / (16384 - 2048) * 1e6,
            "ns_per_wave_past": (t[131072] - t[32768]) / (131072 - 32768) * 1e6}


def time_inflate_probe(checks: dict, seed: int) -> dict:
    """Row 11: ``bench_marginal()`` with the launch counts zeroed just before
    it, then ``probe_walk_ms`` at R = 4,096 with every cursor at 3, and the
    latency floor: T times the wave's dependent chain (the table index, its
    byte load and the funnel shift, as the kernel's SASS chains them),
    timed alone in this run by ``probe_chain``."""
    import torch

    from hadoop_bam_tpu_torch.ops.kernels import inflate_probe as kip

    reset_counts()
    bench = kip.bench_marginal()
    probe_launches = launch_counts()[kip.LAUNCHES.name]
    if probe_launches < 1:
        raise AssertionError("bench_marginal launched no probe walk")
    log("  inflate_probe bench_marginal (R=4096, T=32768/131072): " + json.dumps(bench))
    R, T = 4096, 2048
    rng = np.random.default_rng(seed)
    streams = rng.integers(0, 1 << 31, (R, kip.LANES), dtype=np.int32)
    cursors = np.full((1, kip.LANES), 3, np.int32)
    gs, gc = torch.from_numpy(streams).cuda(), torch.from_numpy(cursors).cuda()
    mine = probe_walk_ms(kip, R, gs, gc)
    chain = probe_chain()
    log("  inflate_probe chain alone (tools/inflate_probe_chain.py): " + json.dumps(chain))
    step = chain["probe_step"]
    plain = kip.make_walk(R, T, "cpu")
    p_ms = once_ms(lambda: plain(torch.from_numpy(streams), torch.from_numpy(cursors)))
    b_bytes = (streams.nbytes + 3 * cursors.nbytes) / HBM_BYTES_PER_S * 1e3
    b_ops = OPS_PER_WAVE * kip.LANES * T / INT_OPS_PER_S * 1e3
    floor_ms = T * step["ns_per_step"] / 1e6
    row = {
        "name": "inflate_probe_walk", "route": "cuda",
        "source": "hadoop_bam_tpu_torch/csrc/inflate_probe.cu",
        "replaces": "hadoop_bam_tpu/ops/pallas/inflate_probe.py:119", "launches": probe_launches,
        "launches_from": "bench_marginal() at the reference's defaults",
        "max_abs_err": checks["inflate_probe"], "ms": mine["ms"], "plain_ms": p_ms,
        "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None, "bound_bytes_ms": b_bytes, "bound_ops_ms": b_ops,
        "latency_floor_ms": floor_ms, "chain_cycles": step["cycles_per_step"],
        "chain_sm_mhz": step["sm_mhz"],
        "kernel_ms": mine["kernel_ms"], "fixed_ms": bench["fixed_ms"],
        "ns_per_wave": bench["ns_per_wave"], "ns_per_wave_in_stream": mine["ns_per_wave_in_stream"],
        "geometry": f"1 block of {kip.LANES} threads", "length_class": "table",
        "ring_words": kip.RING, "ns_per_wave_past": mine["ns_per_wave_past"],
        "shape": f"R = {R}, T = {T}",
    }
    log(f"  inflate_probe_walk: {mine['ms']:.4f} ms at R={R}, T={T}, bare {mine['kernel_ms']:.4f} "
        f"(plain {p_ms:.1f} ms; bound bytes {b_bytes:.6f} ms, operations {b_ops:.6f} ms; latency "
        f"floor {floor_ms:.5f} ms = {step['cycles_per_step']:.2f} cycles a wave at "
        f"{step['sm_mhz']:.0f} MHz); "
        f"{mine['ns_per_wave_in_stream']:.2f} ns a wave with every cursor in the stream "
        f"(T = 2048..16384), bench_marginal {bench['ns_per_wave']:.2f}; {sm_clocks()}")
    return row


def sm_clocks() -> str:
    """The SM clock now and its maximum, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return f"SM clock, max: {out[0]}" if out else "SM clock not read"


#: Each path's full depth; a run at another depth logs each cut.
FULL_DEPTH = {"records": 2_000_000, "dup_pairs": 1_000_000, "pairs": 250_000,
              "variants": 4_500_000, "cram_records": 300_000}
#: The depths a run takes by default where they are cut below the full one
#: to keep the run inside its time limit (logged as cuts).
RUN_DEPTH = dict(FULL_DEPTH, dup_pairs=500_000)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=RUN_DEPTH["records"])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=RUN_DEPTH["pairs"],
                    help="read pairs of the ingest phase")
    ap.add_argument("--dup-pairs", type=int, default=RUN_DEPTH["dup_pairs"],
                    help="read pairs of the collation phase (markdup, queryname, fixmate)")
    ap.add_argument("--variants", type=int, default=RUN_DEPTH["variants"],
                    help="sites of the variants phase's call set")
    ap.add_argument("--cram-records", type=int, default=RUN_DEPTH["cram_records"],
                    help="records of the CRAM phase's corpus")
    ap.add_argument("--codec-mib", type=int, default=CODEC_MIB,
                    help="MiB of record bytes of the codec phase's round trip")
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
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    # The rANS check's container encodes (in Python) while the kernels build.
    pool = spawn_pool(1)
    container = pool.submit(cram_container, (synth_rows(CRAM_PER_CONTAINER, args.seed).tobytes(), 0))
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
        "crc32": check_crc32(args.seed)["max_abs_err"],
        "gather": check_gather(args.seed)["max_abs_err"],
        "deflate": check_deflate(args.seed)["max_abs_err"],
        "record_scan": check_record_scan(args.seed)["max_abs_err"],
    }
    contig, pos = synth_sites(120_000, args.seed)  # about one split of the call set
    big = synth_bcf_rows(contig, pos, args.seed).tobytes()
    checks["bcf_chain"] = check_bcf_chain(args.seed, big)["max_abs_err"]
    rans_row = check_rans(args.seed, container.result())
    checks.update(check_region(args.seed))
    checks["inflate_fixed"] = check_inflate_fixed(args.seed)["max_abs_err"]
    checks["inflate_probe"] = check_inflate_probe(args.seed)["max_abs_err"]
    pool.shutdown()
    torch.cuda.synchronize()
    if args.kernels_only:
        return 0
    for k, full in FULL_DEPTH.items():
        if getattr(args, k) != full:
            log(f"{k} cut from {full} to {getattr(args, k)}")
    if args.codec_mib != CODEC_MIB:
        log(f"codec round trip cut from {CODEC_MIB} MiB to {args.codec_mib} MiB")
    work = tempfile.mkdtemp(prefix="chip_smoke.", dir=REPO)
    try:
        res = main_path(work, args.records, args.seed)
        rows = time_kernels(res["src"], checks, res["launches"], res["launches_resident"],
                            args.seed)
        for k in ("cpu", "resident", "resident_host"):  # the region phase reads "zlib"
            os.remove(os.path.join(work, f"sorted.{k}.bam"))
        col = collation_phase(work, args.dup_pairs, args.seed)
        ext = external_phase(work, res, col, args.records)
        sal = salvage_phase(work, res, args.records)
        os.remove(res["src"])
        os.remove(res["lanes"])
        ing = ingest_phase(work, args.pairs, args.seed)
        rows.append(time_record_scan(ing["r1"], checks, ing["launches"]["record_scan"],
                                     "ingest_fastq(cuda), default gates"))
        del ing
        var = variants_phase(work, args.variants, args.seed)
        sal_var = salvage_variants(work, var)
        rows.append(time_bcf_chain(var["path"], checks, var["launches"]["bcf_chain"],
                                   f"variants_blob(cuda), {VARIANT_REGIONS[0]}"))
        txt = text_phase(work, args.records, args.seed, var)
        del var
        cr = cram_phase(work, args.cram_records, args.seed)
        rows.append(dict(rans_row, launches=cr["launches"]["rans"],
                         launches_from="sort_bam(cuda, .cram), default gates"))
        codec_rows, forced = codec_phase(work, args.seed, checks, args.codec_mib)
        rows += codec_rows
        rows += region_phase(work, res["flagstat"], res["sorted"], cr["cram"], cr["twin_sorted"],
                             checks)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    salvage = dict(sal["launches"], variants=sal_var["launches"])
    salvage.update({f"codec_{name}": n for name, n in forced.items()})
    log(f"salvage phase: {sal['seconds'] + sal_var['seconds']:.1f} s of sorts and the BCF "
        f"read, and the forced tier-downs of the codec phase")
    for row in rows:  # the launches of the later phases' card jobs
        row["collation_launches"] = {job: n[row["name"]] for job, n in col["launches"].items()}
        row["external_launches"] = {job: n[row["name"]] for job, n in ext["launches"].items()}
        row["salvage_launches"] = {job: n[row["name"]] for job, n in salvage.items()}
        row["text_launches"] = {job: n[row["name"]] for job, n in txt["launches"].items()}
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
