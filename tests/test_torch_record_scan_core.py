"""The FASTQ record-scan kernel's core (``csrc/record_scan_core.cuh``) on the CPU.

The core is the scan of ``csrc/record_scan.cu``: a chunk's window read in
tiles (staged into two shared-memory buffers), each tile's newlines counted
and scanned into line numbers, its lines written into a shared ring, the
line machine's decisions taken as block minima (the sync line, then the
first record that stops the scan) and the records before a stop written in
parallel, then the synthetic final line and the final verdicts.  A small C++
harness, held here, runs ``scan_chunk`` with each block's threads as loops,
in the kernel's order, over a shared-memory buffer, rows and meta filled
with garbage; it is built with ``g++ -O2 -shared -fPIC`` and bound with
ctypes.  Tiles are tiny here (16-256 bytes) so that short windows cross
many tiles, and the block has 1-32 threads; the card's default geometry
(``record_scan.TILE`` and ``THREADS``) runs too.

It is held at tolerance 0 to ``record_scan_plain`` (``[n, ok]`` of every
chunk and ``rows[:n]`` of every chunk, ``ok = 0`` ones included) on
``chip_smoke.record_scan_trouble_cases``, the cases of
``test_torch_record_scan.py`` and a hypothesis fuzz, and on a few cases to
the JAX package's Pallas kernel (``_launch(..., interpret=True)`` at the
pinned 256/256/rec_cap 64 geometry).  Two mutations (the sync trusting one
lone frame, as the host's end-of-data relaxation does; the CR strip reading
the current tile at a tile seam) must each make it differ.
Skips where there is no ``g++``."""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_ingest import make_fastq
from test_torch_record_scan import chunks_of, ref_meta

import chip_smoke
from hadoop_bam_tpu_torch.ops.kernels import record_scan as krs

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"

HARNESS = r"""
#include <stdlib.h>
#include <stdint.h>
#include "record_scan_core.cuh"
using namespace hbt_scan;

// hbt_record_scan on the host: one chunk at a time, the block's nth threads
// as loops, shared memory filled with garbage before each chunk.
extern "C" int hbt_core_scan(const uint8_t* data, const int64_t* win_off, const int32_t* win_len,
                             const int32_t* chunk_len, const int32_t* flags, const int32_t* caps,
                             const int64_t* row_base, int32_t* rows, int32_t* meta,
                             long long n_chunks, int tile, int nth) {
  const size_t sb = (static_cast<size_t>(smem_bytes(tile, nth)) + 15) & ~size_t(15);
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, sb));
  if (!smem) return 1;
  for (long long k = 0; k < n_chunks; ++k) {
    memset(smem, 0xA5, sb);
    const Layout L = carve(smem, tile, nth);
    const uint8_t* w = data + win_off[k];
    const Chunk c{w, win_len[k], chunk_len[k], caps[k], flags[k] & 1, (flags[k] >> 1) & 1,
                  static_cast<int32_t>(reinterpret_cast<uintptr_t>(w) & 15),
                  rows + 8 * row_base[k]};
    scan_chunk<false>(c, L, nth, meta + 2 * k, nullptr);
  }
  free(smem);
  return 0;
}

extern "C" long long hbt_core_smem(int tile, int nth) { return smem_bytes(tile, nth); }
"""

#: (what, the line of the core, what it becomes)
MUTATIONS = {
    "sync_trusts_a_lone_frame": (
        "if (frame(s, L, i) && frame(s, L, i + 4)) {",
        "if (frame(s, L, i)) {"),
    "cr_strip_reads_the_current_tile": (
        "const int32_t before = p > ts ? tb[p - 1 - ts] : s.prev;",
        "const int32_t before = tb[p - 1 - ts];"),
}


def _build(d: Path, header: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the record-scan core on the host")
    (d / "record_scan_core.cuh").write_text(header)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{d}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    so.hbt_core_scan.argtypes = [p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    so.hbt_core_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    so.hbt_core_smem.restype = ctypes.c_longlong
    return so


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("record_scan_core"),
                  (CSRC / "record_scan_core.cuh").read_text())


def _run_core(so, chunks, tile: int, nth: int, shift: int = 0):
    """The core's ``[n, ok]`` and ``rows[:n]`` of each chunk, its windows
    packed ``shift`` bytes past 16-byte boundaries."""
    blob, starts, lens, cl, al, fi, caps = chip_smoke.scan_blob(chunks, shift)
    mem = np.zeros(len(blob) + 32, np.uint8)
    at = (-mem.ctypes.data) % 16
    mem[at: at + len(blob)] = np.frombuffer(blob, np.uint8)
    n = len(chunks)
    base = np.zeros(n, np.int64)
    np.cumsum(caps[:-1], out=base[1:])
    flags = (al.astype(np.int32) | (fi.astype(np.int32) << 1))
    cols = [starts, lens.astype(np.int32), cl.astype(np.int32), flags, caps.astype(np.int32),
            base]
    rows = np.random.default_rng(n).integers(-2**31, 2**31 - 1, (int(caps.sum()), 8),
                                            dtype=np.int32)
    meta = np.full((n, 2), -7, np.int32)
    rc = so.hbt_core_scan(mem.ctypes.data + at, *(c.ctypes.data for c in cols), rows.ctypes.data,
                          meta.ctypes.data, n, tile, nth)
    assert rc == 0
    return meta, [rows[b: b + m] for b, m in zip(base.tolist(), meta[:, 0].tolist())]


def _plain(chunks):
    blob, *cols = chip_smoke.scan_blob(chunks)
    rows, meta, base = krs.scan_windows(torch.from_numpy(np.frombuffer(blob, np.uint8).copy()),
                                        *cols)
    meta, rows = meta.numpy(), rows.numpy()
    return meta, [rows[b: b + m] for b, m in zip(base.tolist(), meta[:, 0].tolist())]


def _differs(so, chunks, tile, nth, shift=0, plain=None):
    """Where the core and the plain version disagree (``None`` if nowhere)."""
    meta, rows = _run_core(so, chunks, tile, nth, shift)
    meta_p, rows_p = plain if plain is not None else _plain(chunks)
    if not np.array_equal(meta, meta_p):
        k = int(np.flatnonzero((meta != meta_p).any(1))[0])
        return f"chunk {k}: [n, ok] {meta[k].tolist()} vs {meta_p[k].tolist()}"
    for k, (a, b) in enumerate(zip(rows, rows_p)):
        if not np.array_equal(a, b):
            return f"chunk {k}: rows"
    return None


#: (tile, threads): one vector a thread, several, and more threads than
#: vectors; the card's default last.
GEOMETRIES = [(16, 1), (32, 2), (48, 3), (64, 4), (64, 32), (128, 8), (256, 16), (256, 5),
              (krs.TILE, krs.THREADS)]
TROUBLE_NAMES = sorted(chip_smoke.record_scan_trouble_cases(7, 16))


@functools.lru_cache(maxsize=None)
def _trouble(tile):
    return chip_smoke.record_scan_trouble_cases(7, tile)


@functools.lru_cache(maxsize=None)
def _trouble_plain(tile, what):
    return _plain(_trouble(tile)[what])


def test_shared_memory_fits_a_block(core):
    """The default geometry's shared memory is the kernel's, and within a
    block's 227 KB up to 16 KiB tiles at 256 threads."""
    assert core.hbt_core_smem(krs.TILE, krs.THREADS) == 4 * (krs.TILE + 8) + 2 * krs.TILE \
        + 8 * krs.THREADS + 8 * (krs.THREADS // 32) + 16
    assert core.hbt_core_smem(krs.TILE, krs.THREADS) <= 48 * 1024
    assert core.hbt_core_smem(16384, 256) <= 232448


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[f"tile{g[0]}-nth{g[1]}" for g in GEOMETRIES])
@pytest.mark.parametrize("what", TROUBLE_NAMES)
def test_trouble_cases_match_plain(core, geom, what):
    """``chip_smoke.record_scan_trouble_cases`` built for each tile: the
    core's meta and rows are the plain version's, from 16-byte boundaries
    and from 7 and 13 bytes past them."""
    tile, nth = geom
    chunks = _trouble(tile)[what]
    for shift in (0, 7, 13):
        assert _differs(core, chunks, tile, nth, shift, _trouble_plain(tile, what)) is None


def _record_scan_cases():
    """The chunks of ``test_torch_record_scan.py`` (256-byte claims and 256
    bytes of overlap; caps 64, 8)."""
    cases = {}
    for crlf in (False, True):
        for qual_at in (0, 3):
            cases[f"crlf={crlf}, qual_at={qual_at}"] = chunks_of(
                make_fastq(30, seed=11, crlf=crlf, qual_at_every=qual_at))
    cases["no trailing newline"] = chunks_of(make_fastq(12, seed=4, trailing_nl=False))
    small = make_fastq(4, seed=4, trailing_nl=False)
    cases["small, no trailing newline"] = [(small, len(small), True, True)]
    cases["unaligned resync"] = chunks_of(make_fastq(24, seed=7)[17:], aligned=False)
    win = make_fastq(3, seed=9)[5:]
    lone = win[: win.index(b"@r2")]
    cases["a lone final frame"] = [(lone, len(lone), False, True)]
    clean = make_fastq(8, seed=2)[:512]
    garbage = bytes(range(1, 128)) * 4
    cases["garbage and clean"] = [(garbage[:512], 256, True, False),
                                  (clean, min(256, len(clean)), True, True)]
    run = b"".join(b"@%d\nA\n+\nI\n" % i for i in range(40))[:512]
    cases["record cap overflow"] = [(run, 256, True, False), (run[:100], 100, True, True)]
    return cases


RS_CASES = _record_scan_cases()


@pytest.mark.parametrize("geom", GEOMETRIES[:8:2], ids=[f"tile{g[0]}-nth{g[1]}"
                                                         for g in GEOMETRIES[:8:2]])
@pytest.mark.parametrize("case", sorted(RS_CASES))
def test_record_scan_cases_match_plain(core, case, geom):
    """The chunks of ``test_torch_record_scan.py`` at caps 64 and 8."""
    for cap in (64, 8):
        chunks = [(*c, cap) for c in RS_CASES[case]]
        assert _differs(core, chunks, *geom, shift=3) is None


@pytest.mark.parametrize("case", ["crlf=True, qual_at=3", "unaligned resync",
                                  "a lone final frame", "garbage and clean",
                                  "record cap overflow"])
def test_core_matches_the_reference(core, case):
    """A few cases against the JAX package's Pallas kernel in interpret
    mode at the pinned geometry (256-byte claims + 256 bytes of overlap,
    rec_cap 64 and 8): ``[n, ok]`` and rows of every chunk."""
    for cap in (64, 8):
        chunks = RS_CASES[case]
        mj, rj = ref_meta(chunks, rec_cap=cap)
        meta, rows = _run_core(core, [(*c, cap) for c in chunks], 64, 4, shift=5)
        np.testing.assert_array_equal(meta, mj)
        for k, (a, b) in enumerate(zip(rows, rj)):
            np.testing.assert_array_equal(a, b, err_msg=f"chunk {k}")


def test_ring_holds_a_tile_of_newlines(core):
    """Every byte a newline, at every tile: the tile's lines and the eight
    before them fit the ring; aligned and not, final and not, both give the
    plain version's verdict (ok = 0, no record)."""
    chunks = _trouble(16)["every byte a newline"]
    for tile, nth in ((16, 1), (256, 16), (krs.TILE, krs.THREADS)):
        meta, _ = _run_core(core, chunks, tile, nth)
        assert meta.tolist() == [[0, 0]] * 4


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_fail(tmp_path, name):
    """Each mutation of the core makes it differ from the plain version on
    the trouble cases."""
    src = (CSRC / "record_scan_core.cuh").read_text()
    old, new = MUTATIONS[name]
    assert src.count(old) == 1, f"mutation site of {name} not found"
    so = _build(tmp_path, src.replace(old, new))
    bad = [(what, g) for g in GEOMETRIES[:4] for what in TROUBLE_NAMES
           if _differs(so, _trouble(g[0])[what], *g, 0, _trouble_plain(g[0], what)) is not None]
    assert bad, name


def _fuzz_chunks(data):
    """FASTQ text of records (0-60 bases, LF or CRLF line by line, qualities
    starting with '@' or '+' at random, some a base short) and junk lines
    (empty, lone CR, '@' or '+' first), cut into 1-4 windows at random
    offsets, with random claims, caps and flags."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    pieces = []
    for _ in range(data.draw(st.integers(0, 30))):
        kind = data.draw(st.sampled_from(["rec", "rec", "rec", "rec", "junk"]))
        if kind == "rec":
            n = int(rng.integers(0, 61))
            eol = [b"\r\n" if rng.random() < 0.3 else b"\n" for _ in range(4)]
            q0 = bytes([int(rng.choice([0x40, 0x2B, 0x49]))]) if n else b""
            qn = n - 1 if n and rng.random() < 0.05 else n
            pieces.append(b"".join(a + e for a, e in zip(
                chip_smoke._fq_lines(rng, n, b"", q0, name=int(rng.integers(0, 12)))[:3]
                + [(q0 + b"I" * qn)[:qn]], eol)))
        else:
            pieces.append(bytes(rng.choice([b"", b"\r", b"@x", b"+", b"@", b"ACGT", b"+\r"]))
                          + b"\n")
    text = b"".join(pieces)
    chunks = []
    for _ in range(data.draw(st.integers(1, 4))):
        a = data.draw(st.integers(0, len(text)))
        b = data.draw(st.integers(a, len(text)))
        win = text[a:b]
        cl = data.draw(st.integers(0, len(win) + 5))
        cap = data.draw(st.sampled_from([0, 1, 2, 3, 5, 64]))
        chunks.append((win, cl, data.draw(st.booleans()), data.draw(st.booleans()), cap))
    tile = data.draw(st.sampled_from([16, 32, 48, 64, 128, 256]))
    nth = data.draw(st.sampled_from([1, 2, 3, 4, 8, 32]))
    return chunks, tile, nth, data.draw(st.integers(0, 15))


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_windows_match_plain(core, data):
    """Random records, junk lines, CR/LF mixes, '@'/'+' first bytes, window
    cuts, claims, caps and flags, at tiles of 16-256 bytes, 1-32 threads and
    windows 0-15 bytes past a 16-byte boundary."""
    chunks, tile, nth, shift = _fuzz_chunks(data)
    assert _differs(core, chunks, tile, nth, shift) is None
