"""The write kernels' core (``csrc/write_core.cuh``) on the CPU: the
per-member CRC32 and the sorted record gather with the duplicate-flag patch.

A small C++ harness, held here, runs the core's functions with a block's
threads as loops, in the kernels' order: ``crc_member`` for each member,
last first, with shared memory and the threads' registers filled with
garbage before each member (the tree's warp shuffles run as their host
emulation, a level at a time); the tile map and ``gather_tile`` for each
tile, last first, with the tile map and the output filled with garbage
first.  A guard past the last output byte (and the last CRC) must stay as
it was.  It is built with ``g++ -O2 -shared -fPIC`` and bound with ctypes.
Pieces, slices and tiles are tiny here (16-64 bytes a thread a round, tiles
of 16-128 bytes and runs of 1-8 chunks, 1-33 threads), so that short
inputs cross many of them;
the card's default geometries run too.

It is held at tolerance 0 (every CRC, every byte) to ``crc32_plain`` /
``gather_stream_plain``, to ``zlib.crc32`` and the host gather, and to the
JAX package's ``crc32_device`` and ``gather_stream_device`` (XLA programs,
on the CPU).  The harness checks every read of the stream against its
bounds, on stream views at every residue mod 16 with members and records
at both ends: no byte outside the stream is read.  Two mutations (the
last, shorter slice shifted by the full slice's constant; the patch landing
on the neighbouring record's bytes) must each make it differ.  Skips where
there is no ``g++``."""

import ctypes
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from hadoop_bam_tpu.ops.pallas.crc32 import crc32_device as jcrc
from hadoop_bam_tpu.ops.pallas.gather_stream import gather_stream_device as jgather
from hadoop_bam_tpu_torch.ops.kernels import crc32 as kcrc
from hadoop_bam_tpu_torch.ops.kernels import gather as kg

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"

HARNESS = r"""
#include <stdlib.h>
#include <stdint.h>
#include <string.h>

// Every read of the stream is checked against [g_lo, g_hi).
static uintptr_t g_lo, g_hi;
static long long g_outside;
#define HBT_W_READ(p, n)                                             \
  do {                                                               \
    const uintptr_t a_ = (uintptr_t)(p);                             \
    if (a_ < g_lo || a_ + (n) > g_hi) ++g_outside;                   \
  } while (0)

#include "write_core.cuh"
using namespace hbt_write;

// Reads outside the stream since the last call.
extern "C" long long hbt_core_outside() {
  const long long n = g_outside;
  g_outside = 0;
  return n;
}

// hbt_crc32_members on the host: one member at a time, last first, the
// block's nth threads as loops, shared memory and the threads' registers
// filled with garbage before each member (the constants loaded as the
// kernel loads them).
extern "C" int hbt_core_crc32(const uint8_t* stream, long long numel, const int64_t* offs,
                              const int32_t* lens, long long n, uint32_t* out,
                              const uint32_t* consts, int nth, int w) {
  const CrcGeometry g = crc_geometry(nth, w);
  const size_t sb = (static_cast<size_t>(crc_smem_bytes(nth, w)) + 15) & ~size_t(15);
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, sb));
  uint32_t* acc = static_cast<uint32_t*>(malloc(4 * static_cast<size_t>(nth)));
  if (!smem || !acc || nth > 512) return 1;
  g_lo = (uintptr_t)stream;
  g_hi = g_lo + numel;
  for (long long i = n - 1; i >= 0; --i) {
    memset(smem, 0xA5, sb);
    memset(acc, 0x5A, 4 * static_cast<size_t>(nth));
    const CrcLayout L = crc_carve(smem, g);
    for (int tid = 0; tid < nth; ++tid) load_consts(L, consts, consts_words(nth), tid, nth);
    const CrcMember m{stream, numel, offs[i], lens[i], out + i};
    crc_member(m, g, L, acc);
  }
  free(acc);
  free(smem);
  return 0;
}

extern "C" long long hbt_core_crc_smem(int nth, int w) { return crc_smem_bytes(nth, w); }

// hbt_gather_stream on the host: the tile map (garbage first), then each
// tile, last first, its nth threads as loops.
extern "C" int hbt_core_gather(const uint8_t* stream, long long numel, const int64_t* src,
                               const int32_t* lens, const int32_t* dst_end, const uint8_t* dup,
                               long long n, int bits, uint8_t* out, long long total, int tile,
                               int nth) {
  if (n <= 0 || total <= 0) return 0;
  const long long tiles = (total + tile - 1) / tile;
  int32_t* tf = static_cast<int32_t*>(malloc(4 * static_cast<size_t>(tiles)));
  if (!tf) return 1;
  memset(tf, 0x7B, 4 * static_cast<size_t>(tiles));
  g_lo = (uintptr_t)stream;
  g_hi = g_lo + numel;
  GatherArgs a;
  a.stream = stream;
  a.numel = numel;
  a.src = src;
  a.lens = lens;
  a.dst_end = dst_end;
  a.dup = dup;
  a.n = n;
  a.lo = static_cast<uint32_t>(bits) & 0xFFu;
  a.hi = (static_cast<uint32_t>(bits) >> 8) & 0xFFu;
  a.out = out;
  a.total = total;
  a.tile_first = tf;
  a.tile = tile;
  a.tiles = tiles;
  for (long long r = n - 1; r >= 0; --r) tile_first_of(a, tf, r);
  for (long long b = tiles - 1; b >= 0; --b)
    for (int tid = 0; tid < nth; ++tid) gather_tile(a, b, tid, nth);
  free(tf);
  return 0;
}
"""

#: (what, the line of the core, what it becomes)
MUTATIONS = {
    "the last slice shifted by the full slice's constant": (
        "uint32_t crc = shift_bytes(L.c, *L.x, p.rE) ^ last;",
        "uint32_t crc = level_shift(L.c, 0, *L.x) ^ last;"),
    "the patch lands on the neighbouring record's bytes 18 and 19": (
        "if (a.dup != nullptr && a.dup[r] != 0) {",
        "if (a.dup != nullptr && a.dup[r > 0 ? r - 1 : 0] != 0) {"),
}

#: Garbage bytes past the last output byte that must stay as they are.
GUARD = 64


def _build(d: Path, header: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the write core on the host")
    (d / "write_core.cuh").write_text(header)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{d}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    return _bind(lib)


def _bind(lib):
    so = ctypes.CDLL(str(lib))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.hbt_core_crc32.argtypes = [p, i64, p, p, i64, p, p, i32, i32]
    so.hbt_core_crc_smem.argtypes = [i32, i32]
    so.hbt_core_crc_smem.restype = i64
    so.hbt_core_gather.argtypes = [p, i64, p, p, p, p, i64, i32, p, i64, i32, i32]
    so.hbt_core_outside.restype = i64
    return so


@pytest.fixture(scope="module")
def core_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("write_core")
    _build(d, (CSRC / "write_core.cuh").read_text())
    return d / "libcore.so"


@pytest.fixture(scope="module")
def core(core_lib):
    return _bind(core_lib)


def _crc_core(so, stream: np.ndarray, offs, lens, nth: int, w: int) -> np.ndarray:
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    n = len(offs)
    mem = np.random.default_rng(n).integers(0, 2**32, n + GUARD, dtype=np.uint64).astype(np.uint32)
    guard = mem[n:].copy()
    consts = kcrc.crc_consts(nth, w)
    assert so.hbt_core_crc32(stream.ctypes.data, stream.size, offs.ctypes.data, lens.ctypes.data,
                             n, mem.ctypes.data, consts.ctypes.data, nth, w) == 0
    assert np.array_equal(mem[n:], guard), "a CRC written past the last member"
    assert so.hbt_core_outside() == 0, "a read outside the stream"
    return mem[:n].copy()


def _crc_plain(stream: np.ndarray, offs, lens) -> np.ndarray:
    got = kcrc.crc32_device(torch.from_numpy(stream), offs, lens)
    return got.view(torch.int32).numpy().view(np.uint32)


def _crc_zlib(stream: np.ndarray, offs, lens) -> np.ndarray:
    return np.array([zlib.crc32(stream[o: o + n]) for o, n in zip(offs, lens)], np.uint32)


def _gather_core(so, stream: np.ndarray, src, lens, dup, bits: int, tile: int, nth: int):
    src = np.ascontiguousarray(src, np.int64)
    ln = np.ascontiguousarray(lens, np.int32)
    ends = np.ascontiguousarray(np.cumsum(ln.astype(np.int64)), np.int32)
    total = int(ends[-1]) if len(ln) else 0
    rng = np.random.default_rng(total)
    mem = rng.integers(0, 256, total + GUARD + 16, dtype=np.uint8)
    at = (-mem.ctypes.data) % 16
    guard = mem[at + total:at + total + GUARD].copy()
    dm = None if dup is None else np.ascontiguousarray(dup, np.uint8)
    assert so.hbt_core_gather(stream.ctypes.data, stream.size, src.ctypes.data, ln.ctypes.data,
                              ends.ctypes.data, None if dm is None else dm.ctypes.data, len(ln),
                              bits, mem.ctypes.data + at, total, tile, nth) == 0
    assert np.array_equal(mem[at + total:at + total + GUARD], guard), "a write past the output"
    assert so.hbt_core_outside() == 0, "a read outside the stream"
    return mem[at:at + total].copy()


def _gather_plain(stream, src, lens, dup, bits):
    out, total = kg.gather_stream_device(torch.from_numpy(stream), src, lens,
                                         dup_mask=None if dup is None else dup.astype(bool),
                                         bits=bits)
    assert total == out.numel()
    return out.numpy()


# ---------------------------------------------------------------------------
# Cases.

CRC_CASES = chip_smoke.crc_trouble_cases(0)

#: (threads, bytes a thread a round): one thread, a few (not powers of two:
#: the tree pads), a warp, more than a warp; the card's default last.
CRC_GEOMETRIES = [(1, 16), (2, 16), (3, 32), (5, 16), (7, 64), (8, 32), (32, 16), (33, 16),
                  (64, 32), (kcrc.THREADS, kcrc.W)]


GATHER_CASES = chip_smoke.gather_trouble_cases(0)

#: (tile bytes, threads): one thread a tile, a few, a warp, more than a
#: warp, tiles from one chunk up (runs of 1-8 chunks a thread); the card's
#: default last.
GATHER_GEOMETRIES = [(16, 1), (32, 2), (48, 3), (64, 5), (16, 32), (128, 33), (128, 2),
                     (kg.TILE, kg.THREADS)]


# ---------------------------------------------------------------------------
# Tests.


def test_shared_memory_fits_a_block(core):
    """The default geometry's shared memory fits 48 KB, the largest in a
    block's 227 KB, and the constants are laid out as the core reads them."""
    assert core.hbt_core_crc_smem(kcrc.THREADS, kcrc.W) <= 48 * 1024
    assert core.hbt_core_crc_smem(256, 256) <= 232448
    c = kcrc.crc_consts(kcrc.THREADS, kcrc.W)
    assert c.size == 2048 + 128 * 7 and np.array_equal(c[:1024], kcrc.CRC_TABLES.ravel())


def test_zeros_shift_is_zero_bytes_fed_to_the_register():
    """A^n of a register equals feeding n zero bytes, for the lengths the
    round and the tree use."""
    t0 = kcrc.CRC_TABLES[0]
    rng = np.random.default_rng(1)
    for n in (0, 1, 3, 16, 48, 1008, 8128):
        v = int(rng.integers(0, 2**32))
        c = v
        for _ in range(n):
            c = (c >> 8) ^ int(t0[c & 0xFF])
        assert int(kcrc._apply(kcrc.zeros_shift(n), np.array([v], np.uint32))[0]) == c


@pytest.mark.parametrize("geom", CRC_GEOMETRIES, ids=[f"nth{g[0]}-w{g[1]}" for g in CRC_GEOMETRIES])
@pytest.mark.parametrize("case", sorted(CRC_CASES))
def test_crc_matches_plain_and_zlib(core, case, geom):
    """Every CRC is the plain version's and zlib's."""
    s, offs, lens = CRC_CASES[case]
    got = _crc_core(core, s, offs, lens, *geom)
    want = _crc_zlib(s, offs, lens)
    assert np.array_equal(_crc_plain(s, offs, lens), want)
    bad = np.flatnonzero(got != want)
    assert not len(bad), f"member {bad[0]} ({lens[bad[0]]} bytes at {offs[bad[0]]})"


@pytest.mark.parametrize("geom", GATHER_GEOMETRIES,
                         ids=[f"tile{g[0]}-nth{g[1]}" for g in GATHER_GEOMETRIES])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_matches_plain_and_the_host_gather(core, case, geom):
    """Every output byte is the plain version's and the host gather's."""
    s, src, ln, dup, bits = GATHER_CASES[case]
    got = _gather_core(core, s, src, ln, dup, bits, *geom)
    want = chip_smoke.host_gather(s, src, ln, dup, bits)
    assert np.array_equal(_gather_plain(s, src, ln, dup, bits), want)
    assert got.shape == want.shape
    bad = np.flatnonzero(got != want)
    assert not len(bad), f"byte {bad[0]} of {len(want)}"


@pytest.mark.parametrize("case", ["every length at every residue",
                                  "members ending at the last byte, a view at +7"])
def test_crc_matches_the_reference(core, case):
    """The JAX package's ``crc32_device`` on the CPU gives the same column."""
    s, offs, lens = CRC_CASES[case]
    ref = np.asarray(jcrc(s.copy(), np.asarray(offs), np.asarray(lens))).astype(np.uint32)
    assert np.array_equal(_crc_core(core, s, offs, lens, 32, 16), ref)
    assert np.array_equal(_crc_core(core, s, offs, lens, kcrc.THREADS, kcrc.W), ref)


@pytest.mark.parametrize("case", ["every src / dst residue pair",
                                  "records of 0-36 bytes and 64 KiB",
                                  "flags straddling a chunk and a tile"])
def test_gather_matches_the_reference(core, case):
    """The JAX package's ``gather_stream_device`` on the CPU gives the same
    bytes."""
    s, src, ln, dup, bits = GATHER_CASES[case]
    ref, total = jgather(s.copy(), src, ln, dup_mask=dup, bits=bits)
    ref = np.asarray(ref)[:total]
    assert np.array_equal(_gather_core(core, s, src, ln, dup, bits, 48, 3), ref)
    assert np.array_equal(_gather_core(core, s, src, ln, dup, bits, kg.TILE, kg.THREADS), ref)


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_fail(tmp_path, name):
    """Each mutation of the core makes it differ on the cases at some
    geometry."""
    src = (CSRC / "write_core.cuh").read_text()
    old, new = MUTATIONS[name]
    assert src.count(old) == 1, f"mutation site of {name} not found"
    so = _build(tmp_path, src.replace(old, new))
    if "CRC" in name or "slice" in name:
        found = any(
            not np.array_equal(_crc_core(so, *CRC_CASES[c], *g), _crc_zlib(*CRC_CASES[c]))
            for g in CRC_GEOMETRIES[::-1] if g[0] > 1 for c in sorted(CRC_CASES))
    else:
        found = any(
            not np.array_equal(_gather_core(so, *GATHER_CASES[c], *g),
                               chip_smoke.host_gather(*GATHER_CASES[c]))
            for g in GATHER_GEOMETRIES for c in sorted(GATHER_CASES))
    assert found, name


def test_no_byte_outside_the_stream_is_read(core):
    """Short streams, views at every residue, members and records at both
    ends: the core's every read of the stream (each 16-byte load, each
    byte) is checked against the stream's bounds by the harness."""
    rng = np.random.default_rng(5)
    for numel in (1, 2, 3, 15, 16, 17, 31, 100, 4097):
        for at in range(16):
            s = chip_smoke.write_view(rng, numel, at)
            ln = [n for n in (1, 2, 3, 4, 15, 16, 17, 33, numel) if n <= numel]
            offs, lens = [0] * len(ln) + [numel - n for n in ln], ln + ln
            for g in ((1, 16), (3, 32), (32, 16), (kcrc.THREADS, kcrc.W)):
                assert np.array_equal(_crc_core(core, s, offs, lens, *g), _crc_zlib(s, offs, lens))
            k = min(numel, 40)
            src = np.array([0, numel - k, 0, numel - 1, numel - k // 2])
            rl = np.array([k, k, 1, 1, k // 2])
            dup = np.ones(5, bool)
            for g in ((16, 1), (48, 3), (kg.TILE, kg.THREADS)):
                assert np.array_equal(_gather_core(core, s, src, rl, dup, 0x400, *g),
                                      chip_smoke.host_gather(s, src, rl, dup, 0x400))


def _fuzz_crc(data):
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    numel = data.draw(st.sampled_from([1, 16, 33, 500, 5000, 70000]))
    s = chip_smoke.write_view(rng, numel, data.draw(st.integers(0, 15)))
    n = data.draw(st.integers(1, 12))
    lens = rng.integers(0, numel + 1, n)
    if data.draw(st.booleans()):
        lens = np.minimum(lens, data.draw(st.sampled_from([3, 20, 300])))
    offs = rng.integers(0, numel - lens + 1)
    geom = data.draw(st.sampled_from(CRC_GEOMETRIES))
    return s, offs, lens, geom


@settings(max_examples=80, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_crc_matches_zlib(core, data):
    """Random members of random streams (views at every residue) at every
    geometry; the same examples on every run."""
    s, offs, lens, geom = _fuzz_crc(data)
    assert np.array_equal(_crc_core(core, s, offs, lens, *geom), _crc_zlib(s, offs, lens))


def _fuzz_gather(data):
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    numel = data.draw(st.sampled_from([1, 40, 700, 20000]))
    s = chip_smoke.write_view(rng, numel, data.draw(st.integers(0, 15)))
    n = data.draw(st.integers(1, 40))
    hi = data.draw(st.sampled_from([1, 3, 20, 40, 400]))
    ln = np.minimum(rng.integers(0, hi + 1, n), numel)
    src = rng.integers(0, numel - ln + 1)
    dup = rng.random(n) < data.draw(st.sampled_from([0.0, 0.3, 1.0]))
    bits = data.draw(st.sampled_from([kg.FLAG_DUPLICATE, 0xFFFF, 0x0080]))
    geom = data.draw(st.sampled_from(GATHER_GEOMETRIES))
    return s, src, ln, (None if data.draw(st.booleans()) else dup), bits, geom


@settings(max_examples=80, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_gather_matches_the_host_gather(core, data):
    """Random records (0 bytes up), marks and patch bits at every geometry;
    the same examples on every run."""
    s, src, ln, dup, bits, geom = _fuzz_gather(data)
    if int(ln.sum()) == 0:
        return
    want = chip_smoke.host_gather(s, src, ln, dup, bits)
    assert np.array_equal(_gather_core(core, s, src, ln, dup, bits, *geom), want)
    assert np.array_equal(_gather_plain(s, src, ln, dup, bits), want)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On a card: both kernels against zlib and the host gather on the cases
    above, exactly, at the default geometry, from card views at the cases'
    residues."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on the H100)")
    for s, offs, lens in CRC_CASES.values():
        got = kcrc.crc32_device(chip_smoke.on_card_at(s), offs, lens).cpu()
        assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                              _crc_zlib(s, offs, lens))
    for s, src, ln, dup, bits in GATHER_CASES.values():
        got, _ = kg.gather_stream_device(chip_smoke.on_card_at(s), src, ln,
                                         dup_mask=dup, bits=bits)
        assert np.array_equal(got.cpu().numpy(), chip_smoke.host_gather(s, src, ln, dup, bits))
