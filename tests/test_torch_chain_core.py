"""The BAM record-chain kernel's walk (``csrc/chain_core.cuh``) on the CPU.

The core is the walk of ``csrc/chain.cu``: the map (each position's exit
and count in a segment: links, the sub-segments' strips walked backward,
the sub-segments joined), the compose of group exits, the hop through the
tables from 0 with the carry between slabs, the fill, and the emit (thread
0's re-walk of each entered segment into a list, then the block's rows:
int64 offsets and, with keys, each record's packed sort key and unmapped
byte from the bytes staged for the walk; the rows past the count zeroed).
A small C++ harness, held here, runs the phases in the kernels' order with
each block's threads as loops, through a workspace, a shared-memory
buffer, an offsets array and key arrays filled with garbage (a guard past
the key rows must stay); it is built with ``g++ -O2 -shared -fPIC`` and
bound with ctypes.  Segments are tiny here (64-512 bytes, slabs of a few
segments) so that short streams cross many boundaries.

It is held at tolerance 0 to ``record_chain_plain`` (``offs[:count]``,
count, ok) and ``stream_keys_plain`` (keys and unmapped of a few rows more
or fewer than the walk finds) on ``chip_smoke.chain_trouble_cases``, the
six cases of ``test_torch_chain_keys.py`` and a hypothesis fuzz, and to
the JAX package's ``record_chain_device(..., interpret=True)`` and
``keys_from_stream_device(..., interpret=True)`` on seven trouble cases,
the six streams and a smaller fuzz.  Three mutations (the hop taking each
segment's first plausible size word as its entry; the map counting the
record at an erroring position; the emit staged with the map's 8-byte
halo, short of a late record's key fields) must each make it differ.
Skips where there is no ``g++``."""

import ctypes
import functools
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from hadoop_bam_tpu.ops import decode as jdecode
from hadoop_bam_tpu.ops.keys import pack_keys_np
from hadoop_bam_tpu.ops.pallas import chain as jchain
from hadoop_bam_tpu_torch.ops.kernels import chain as kch
from test_torch_chain_keys import CASES

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"

HARNESS = r"""
#include <stdlib.h>
#include <stdint.h>
namespace hbt_chain { struct Walk; }
// Used by the guessing mutation only: the first position of the segment at
// seg0 whose size word is plausible, else cur.
int64_t hbt_guess_entry(const hbt_chain::Walk& w, int64_t seg0, int64_t cur);
#include "chain_core.cuh"
using namespace hbt_chain;

int64_t hbt_guess_entry(const Walk& w, int64_t seg0, int64_t cur) {
  for (int64_t p = seg0; p < seg0 + w.seg && p + 4 <= w.n; ++p) {
    uint32_t bs;
    memcpy(&bs, w.s + p, 4);
    if (bs >= kMinBody && bs <= kMaxBody) return p;
  }
  return cur;
}

// hbt_chain_walk on the host: per slab, the map of each segment, the
// compose of each, the hop, the fill of each, the emit of each entered
// segment (thread 0's walk into the list, then the rows with nth threads
// as loops); on the last slab, with keys, the zeroed rows past the count
// from max(segs, 1) blocks, last.  Shared memory is garbage before each
// block.  info: segments, hops, segments entered.
extern "C" int hbt_core_walk(const uint8_t* s, long long n, int64_t* offs, int64_t* meta,
                             long long seg, long long slab, int nsub, int64_t* info,
                             int64_t* keys, uint8_t* unmapped, long long n_rows, int nth) {
  const Plan pl = make_plan(n, seg, slab);
  const Walk w{s, n, seg, nsub, seg_shift(seg)};
  const Keys kk{keys, unmapped, n_rows};
  const size_t wb = (work_bytes(pl, seg) + 15) & ~size_t(15);
  const size_t sb = map_smem(seg) > emit_smem(seg) ? map_smem(seg) : emit_smem(seg);
  uint8_t* work = static_cast<uint8_t*>(aligned_alloc(16, wb));
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, (sb + 15) & ~size_t(15)));
  if (!work || !smem) return 1;
  memset(work, 0xA5, wb);
  const Work t = carve(work, pl, seg);
  const int64_t spl = slab / seg;
  for (int64_t j = 0; j < pl.slabs; ++j) {
    const int64_t slab0 = j * slab;
    const int64_t left = pl.segs - j * spl;
    const int64_t segs = left < 0 ? 0 : left < spl ? left : spl;
    for (int64_t k = 0; k < segs; ++k) {
      memset(smem, 0xA5, map_smem(seg));
      uint32_t* lk = reinterpret_cast<uint32_t*>(smem);
      uint8_t* buf = smem + 4 * seg;
      const int64_t seg0 = slab0 + k * seg;
      const int lead = stage(w, seg0, buf, 0, 1);
      for (int g = 0; g < nsub; ++g)
        map_strips(w, seg0, static_cast<int32_t>(k * seg), buf, lead, lk, t.far + k * seg, g, 0,
                   1);
      map_join(w, lk, 0, 1);
      map_store(w, lk, t.exits + k * seg, 0, 1);
    }
    for (int64_t k = 0; k < segs; ++k) compose(w, segs, t, k, 0, 1);
    hop(w, slab0, segs, j == 0, t, meta, 0, 1);
    for (int64_t k = 0; k < segs; ++k) fill(w, t, k);
    for (int64_t k = 0; k < segs; ++k) info[2] += t.entry[k] >= 0;
    for (int64_t k = segs - 1; k >= 0; --k) {
      if (t.entry[k] < 0) continue;
      memset(smem, 0xA5, emit_smem(seg));
      const int lead = emit_stage(w, slab0 + k * seg, smem, 0, 1);
      int32_t* at = emit_list(smem, seg);
      at[0] = emit_walk(w, slab0, t, k, smem, lead, at + 1);
      for (int tid = 0; tid < nth; ++tid)
        emit_rows(w, slab0, t, k, smem, lead, at + 1, at[0], offs, kk, tid, nth);
    }
    if (j + 1 == pl.slabs && keys != nullptr) {
      const int64_t nb = segs > 0 ? segs : 1;
      for (int64_t b = 0; b < nb; ++b)
        for (int tid = 0; tid < nth; ++tid) emit_rest(kk, meta[0], b, nb, tid, nth);
    }
  }
  info[0] = pl.segs;
  info[1] = t.carry->hops;
  free(work);
  free(smem);
  return 0;
}

extern "C" int hbt_core_next(int i, uint32_t bs, int n) { return next_record(i, bs, n); }

extern "C" void hbt_core_plan(long long n, long long seg, long long slab, int64_t* out) {
  const Plan pl = make_plan(n, seg, slab);
  out[0] = pl.segs;
  out[1] = pl.per_slab;
  out[2] = pl.slabs;
  out[3] = work_bytes(pl, seg);
}
"""

#: (what, the line of the core, what it becomes)
MUTATIONS = {
    "hop_guesses_entries": (
        "const uint32_t k = rel >> w.shift, off = rel & mask;",
        "const uint32_t k = rel >> w.shift;\n"
        "      rel = static_cast<uint32_t>(hbt_guess_entry(w, slab0 + (int64_t{k} << w.shift),"
        " slab0 + rel) - slab0);\n"
        "      const uint32_t off = rel & mask;"),
    "map_counts_the_erroring_record": (
        "v = kFinal | kCodeErr;",
        "v = kFinal | kCodeErr | kOne;"),
    "emit_staged_with_the_map_halo": (
        "return stage(w, seg0, buf, tid, nthreads, kEmitHalo);",
        "return stage(w, seg0, buf, tid, nthreads, kHalo);"),
}


def _build(d: Path, header: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the record-chain core on the host")
    (d / "chain_core.cuh").write_text(header)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{d}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    i64, p = ctypes.c_longlong, ctypes.c_void_p
    so.hbt_core_walk.argtypes = [p, i64, p, p, i64, i64, ctypes.c_int, p, p, p, i64,
                                 ctypes.c_int]
    so.hbt_core_next.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_int]
    so.hbt_core_next.restype = ctypes.c_int
    so.hbt_core_plan.argtypes = [i64] * 3 + [p]
    return so


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("chain_core"), (CSRC / "chain_core.cuh").read_text())


GUARD = 4  # rows past n_rows that must keep their garbage


def _run_core(so, stream: np.ndarray, n: int, seg: int, slab: int, nsub: int, shift: int = 0,
              n_rows=None, nth: int = 3):
    """The core's walk of ``stream[:n]`` (bytes past ``n`` kept) placed
    ``shift`` bytes past a 16-byte address, the emit's rows written by
    ``nth`` threads: ``(offs, meta, info, keys, unmapped)``.  With
    ``n_rows`` the emit writes keys into arrays of garbage with a guard past
    them that must stay (else keys and unmapped are None)."""
    mem = np.zeros(len(stream) + 32, np.uint8)
    at = (-mem.ctypes.data) % 16 + shift
    mem[at : at + len(stream)] = stream
    offs = np.full(kch.offsets_capacity(n), -7, np.int64)
    meta = np.full(2, -7, np.int64)
    info = np.zeros(3, np.int64)
    keys = unm = None
    if n_rows is not None:
        keys = np.full(n_rows + GUARD, 0x5A5A5A5A5A5A5A5A, np.int64)
        unm = np.full(n_rows + GUARD, 0xA5, np.uint8)
    rc = so.hbt_core_walk(mem.ctypes.data + at, n, offs.ctypes.data, meta.ctypes.data, seg,
                          slab, nsub, info.ctypes.data, None if keys is None else keys.ctypes.data,
                          None if unm is None else unm.ctypes.data, n_rows or 0, nth)
    assert rc == 0
    if keys is not None:
        assert (keys[n_rows:] == 0x5A5A5A5A5A5A5A5A).all() and (unm[n_rows:] == 0xA5).all(), \
            "a key written past n_rows"
        keys, unm = keys[:n_rows], unm[:n_rows]
    return offs, meta, info, keys, unm


def _plain(stream: np.ndarray, n: int):
    return kch.record_chain(torch.from_numpy(stream.copy()), n)


def _differs(so, stream, n, seg, slab, nsub, shift=0, extra=3, nth=3):
    """Where the core and the plain versions disagree (``None`` if nowhere):
    offsets, ``[count, ok]``, and the keys and unmapped bytes of ``count +
    extra`` rows against ``stream_keys_plain``."""
    offs_p, meta_p = _plain(stream, n)
    count = int(meta_p[0])
    n_rows = max(count + extra, 0)
    offs, meta, _, keys, unm = _run_core(so, stream, n, seg, slab, nsub, shift, n_rows, nth)
    if meta.tolist() != meta_p.tolist():
        return f"[count, ok] {meta.tolist()} vs {meta_p.tolist()}"
    if not np.array_equal(offs[:count], offs_p[:count].numpy()):
        return "offsets"
    keys_p, unm_p = kch.stream_keys_plain(torch.from_numpy(stream.copy()), n, offs_p, meta_p,
                                          n_rows)
    if not np.array_equal(keys, keys_p.numpy()):
        return "keys"
    if not np.array_equal(unm, unm_p.numpy().astype(np.uint8)):
        return "unmapped"
    return None


#: (seg, slab, nsub): one segment a slab, several, and the map's strips in
#: one, two, four and eight sub-segments.
GEOMETRIES = [(64, 64, 1), (64, 256, 2), (128, 512, 4), (256, 1024, 8), (256, 256, 2),
              (512, 2048, 16)]
TROUBLE_NAMES = sorted(chip_smoke.chain_trouble_cases(7, 64, 64))


@functools.lru_cache(maxsize=None)
def _trouble(geom):
    return chip_smoke.chain_trouble_cases(7, geom[0], geom[1])


def test_plan_covers_the_stream_in_whole_segments(core):
    """The plan's table covers exactly the positions 0 .. n - 1 in whole
    segments, one slab's table at a time, and the workspace stays within 8
    bytes a position and 8 a head position of a slab."""
    out = np.zeros(4, np.int64)
    for n in (0, 1, 35, 36, 100, 512, 513, 10**6, 10**8, 9 * (4 + 2**28)):
        for seg, slab in [(512, 512), (512, 4096), (kch.SEG, kch.SLAB)]:
            core.hbt_core_plan(n, seg, slab, out.ctypes.data)
            segs, per_slab, slabs, work = out.tolist()
            assert segs == -(-n // seg)
            assert per_slab == max(1, min(segs, slab // seg))
            assert slabs == max(1, -(-segs // (slab // seg)))
            assert work <= 48 + 12 * per_slab + 8 * per_slab * (seg + min(seg // 8, 320))


def test_record_rule_sums_in_int32(core):
    """The rule the walk runs, at a segment's last offsets and the size
    word's edges, with the stream's end from the segment near 2^31 (and
    clamped to it): a step past the end goes to end + 1, a bad word or a
    position past the end is an error, the end itself ends the walk."""
    top = 2**31 - 1
    for i in (0, 1, 35, 65504, 65534, 65535):
        for n in (top, top - 1, 2**30, i + 36, i + 35, i + 4 + 2**28, i + 3 + 2**28, i + 1,
                  i, max(i - 1, 0), 0):
            for bs in (0, 31, 32, 33, 2**16, 2**28 - 1, 2**28, 2**28 + 1, 0x90000000,
                       0xFFFFFFFF):
                if i > n:
                    want = -1
                elif i == n:
                    want = -2
                elif not 32 <= bs <= 2**28:
                    want = -1
                else:
                    want = min(i + 4 + bs, n + 1)
                assert core.hbt_core_next(i, bs, n) == want, (i, n, bs)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[f"seg{g[0]}-slab{g[1]}-sub{g[2]}"
                                                  for g in GEOMETRIES])
@pytest.mark.parametrize("what", TROUBLE_NAMES)
def test_trouble_cases_match_plain(core, geom, what):
    """``chip_smoke.chain_trouble_cases`` built for each geometry: the walk's
    verdict is the case's, and the core's walk and keys are the plain
    versions', from a 16-byte address with three rows more than the walk
    finds, and from one 7 bytes past it with two rows fewer."""
    stream, n, ok = _trouble(geom)[what]
    for shift, extra, nth in ((0, 3, 3), (7, -2, 128)):
        assert _differs(core, stream, n, *geom, shift=shift, extra=extra, nth=nth) is None
    assert int(_plain(stream, n)[1][1]) == ok


@functools.lru_cache(maxsize=None)
def _reference(stream_bytes: bytes, n: int):
    """The JAX package's ``keys_from_stream_device(..., interpret=True)``
    (its Pallas chain kernel and XLA key gather) of ``stream[:n]``: packed
    keys, unmapped, count and ok."""
    s = np.frombuffer(stream_bytes, np.uint8)[:n]
    hi, lo, unm, count, ok = jdecode.keys_from_stream_device(s, n, interpret=True)
    return (pack_keys_np(np.asarray(hi), np.asarray(lo)), np.asarray(unm).astype(np.uint8),
            int(count), bool(ok))


def _against_reference(so, stream, n, seg, slab, nsub, shift=0):
    """The core's walk and keys against the reference's, under the rule of
    ``test_walk_matches_reference_across_chunks`` (after a bad size word the
    reference resumes at its next chunk, so its count means something only
    when the walk is ok), on the rows whose key fields lie inside ``n``:
    the reference's gather clamps a read past its array where the walk reads
    0."""
    want, want_unm, j_count, j_ok = _reference(stream.tobytes(), n)
    offs_p, meta_p = _plain(stream, n)
    count = int(meta_p[0])
    offs, meta, _, keys, unm = _run_core(so, stream, n, seg, slab, nsub, shift, count)
    assert bool(meta[1]) == j_ok
    if j_ok:
        assert int(meta[0]) == j_count
    inside = offs[:count] + 20 <= n
    np.testing.assert_array_equal(keys[inside], want[:count][inside])
    np.testing.assert_array_equal(unm[inside], want_unm[:count][inside])


@pytest.mark.parametrize("geom", GEOMETRIES[:4],
                         ids=[f"seg{g[0]}-slab{g[1]}" for g in GEOMETRIES[:4]])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_keys_cases_match_plain(core, small_chunks, case, geom):
    """The six streams of ``test_torch_chain_keys.py`` (real BAM records:
    clean, truncated, a size word below 32 and one above 2^28, three
    trailing bytes, empty): the walk and its keys equal the plain versions
    and the reference's keys."""
    s = CASES[case]
    assert _differs(core, s, len(s), *geom, shift=3) is None
    _against_reference(core, s, len(s), *geom, shift=3)


@pytest.fixture
def small_chunks(monkeypatch):
    # Tiny chunks: records straddle the reference's chunks, and its
    # interpret-mode walk stays short.
    monkeypatch.setattr(jchain, "CHUNK", 4096)
    monkeypatch.setattr(jchain, "MAX_REC_PER_CHUNK", 256)


@pytest.mark.parametrize("what", ["varied lengths, records past a segment",
                                  "a false chain inside a long read",
                                  "block_size 31 in a middle segment",
                                  "block_size 268435456 in a short stream",
                                  "3 trailing bytes reading 32",
                                  "records in a segment's last 1-36 bytes",
                                  "n_bytes 10 bytes into the last record"])
def test_core_matches_the_reference(core, small_chunks, what):
    """A few trouble cases against the JAX package's Pallas kernel in
    interpret mode and its key gather (``keys_from_stream_device``), under
    the rule of ``test_walk_matches_reference_across_chunks``: after a bad
    size word the reference resumes at its next chunk, so its count means
    something only when the walk is ok; ok, the offsets up to the core's
    count and their keys agree."""
    stream, n, ok = _trouble((128, 512, 4))[what]
    offs, meta, _, _, _ = _run_core(core, stream, n, 128, 512, 4)
    j_offs, j_count, j_ok = jchain.record_chain_device(stream[:n], interpret=True)
    count = int(meta[0])
    assert bool(meta[1]) == bool(j_ok) == bool(ok)
    if ok:
        assert count == int(j_count)
    np.testing.assert_array_equal(offs[:count], np.asarray(j_offs)[:count])
    _against_reference(core, stream, n, 128, 512, 4)


def test_hops_skip_segments_a_record_jumps(core):
    """A record longer than four segments: the segments it passes get no
    entry, and the hop reads fewer exits than the segments entered."""
    rng = np.random.default_rng(3)
    buf = chip_smoke.bam_records(rng, [40] * 10 + [64 * 4 + 50] + [40] * 10)
    offs = chip_smoke.chain_starts(buf)  # the chain positions, its end (n, in segment 17) included
    stream = np.frombuffer(buf, np.uint8)
    _, meta, info, _, _ = _run_core(core, stream, len(buf), 64, 1024, 1)
    assert meta.tolist() == [21, 1]
    assert info[0] == -(-len(buf) // 64) == 18
    assert info[2] == len({o // 64 for o in offs}) == 14  # segments 7-10 not entered
    assert 0 < info[1] < info[2]


def test_group_exits_cross_a_group_of_segments(core):
    """Minimal records enter every segment at its first positions: each hop
    step crosses a group of 32 segments."""
    buf = chip_smoke.bam_records(np.random.default_rng(4), [36] * 4096)
    _, meta, info, _, _ = _run_core(core, np.frombuffer(buf, np.uint8), len(buf), 512, 1 << 20,
                                    4)
    assert meta.tolist() == [4096, 1]
    assert info[2] == info[0] == 288
    assert info[1] == 288 // 32


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_fail(tmp_path, name):
    """Each mutation of the core makes it differ from the plain version on
    the trouble cases or the chain-keys streams."""
    src = (CSRC / "chain_core.cuh").read_text()
    old, new = MUTATIONS[name]
    assert src.count(old) == 1, f"mutation site of {name} not found"
    so = _build(tmp_path, src.replace(old, new))
    cases = [c[:2] for g in GEOMETRIES[:4] for c in _trouble(g).values()]
    cases += [(s, len(s)) for s in CASES.values()]
    bad = [k for k, (stream, n) in enumerate(cases) for g in GEOMETRIES[:4]
           if _differs(so, stream, n, *g) is not None]
    assert bad, name


def _fuzz_case(data):
    seg, nsub = data.draw(st.sampled_from([(64, 1), (64, 2), (128, 2), (128, 4), (256, 4),
                                           (256, 8)]))
    slab = seg * data.draw(st.sampled_from([1, 2, 3, 8, 64]))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    lengths = []
    for _ in range(data.draw(st.integers(0, 60))):
        kind = data.draw(st.sampled_from(["min", "short", "short", "long", "long", "huge"]))
        lengths.append(36 if kind == "min" else int(rng.integers(36, 200)) if kind == "short"
                       else int(rng.integers(seg // 2, 4 * seg)) if kind == "long"
                       else int(rng.integers(60_000, 70_000)))
    buf = bytearray(chip_smoke.bam_records(rng, lengths))
    offs = chip_smoke.chain_starts(bytes(buf))[:-1]
    if offs and data.draw(st.booleans()):
        at = offs[data.draw(st.integers(0, len(offs) - 1))]
        word = data.draw(st.sampled_from([0, 7, 31, 32, 33, 2**16, 2**28 - 1, 2**28, 2**28 + 1,
                                          0x90000000, int(rng.integers(0, 2**32))]))
        struct.pack_into("<I", buf, at, word)
    if data.draw(st.booleans()):
        buf += rng.integers(0, 256, data.draw(st.integers(1, 40)), dtype=np.uint8).tobytes()
    n = len(buf)
    n = data.draw(st.sampled_from([n, n, max(0, n - data.draw(st.integers(0, 100)))]))
    return np.frombuffer(bytes(buf), np.uint8), n, seg, slab, nsub


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_streams_match_plain(core, data):
    """Records of 36 bytes to four segments and of 60-70 KB (exits past a
    table word's reach), segments of 64-256 bytes in one
    to eight sub-segments, slabs of one to 64 segments, at most one size
    word set to an edge or a random value, random trailing bytes, and
    ``n_bytes`` at the stream's end or before it (bytes past it kept); the
    keys of a few rows more or fewer than the walk finds, written by 1-130
    threads."""
    stream, n, seg, slab, nsub = _fuzz_case(data)
    assert _differs(core, stream, n, seg, slab, nsub, shift=data.draw(st.integers(0, 15)),
                    extra=data.draw(st.integers(-3, 3)),
                    nth=data.draw(st.sampled_from([1, 3, 32, 130]))) is None


@settings(max_examples=20, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_keys_match_the_reference(core, small_chunks, data):
    """Fuzzed streams as above, without the 60-70 KB records (the
    reference's interpret-mode walk stays short): the core's walk and keys
    against the JAX package's ``keys_from_stream_device(...,
    interpret=True)``."""
    stream, n, seg, slab, nsub = _fuzz_case(data)
    if n > 20_000:
        return
    _against_reference(core, stream, n, seg, slab, nsub, shift=data.draw(st.integers(0, 15)))
