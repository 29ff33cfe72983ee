"""The BCF chain kernel's walk (``csrc/bcf_chain_core.cuh``) on the CPU.

The core is the walk of ``csrc/bcf_chain.cu``: the map (each position's
exit and count in a segment: links, the sub-segments' strips walked
backward, the sub-segments joined), the hop through the tables from
``start`` with the carry between slabs, and the emit (the re-walk of each
entered segment and its rows).  A small C++ harness, held here, runs the
phases in the kernels' order with each block's threads as loops, through a
workspace and a shared-memory buffer filled with garbage; it is built with
``g++ -O2 -shared -fPIC`` and bound with ctypes.  Segments are tiny here
(64-256 bytes, slabs of a few segments) so that small payloads cross many
boundaries.

It is held at tolerance 0 to ``walk_chain_plain`` (columns ``[:count]``,
count, ok) on ``chip_smoke.bcf_trouble_cases``, the walk cases of
``test_torch_variants.py`` and a hypothesis fuzz, and on a few cases to the
JAX package's ``walk_chain_host`` and ``walk_chain_device(...,
interpret=True)``.  Two mutations (the hop taking each segment's first
framing-valid position as its entry; the map counting the record at a
failing position) must each make it differ.  Skips where there is no
``g++``."""

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
from hadoop_bam_tpu.ops.pallas import bcf_chain as jchain
from hadoop_bam_tpu_torch.ops.kernels import bcf_chain as kb
from test_torch_variants import _encode, _header_lines, _variant_lines, _walk_cases

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"

HARNESS = r"""
#include <stdlib.h>
#include <stdint.h>
namespace hbt_bcf { struct Walk; }
// Used by the guessing mutation only: the first position of the segment at
// seg0 whose framing holds, else cur.
int64_t hbt_guess_entry(const hbt_bcf::Walk& w, int64_t seg0, int64_t cur);
#include "bcf_chain_core.cuh"
using namespace hbt_bcf;

int64_t hbt_guess_entry(const Walk& w, int64_t seg0, int64_t cur) {
  const Frame f = frame(w, seg0);
  for (int32_t i = 0; i < w.seg && i <= f.last && seg0 + i + 8 <= w.n; ++i) {
    uint32_t ls, li;
    memcpy(&ls, w.s + seg0 + i, 4);
    memcpy(&li, w.s + seg0 + i + 4, 4);
    if (next_record(i, ls, li, f.n) >= 0) return seg0 + i;
  }
  return cur;
}

// hbt_bcf_chain_walk on the host: per slab, the map of each segment, the
// compose of each, the hop, the fill of each, the emit of each entered
// segment; block threads as loops.  info: segments, hops, segments entered.
extern "C" int hbt_core_walk(const uint8_t* s, long long n, long long start, long long limit,
                             int32_t* cols, long long cap, int64_t* meta, long long seg,
                             long long slab, int nsub, int64_t* info) {
  const Plan pl = make_plan(n, start, limit, seg, slab);
  const Walk w{s, n, start, limit, seg, pl.width, nsub, seg_shift(seg)};
  const size_t wb = (work_bytes(pl, seg) + 15) & ~size_t(15);
  uint8_t* work = static_cast<uint8_t*>(aligned_alloc(16, wb));
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, map_smem(seg)));
  if (!work || !smem) return 1;
  memset(work, 0xA5, wb);
  const Work t = carve(work, pl, seg);
  const int64_t spl = slab / seg;
  for (int64_t j = 0; j < pl.slabs; ++j) {
    const int64_t slab0 = start + j * slab;
    const int64_t left = pl.segs - j * spl;
    const int64_t segs = left < 0 ? 0 : left < spl ? left : spl;
    for (int64_t k = 0; k < segs; ++k) {
      memset(smem, 0xA5, map_smem(seg));
      uint32_t* lk = reinterpret_cast<uint32_t*>(smem);
      uint8_t* buf = smem + 4 * seg;
      const int64_t seg0 = slab0 + k * seg;
      const int lead = stage(w, seg0, buf, 0, 1);
      map_links(w, seg0, buf, lead, lk, 0, 1);
      for (int g = 0; g < nsub; ++g) map_strips(w, lk, g, 0, 1);
      map_join(w, lk, 0, 1);
      map_exits(w, seg0, buf, lead, lk, t.to + k * seg, t.rows + k * seg, 0, 1);
    }
    for (int64_t k = 0; k < segs; ++k) compose(w, slab0, segs, t, k, 0, 1);
    hop(w, slab0, segs, j == 0, t, meta, 0, 1);
    for (int64_t k = 0; k < segs; ++k) fill(w, slab0, t, k);
    for (int64_t k = 0; k < segs; ++k) info[2] += t.entry[k] >= 0;
    for (int64_t k = 0; k < segs; ++k) {
      if (t.entry[k] < 0) continue;
      memset(smem, 0xA5, emit_smem(seg));
      int32_t* starts = reinterpret_cast<int32_t*>(smem + stage_bytes(seg));
      const int64_t seg0 = slab0 + k * seg;
      const int lead = stage(w, seg0, smem, 0, 1);
      const int m = emit_walk(w, seg0, smem, lead, t.entry[k], starts);
      emit_rows(w, seg0, smem, lead, starts, m, t.base[k], cols, cap, 0, 1);
    }
  }
  info[0] = pl.segs;
  info[1] = t.carry->hops;
  free(work);
  free(smem);
  return 0;
}

extern "C" int hbt_core_next(int i, uint32_t ls, uint32_t li, int n) {
  return next_record(i, ls, li, n);
}

extern "C" void hbt_core_plan(long long n, long long start, long long limit, long long seg,
                              long long slab, int64_t* out) {
  const Plan pl = make_plan(n, start, limit, seg, slab);
  out[0] = pl.width;
  out[1] = pl.segs;
  out[2] = pl.per_slab;
  out[3] = pl.slabs;
  out[4] = work_bytes(pl, seg);
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
    "map_counts_the_failing_record": (
        "static_cast<uint16_t>((v >> 16) + (e >= 0))",
        "static_cast<uint16_t>((v >> 16) + (e != kEnd))"),
}


def _build(d: Path, header: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the BCF chain core on the host")
    (d / "bcf_chain_core.cuh").write_text(header)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{d}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    i64, p = ctypes.c_longlong, ctypes.c_void_p
    so.hbt_core_walk.argtypes = [p, i64, i64, i64, p, i64, p, i64, i64, ctypes.c_int, p]
    so.hbt_core_next.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
    so.hbt_core_next.restype = ctypes.c_int
    so.hbt_core_plan.argtypes = [i64] * 5 + [p]
    return so


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("bcf_chain_core"),
                  (CSRC / "bcf_chain_core.cuh").read_text())


def _run_core(so, buf: bytes, start: int, limit: int, seg: int, slab: int, nsub: int,
              shift: int = 0):
    """The core's walk of ``buf`` placed ``shift`` bytes past a 16-byte
    address: ``(cols, meta, info)``."""
    cap = kb.capacity(start, limit)
    mem = np.zeros(len(buf) + 32, np.uint8)
    at = (-mem.ctypes.data) % 16 + shift
    mem[at : at + len(buf)] = np.frombuffer(buf, np.uint8)
    cols = np.full((7, cap), -7, np.int32)
    meta = np.full(2, -7, np.int64)
    info = np.zeros(3, np.int64)
    rc = so.hbt_core_walk(mem.ctypes.data + at, len(buf), start, limit, cols.ctypes.data, cap,
                          meta.ctypes.data, seg, slab, nsub, info.ctypes.data)
    assert rc == 0
    return cols, meta, info


def _differs(so, buf, start, limit, seg, slab, nsub, shift=0):
    """Where the core and the plain version disagree (``None`` if nowhere)."""
    cols, meta, info = _run_core(so, buf, start, limit, seg, slab, nsub, shift)
    cols_p, meta_p = kb.walk_chain_device(torch.from_numpy(np.frombuffer(buf, np.uint8).copy()),
                                          start, limit)
    count = int(meta_p[0])
    if meta.tolist() != meta_p.tolist():
        return f"[count, ok] {meta.tolist()} vs {meta_p.tolist()}"
    if not np.array_equal(cols[:, :count], cols_p[:, :count].numpy()):
        return "columns"
    return None


def _check(so, buf, start, limit, seg, slab, nsub, shift=0):
    assert _differs(so, buf, start, limit, seg, slab, nsub, shift) is None
    return kb.walk_chain_device(torch.from_numpy(np.frombuffer(buf, np.uint8).copy()),
                                start, limit)[1].tolist()


#: (seg, slab, nsub): one segment a slab, several, and the map's strips in
#: one, two, four and eight sub-segments.
GEOMETRIES = [(64, 64, 1), (64, 256, 2), (128, 512, 4), (256, 1024, 8), (256, 256, 2),
              (512, 2048, 16)]
TROUBLE_NAMES = sorted(chip_smoke.bcf_trouble_cases(7, 64, 64))


@functools.lru_cache(maxsize=None)
def _trouble(geom):
    return chip_smoke.bcf_trouble_cases(7, geom[0], geom[1])


def test_plan_covers_the_window_within_eight_bytes_a_position(core):
    """The plan's table covers exactly the positions that can start a
    record (``p + 8 <= limit`` and ``p <= n``) in whole segments, one slab's
    table at a time, and the workspace stays within 8 bytes a position of a
    slab."""
    out = np.zeros(5, np.int64)
    for n, start, limit in [(0, 0, 0), (0, 0, 8), (100, 0, 100), (100, 50, 20), (100, 3, 10**9),
                            (10**6, 17, 10**6 - 5), (10**6, 10**6 + 3, 10**6 + 20),
                            (10**8, 5, 10**8)]:
        for seg, slab in [(512, 512), (512, 4096), (kb.SEG, kb.SLAB)]:
            core.hbt_core_plan(n, start, limit, seg, slab, out.ctypes.data)
            width, segs, per_slab, slabs, work = out.tolist()
            assert width == len(range(start, min(limit - 8, n) + 1))
            assert (segs - 1) * seg < width <= segs * seg or segs == width == 0
            assert per_slab == max(1, min(segs, slab // seg))
            assert slabs == max(1, -(-segs // (slab // seg)))
            assert work <= 48 + 8 * per_slab * (seg + 1)


def test_record_rule_sums_in_int32(core):
    """The rule the walk runs, at a segment's last offsets and the length
    words' edges, with the payload's end from the segment near 2^31 (and
    clamped to it): i + 8 + l_shared + l_indiv stays in int32 and is
    compared with the end exactly."""
    top = 2**31 - 1
    big = 65535 + 8 + 2**24 - 1 + 2**28 - 1
    for i in (0, 1, 65504, 65534, 65535):
        for n in (top, top - 1, 2**30, big, big - 1, i + 8 + 24, i + 8 + 23, 0):
            for ls, li in ((24, 0), (24, 8), (2**24 - 1, 2**28 - 1), (2**24 - 1, 0),
                           (30, 2**28 - 1), (23, 0), (2**24, 0), (24, 2**28), (24, 0x90000000),
                           (0xFFFFFFFF, 0xFFFFFFFF)):
                framed = 24 <= ls < 2**24 and li < 2**28
                q = i + 8 + ls + li
                want = q if framed and q <= n else -1
                assert core.hbt_core_next(i, ls, li, n) == want, (i, n, ls, li)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[f"seg{g[0]}-slab{g[1]}-sub{g[2]}"
                                                  for g in GEOMETRIES])
@pytest.mark.parametrize("what", TROUBLE_NAMES)
def test_trouble_cases_match_plain(core, geom, what):
    """``chip_smoke.bcf_trouble_cases`` built for each geometry: the walk's
    verdict is the case's, and the core's walk is the plain version's, from
    a 16-byte address and from one 7 bytes past it."""
    buf, start, limit, ok = _trouble(geom)[what]
    for shift in (0, 7):
        assert _check(core, buf, start, limit, *geom, shift=shift)[1] == ok


@functools.lru_cache(maxsize=None)
def _corpus_payload(idx: bool):
    from hadoop_bam_tpu.io import bcf as jio
    from hadoop_bam_tpu.spec import vcf as jvcf

    vcf = jvcf.VcfHeader(_header_lines(idx))
    data = _encode(vcf, [jvcf.parse_variant_line(ln) for ln in _variant_lines(3 if idx else 1,
                                                                               180)])
    _, first = jio.read_bcf_header(data, True)
    payload, p, lim, _ = jio._inflate_range(data, first, len(data) << 16)
    return bytes(payload), chip_smoke.bcf_record_starts(bytes(payload), p)[:-1]


def _variant_cases():
    """The walk cases of ``test_torch_variants.py`` on both of its corpora."""
    return {(idx, case): c for idx in (False, True)
            for case, c in _walk_cases(*_corpus_payload(idx)).items()}


@pytest.mark.parametrize("geom", GEOMETRIES[:4],
                         ids=[f"seg{g[0]}-slab{g[1]}" for g in GEOMETRIES[:4]])
@pytest.mark.parametrize("idx", [False, True], ids=["plain", "idx"])
def test_variant_walk_cases_match_plain(core, idx, geom):
    for (i, case), (buf, start, limit) in _variant_cases().items():
        if i == idx:
            assert _differs(core, buf, start, limit, *geom) is None, case


@pytest.mark.parametrize("what", ["varied lengths, records past a segment",
                                  "a false chain inside a genotype block",
                                  "l_shared 7 in a middle segment", "limit at p + 8",
                                  "start and limit mid-payload, unaligned"])
def test_core_matches_the_reference(core, what):
    """A few trouble cases against the JAX package's host walk and its
    Pallas kernel in interpret mode."""
    buf, start, limit, ok = _trouble((128, 512, 4))[what]
    cols, meta, _ = _run_core(core, buf, start, limit, 128, 512, 4)
    count = int(meta[0])
    host = jchain.walk_chain_host(buf, start, limit)
    dev = jchain.walk_chain_device(buf, start, limit, interpret=True)
    assert count == int(host[7]) == int(dev[7])
    assert bool(meta[1]) == bool(host[8]) == bool(dev[8]) == bool(ok)
    for i in range(7):
        np.testing.assert_array_equal(cols[i, :count], np.asarray(host[i]))
        np.testing.assert_array_equal(cols[i, :count], np.asarray(dev[i])[:count])


def test_hops_skip_segments_a_record_jumps(core):
    """A record longer than four segments: the segments it passes get no
    entry, and the hop reads fewer exits than the segments entered."""
    rng = np.random.default_rng(3)
    buf = chip_smoke.bcf_records(rng, [40] * 10 + [64 * 4 + 50] + [40] * 10)
    offs = chip_smoke.bcf_record_starts(buf)  # the chain, its end (n, in segment 17) included
    _, meta, info = _run_core(core, buf, 0, len(buf), 64, 1024, 1)
    assert meta.tolist() == [21, 1]
    assert info[0] == -(-(len(buf) - 7) // 64) == 18
    assert info[2] == len({o // 64 for o in offs}) == 14  # segments 7-10 not entered
    assert 0 < info[1] < info[2]


def test_group_exits_cross_sixteen_segments(core):
    """Minimal records enter every segment at its first positions: each hop
    step crosses a group of 16 segments."""
    buf = chip_smoke.bcf_records(np.random.default_rng(4), [32] * 4096)
    _, meta, info = _run_core(core, buf, 0, len(buf), 256, 1 << 20, 2)
    assert meta.tolist() == [4096, 1]
    assert info[2] == info[0] == 512
    assert info[1] == 512 // 16


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_fail(tmp_path, name):
    """Each mutation of the core makes it differ from the plain version on
    the trouble cases or the variant corpora's walk cases."""
    src = (CSRC / "bcf_chain_core.cuh").read_text()
    old, new = MUTATIONS[name]
    assert src.count(old) == 1, f"mutation site of {name} not found"
    so = _build(tmp_path, src.replace(old, new))
    cases = [c[:3] for g in GEOMETRIES[:4] for c in _trouble(g).values()]
    cases += list(_variant_cases().values())
    bad = [k for k, (buf, start, limit) in enumerate(cases) for g in GEOMETRIES[:4]
           if _differs(so, buf, start, limit, *g) is not None]
    assert bad, name


def _fuzz_case(data):
    seg, nsub = data.draw(st.sampled_from([(64, 1), (64, 2), (128, 2), (128, 4), (256, 4),
                                           (256, 8)]))
    slab = seg * data.draw(st.sampled_from([1, 2, 3, 8, 64]))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    lengths = []
    for _ in range(data.draw(st.integers(0, 60))):
        kind = data.draw(st.sampled_from(["min", "short", "short", "long"]))
        lengths.append(32 if kind == "min" else int(rng.integers(32, 200)) if kind == "short"
                       else int(rng.integers(seg // 2, 4 * seg)))
    lead = data.draw(st.integers(0, 40))
    buf = bytearray(rng.integers(0, 256, lead, dtype=np.uint8).tobytes()
                    + chip_smoke.bcf_records(rng, lengths))
    offs = chip_smoke.bcf_record_starts(bytes(buf), lead)[:-1]
    if offs and data.draw(st.booleans()):
        at = offs[data.draw(st.integers(0, len(offs) - 1))] + 4 * data.draw(st.integers(0, 1))
        if at + 4 <= len(buf):
            word = data.draw(st.sampled_from([0, 7, 23, 24, 2**24 - 1, 2**24, 2**28 - 1, 2**28,
                                              0x90000000, int(rng.integers(0, 2**32))]))
            struct.pack_into("<I", buf, at, word)
    n = len(buf)
    start = data.draw(st.sampled_from([lead, lead] + offs[:5] + [data.draw(st.integers(0, n))]))
    limit = data.draw(st.sampled_from([n, n, n - data.draw(st.integers(0, 100)),
                                       n + data.draw(st.integers(0, 100)),
                                       start + data.draw(st.integers(0, 4 * seg))]))
    return bytes(buf), start, limit, seg, slab, nsub


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_windows_match_plain(core, data):
    """Records of 32 bytes to four segments, segments of 64-256 bytes in
    one to eight sub-segments, slabs of one to 64 segments, any start (on a
    record or not), limits around the payload's end or inside it, and at
    most one length word set to an edge or a random value."""
    buf, start, limit, seg, slab, nsub = _fuzz_case(data)
    assert _differs(core, buf, start, limit, seg, slab, nsub,
                    shift=data.draw(st.integers(0, 15))) is None
