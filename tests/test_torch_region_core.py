"""The overlap cut's core (``csrc/region_core.cuh``) on the CPU.

The core is the view's cut of ``csrc/region.cu``: from the raw columns
(refid, pos, reference length) and K intervals to the hit rows, compacted
and in order, with their count, in three phases (count: each thread's hit,
each warp's ballot word, the block's hits; scan: the blocks' hits before
each; scatter: each block scans its warps' counts and writes its rows).  A
small C++ harness, held here, runs the phases in the kernels' order with
each block's threads as loops (the ballot built from the warp's 32 hits),
blocks last first, shared memory, the workspace and the output filled with
garbage first and a guard past the last row that must stay; it is built
with ``g++ -O2 -shared -fPIC`` and bound with ctypes.  Blocks run from one
warp to 256 threads, the scan from one thread to 1,024.

It is held at tolerance 0 (the count and every row) to the plain version
``overlap_rows_plain``, to ``np.nonzero`` of the JAX package's
``ops.cigar.overlap_mask`` and to ``np.nonzero`` of its Pallas kernel
``ops.pallas.overlap.overlap_mask(..., interpret=True)`` on the refid,
start and end that kernel is given.  Three mutations (the end without
``max(ref_len, 1)``; a block's count dropping its last warp's hits; the
scan giving each block the hits up to and including its own, which shifts
the blocks) must each make it differ.  Skips where there is no ``g++``."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from hadoop_bam_tpu.ops import cigar as jcigar
from hadoop_bam_tpu.ops.pallas import overlap as jov
from hadoop_bam_tpu_torch.ops.kernels import overlap as kov

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"
GUARD = 5  # int32 past the last row that must keep their garbage
GARBAGE = -0x5A5A5A5B

HARNESS = r"""
#include <stdlib.h>
#include <stdint.h>
#include <string.h>
#include "region_core.cuh"
using namespace hbt_region;

// hbt_overlap_rows on the host: the count of each block, last first; the
// scan by nsc threads; the scatter of each block, last first.  Every
// block's shared memory, the hits and the workspace start as garbage.
extern "C" int hbt_core_rows(const int32_t* iv, int k, const int32_t* refid, const int32_t* pos,
                             const int32_t* len, long long n, int32_t* out, int nth, int nsc) {
  if (nth < 32 || nth > 32 * kMaxWarps || nth % 32 != 0) return 2;
  if (n == 0) {
    out[0] = 0;  // the C entry's memset
    return 0;
  }
  Cut c;
  c.iv = iv;
  c.k = k;
  c.refid = refid;
  c.pos = pos;
  c.len = len;
  c.n = n;
  c.nth = nth;
  const int64_t nb = blocks(c), nw = words(n);
  c.bits = static_cast<uint32_t*>(malloc(4 * nw));
  c.blk = static_cast<int32_t*>(malloc(4 * nb));
  c.out = out;
  int32_t* s_iv = static_cast<int32_t*>(malloc(4 * 3 * kOverlapChunk));
  uint8_t* hit = static_cast<uint8_t*>(malloc(nth));
  int32_t* part = static_cast<int32_t*>(malloc(4 * nsc));
  int32_t* tmp = static_cast<int32_t*>(malloc(4 * nsc));
  int32_t wc[kMaxWarps], woff[kMaxWarps];
  uint32_t word[kMaxWarps];
  if (!c.bits || !c.blk || !s_iv || !hit || !part || !tmp) return 1;
  memset(c.bits, 0xA5, 4 * nw);
  memset(c.blk, 0xA5, 4 * nb);
  for (int64_t b = nb - 1; b >= 0; --b) {
    memset(s_iv, 0xA5, 4 * 3 * kOverlapChunk);
    memset(wc, 0xA5, sizeof(wc));
    memset(hit, 0xA5, nth);
    count_block(c, b, s_iv, wc, hit);
  }
  memset(part, 0xA5, 4 * nsc);
  memset(tmp, 0xA5, 4 * nsc);
  scan_blocks(c.blk, nb, out, part, tmp, nsc);
  for (int64_t b = nb - 1; b >= 0; --b) {
    memset(word, 0xA5, sizeof(word));
    memset(woff, 0xA5, sizeof(woff));
    scatter_block(c, b, word, woff);
  }
  free(c.bits);
  free(c.blk);
  free(s_iv);
  free(hit);
  free(part);
  free(tmp);
  return 0;
}
"""

#: (what, the line of the core, what it becomes)
MUTATIONS = {
    "end_without_the_one_base_floor": (
        "static_cast<uint32_t>(ref_len > 1 ? ref_len : 1);",
        "static_cast<uint32_t>(ref_len);"),
    "count_drops_the_last_warp": (
        "for (int v = 0; v < nth / 32; ++v) s += wc[v];",
        "for (int v = 0; v + 1 < nth / 32; ++v) s += wc[v];"),
    "scan_shifts_the_blocks": (
        "      blk[j] = s;\n      s += v;",
        "      s += v;\n      blk[j] = s;"),
}


def _build(d: Path, header: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the overlap cut's core on the host")
    (d / "region_core.cuh").write_text(header)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{d}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    so.hbt_core_rows.argtypes = [p, ctypes.c_int, p, p, p, ctypes.c_longlong, p, ctypes.c_int,
                                 ctypes.c_int]
    return so


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("region_core"), (CSRC / "region_core.cuh").read_text())


def _run_core(so, iv, refid, pos, ln, nth: int = 256, nsc: int = 1024, guard: int = GUARD):
    """The core's cut: ``(rows, count)``, the guard past the rows checked."""
    n = len(refid)
    out = np.full(1 + n + guard, GARBAGE, np.int32)
    iv = np.ascontiguousarray(iv, np.int32).reshape(-1, 3)
    cols = [np.ascontiguousarray(a, np.int32) for a in (refid, pos, ln)]
    rc = so.hbt_core_rows(iv.ctypes.data, len(iv), *(a.ctypes.data for a in cols), n,
                          out.ctypes.data, nth, nsc)
    assert rc == 0
    assert (out[1 + n :] == GARBAGE).all(), "a row written past the last record"
    count = int(out[0])
    assert 0 <= count <= n
    return out[1 : 1 + count].copy(), count


def _plain(iv, refid, pos, ln):
    out = kov.overlap_rows_plain(*[torch.from_numpy(np.ascontiguousarray(a, np.int32))
                                   for a in (np.reshape(iv, (-1, 3)), refid, pos, ln)])
    count = int(out[0])
    assert not out[1 + count :].any()
    return out[1 : 1 + count].numpy(), count


def _cigar_rows(iv, refid, pos, ln):
    """``np.nonzero`` of the JAX package's jitted ``ops.cigar.overlap_mask``."""
    iv = np.reshape(iv, (-1, 3))
    if len(iv) == 0:
        return np.empty(0, np.int64)
    return np.nonzero(np.asarray(jcigar.overlap_mask(refid, pos, ln, iv[:, 0], iv[:, 1],
                                                      iv[:, 2])))[0]


def _pallas_rows(iv, refid, pos, ln):
    """``np.nonzero`` of the Pallas kernel in interpret mode on the refid,
    start and end it is given: the wrapped end, and refid -2 (no interval's)
    for a record with pos < 0."""
    end = ((pos.astype(np.int64) + np.maximum(ln, 1) + 2**31) % 2**32 - 2**31).astype(np.int32)
    rid = np.where(pos < 0, -2, refid).astype(np.int32)
    mask = jov.overlap_mask(np.reshape(iv, (-1, 3)).astype(np.int32), rid, pos, end,
                            interpret=True)
    return np.nonzero(np.asarray(mask))[0]


def _case(n: int, k: int, seed: int):
    """Records over refids -2..2 with unplaced starts (-1 and -5 among
    them), reference lengths -3..499 (0 and negative ones span one base) and
    starts near 2^31 - 1 whose ends wrap; K intervals over refids -1..2, one
    of them at the top of int32."""
    rng = np.random.default_rng(seed)
    refid = rng.integers(-2, 3, n).astype(np.int32)
    pos = rng.integers(-10, 20_000, n).astype(np.int32)
    ln = rng.integers(-3, 500, n).astype(np.int32)
    edge = [(0, -1, 5), (0, -5, 100), (0, 2**31 - 1, 0), (0, 2**31 - 10, 50), (1, 0, 0),
            (1, 7, -4), (0, 2**31 - 60, 10)]
    for j, (r, p, l) in enumerate(edge[: min(n, len(edge))]):
        refid[j], pos[j], ln[j] = r, p, l
    iv = np.zeros((k, 3), np.int32)
    iv[:, 0] = rng.integers(-1, 3, k)
    iv[:, 1] = rng.integers(-10, 18_000, k)
    iv[:, 2] = iv[:, 1] + rng.integers(0, 3_000, k)
    if k:
        iv[0] = [0, 2**31 - 100, 2**31 - 1]
    if k > 1:
        iv[1] = [0, -20, 10]  # would take pos -1 and -5 if they counted
    return iv, refid, pos, ln


def _lanes(n: int, hit):
    """Records on refid 0 at pos 100 (a hit of interval (0, 0, 1000)) where
    ``hit(i)``, else on refid 1."""
    refid = np.asarray([0 if hit(i) else 1 for i in range(n)], np.int32)
    return (np.asarray([[0, 0, 1000]], np.int32), refid, np.full(n, 100, np.int32),
            np.full(n, 10, np.int32))


CASES = {f"random n{n} k{k}": _case(n, k, 10 * n + k)
         for n, k in ((0, 1), (1, 1), (31, 2), (32, 2), (33, 1), (1000, 0), (1000, 1),
                      (2000, 2), (3000, 5), (700, 1500))}
CASES.update({
    "every lane": _lanes(1000, lambda i: True),
    "no lane": _lanes(1000, lambda i: False),
    "warp and block edges": _lanes(1100, lambda i: i % 32 in (0, 31) or i % 256 in (0, 255)),
    "one hit a block, the last": _lanes(1024, lambda i: i == 1023),
    "the last record only": _lanes(777, lambda i: i == 776),
    "odd lanes": _lanes(600, lambda i: i % 2 == 1),
    "one-base spans at an interval's start": (
        np.asarray([[0, 500, 600]], np.int32), np.zeros(300, np.int32),
        np.full(300, 500, np.int32), np.tile(np.asarray([0, -3, 1, 7, -1], np.int32), 60)),
})
GEOMETRIES = [(32, 1), (64, 3), (96, 32), (256, 1024)]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[f"t{g[0]}-scan{g[1]}" for g in GEOMETRIES])
@pytest.mark.parametrize("what", sorted(CASES))
def test_cases_match_plain(core, what, geom):
    """Every case at four geometries: the count and every row equal the
    plain version's."""
    iv, refid, pos, ln = CASES[what]
    rows, count = _run_core(core, iv, refid, pos, ln, *geom)
    want, want_count = _plain(iv, refid, pos, ln)
    assert count == want_count
    np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("what", sorted(CASES))
def test_cases_match_the_reference(core, what):
    """Every case against ``np.nonzero`` of the reference's jitted cigar op
    and of its Pallas kernel in interpret mode."""
    iv, refid, pos, ln = CASES[what]
    rows, count = _run_core(core, iv, refid, pos, ln)
    np.testing.assert_array_equal(rows, _cigar_rows(iv, refid, pos, ln))
    np.testing.assert_array_equal(rows, _pallas_rows(iv, refid, pos, ln))


def test_the_span_rule(core):
    """The rule on its own: unplaced starts never match; a 0 or negative
    length spans one base; an end past 2^31 - 1 wraps negative and matches
    nothing after it."""
    iv = np.asarray([[0, -100, 1000], [0, 2**31 - 20, 2**31 - 1]], np.int32)
    refid = np.zeros(8, np.int32)
    pos = np.asarray([-1, -5, 999, 1000, 999, 2**31 - 30, 2**31 - 30, 2**31 - 2], np.int32)
    ln = np.asarray([50, 50, 0, 5, -7, 9, 11, 5], np.int32)
    rows, count = _run_core(core, iv, refid, pos, ln, 32, 3)
    assert rows.tolist() == [2, 4, 6] and count == 3
    assert _plain(iv, refid, pos, ln)[0].tolist() == [2, 4, 6]
    assert _cigar_rows(iv, refid, pos, ln).tolist() == [2, 4, 6]
    iv = np.asarray([[0, 999, 1000]], np.int32)  # a record's one base is its start
    rows, count = _run_core(core, iv, refid, pos, ln, 32, 3)
    assert rows.tolist() == [2, 4] and count == 2
    assert _cigar_rows(iv, refid, pos, ln).tolist() == [2, 4]


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_fail(tmp_path, name):
    """Each mutation of the core makes it differ from the plain version on
    the cases."""
    src = (CSRC / "region_core.cuh").read_text()
    old, new = MUTATIONS[name]
    assert src.count(old) == 1, f"mutation site of {name} not found"
    so = _build(tmp_path, src.replace(old, new))
    bad = []
    for what, case in CASES.items():
        for geom in GEOMETRIES:
            try:  # a wide guard: a shifted row lands inside it
                rows, count = _run_core(so, *case, *geom, guard=4096)
            except AssertionError:
                bad.append((what, geom))
                continue
            want, want_count = _plain(*case)
            if count != want_count or not np.array_equal(rows, want):
                bad.append((what, geom))
    assert bad, name


@settings(max_examples=120, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_cuts_match_plain(core, data):
    """Records and intervals drawn around a few contigs and positions (dense
    hits and misses, unplaced starts, lengths -3..300, starts near the top
    of int32), N 0-3,000 and K 0-40, at block sizes of 1-8 warps and scans
    of 1-1,024 threads."""
    n = data.draw(st.integers(0, 3000))
    k = data.draw(st.integers(0, 40))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    top = data.draw(st.booleans())
    base = 2**31 - 2_000 if top else 0
    refid = rng.integers(-1, 3, n).astype(np.int32)
    pos = (base + rng.integers(-20, 1_500, n)).astype(np.int32)
    ln = rng.integers(-3, 300, n).astype(np.int32)
    iv = np.zeros((k, 3), np.int32)
    iv[:, 0] = rng.integers(-1, 3, k)
    iv[:, 1] = base + rng.integers(-50, 1_500, k)
    iv[:, 2] = (iv[:, 1].astype(np.int64) + rng.integers(0, 400, k)).clip(max=2**31 - 1)
    nth = 32 * data.draw(st.integers(1, 8))
    nsc = data.draw(st.sampled_from([1, 2, 7, 32, 33, 1024]))
    rows, count = _run_core(core, iv, refid, pos, ln, nth, nsc)
    want, want_count = _plain(iv, refid, pos, ln)
    assert count == want_count
    np.testing.assert_array_equal(rows, want)
