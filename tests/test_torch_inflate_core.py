"""The inflate kernel's decoder core (``csrc/inflate_core.cuh``) on the CPU.

The core is the serial part of ``csrc/inflate.cu`` (bit window, table
build, root lookups with the long-code walk, tokens, verdicts) and the
warp's part written as lane-strided loops.  A small C++ driver, held here,
runs it one member at a time with one lane (so every copy and table fill
runs as a plain loop), built with ``g++ -O2 -shared -fPIC`` and bound with
ctypes.  It is held to ``inflate_members_plain`` (zlib): equal ``ok`` for
every member, equal ``n_out`` and bytes for every ``ok`` member.
Tolerance 0.  Skips where there is no ``g++``."""

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
from hadoop_bam_tpu.ops import flate as jflate
from hadoop_bam_tpu_torch.ops.kernels import inflate as kin
from test_torch_inflate import CORPUS

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"

DRIVER = r"""
#include <stdlib.h>
#include "inflate_core.cuh"
using namespace hbt_inflate;

// inflate_members on the host: member i's stream at comp + comp_off[i],
// its output to out + out_off[i], through a ring of kWin bytes laid as the
// kernel lays its shared one (at the address of out + out_off[i] modulo 16).
extern "C" int hbt_core_inflate(const uint8_t* comp, const int64_t* comp_off,
                                const int32_t* clens, const int64_t* out_off,
                                const int32_t* isizes, uint8_t* out, int32_t* meta,
                                int64_t n) {
  Shared* sh = static_cast<Shared*>(aligned_alloc(16, (sizeof(Shared) + 15) & ~size_t(15)));
  uint8_t* buf = static_cast<uint8_t*>(aligned_alloc(16, kWin + 16));
  if (!sh || !buf) return 1;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* dst = out + out_off[i];
    uint8_t* ring = buf + (reinterpret_cast<uintptr_t>(dst) & 15);
    const Result r = run_member(sh, ring, dst, comp + comp_off[i], clens[i], isizes[i], 0, 1);
    meta[2 * i] = r.n_out;
    meta[2 * i + 1] = r.ok;
  }
  free(sh);
  free(buf);
  return 0;
}

extern "C" unsigned hbt_core_entry(int alpha, int sym) { return symbol_entry(alpha, sym, 0); }
extern "C" int hbt_core_clc_order(int k) { return clc_order(k); }
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the inflate core on the host")
    d = tmp_path_factory.mktemp("inflate_core")
    (d / "driver.cpp").write_text(DRIVER)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{CSRC}",
                    "-o", str(lib), str(d / "driver.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.hbt_core_inflate.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
    so.hbt_core_entry.restype = ctypes.c_uint
    return so


def _pack(comps, isizes):
    clens = np.asarray([len(c) for c in comps], np.int32)
    comp_off = np.zeros(len(comps), np.int64)
    comp_off[1:] = np.cumsum(clens[:-1])
    isz = np.asarray(isizes, np.int32)
    out_off = np.zeros(len(comps), np.int64)
    out_off[1:] = np.cumsum(isz[:-1].astype(np.int64))
    blob = np.frombuffer(b"".join(comps) + b"\0" * kin.COMP_PAD, np.uint8).copy()
    return blob, comp_off, clens, out_off, isz


def _both(core, comps, isizes):
    """``(core meta, core out, plain meta, plain out, out_off)``."""
    blob, comp_off, clens, out_off, isz = _pack(comps, isizes)
    out = np.zeros(int(isz.sum()) + 1, np.uint8)
    meta = np.zeros((len(comps), 2), np.int32)
    assert core.hbt_core_inflate(*(a.ctypes.data for a in (blob, comp_off, clens, out_off, isz,
                                                           out, meta)), len(comps)) == 0
    p_out = torch.zeros(len(out), dtype=torch.uint8)
    t = torch.from_numpy
    p_meta = kin.inflate_members_plain(t(blob), t(comp_off), t(clens), t(out_off), t(isz), p_out)
    return meta, out, p_meta.numpy(), p_out.numpy(), out_off


def _assert_same(core, comps, isizes):
    meta, out, p_meta, p_out, out_off = _both(core, comps, isizes)
    assert np.array_equal(meta[:, 1], p_meta[:, 1])
    for i in np.nonzero(p_meta[:, 1])[0]:
        o, n = int(out_off[i]), int(isizes[i])
        assert meta[i, 0] == p_meta[i, 0] == n
        assert out[o : o + n].tobytes() == p_out[o : o + n].tobytes()
    return meta


CORPUS_NAMES = sorted(CORPUS)
EDGE = {name: (comp, isize, payload)
        for name, comp, isize, payload in chip_smoke.inflate_edge_cases(7)}
EDGE_NAMES = sorted(EDGE)


@pytest.mark.parametrize("name", CORPUS_NAMES)
def test_corpus_member_matches_zlib(core, name):
    comp, isize, want = CORPUS[name]
    meta = _assert_same(core, [comp], [isize])
    assert bool(meta[0, 1]) == (want is not None)


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_edge_case_matches_zlib(core, name):
    """Codes past the root tables, lone codes, far (past the output ring)
    and overlapping copies, a 65,535-byte stored block, isize 65,536 and
    above, wrong isize: each alone, at offset 0 of the buffers."""
    comp, isize, want = EDGE[name]
    meta = _assert_same(core, [comp], [isize])
    assert bool(meta[0, 1]) == (want is not None)


def test_all_members_in_one_call(core):
    """Every member of both sets in one call: members at every alignment of
    the input and of the output against the ring's 16-byte writes to out."""
    comps = [CORPUS[n][0] for n in CORPUS_NAMES] + [EDGE[n][0] for n in EDGE_NAMES]
    isizes = [CORPUS[n][1] for n in CORPUS_NAMES] + [EDGE[n][1] for n in EDGE_NAMES]
    meta = _assert_same(core, comps, isizes)
    wants = [CORPUS[n][2] for n in CORPUS_NAMES] + [EDGE[n][2] for n in EDGE_NAMES]
    assert meta[:, 1].tolist() == [int(w is not None) for w in wants]


def test_symbol_tables_equal_the_reference(core):
    """The core's length and distance bases and extra bits (by formula) and
    the code-length order are the reference's tables."""
    entry = lambda alpha, sym: core.hbt_core_entry(alpha, sym)  # noqa: E731
    for k in range(29):
        e = entry(1, 257 + k)
        assert (e >> 8) & 7 == 1
        assert (e >> 16, (e >> 4) & 15) == (int(jflate.LEN_BASE[k]), int(jflate.LEN_EXTRA[k]))
    for k in range(30):
        e = entry(2, k)
        assert (e >> 16, (e >> 4) & 15) == (int(jflate.DIST_BASE[k]), int(jflate.DIST_EXTRA[k]))
    assert [(entry(1, s) >> 8) & 7 for s in (0, 255, 256, 286, 287)] == [0, 0, 2, 3, 3]
    assert [(entry(2, s) >> 8) & 7 for s in (30, 31)] == [3, 3]
    assert [core.hbt_core_clc_order(k) for k in range(19)] == [int(x) for x in jflate.CLC_ORDER]


def _fuzz_pool():
    rng = np.random.default_rng(11)
    pool = [(c, n) for c, n, p in CORPUS.values() if p is not None and len(c) < 4096]
    for lvl, size in ((1, 2000), (6, 2000), (9, 2000), (6, 40000)):
        p = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size))
        pool.append((zlib.compress(p, lvl)[2:-4], len(p)))
    for name in ("long_codes", "lone_dist_code", "len258_dist1"):
        pool.append(EDGE[name][:2])
    return pool


FUZZ_POOL = _fuzz_pool()


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_fuzzed_members_match_zlib(core, data):
    """Bit-flipped, byte-overwritten and truncated members, several to a
    call, with isize off by one at times."""
    comps, isizes = [], []
    for _ in range(data.draw(st.integers(1, 4))):
        comp, isize = FUZZ_POOL[data.draw(st.integers(0, len(FUZZ_POOL) - 1))]
        b = bytearray(comp)
        for bit in data.draw(st.lists(st.integers(0, 8 * len(b) - 1), max_size=3)):
            b[bit >> 3] ^= 1 << (bit & 7)
        if data.draw(st.booleans()):
            b[data.draw(st.integers(0, len(b) - 1))] = data.draw(st.integers(0, 255))
        cut = data.draw(st.integers(0, len(b)))
        if data.draw(st.booleans()):
            b = b[:cut]
        comps.append(bytes(b))
        isizes.append(isize + data.draw(st.sampled_from([0, 0, 0, -1, 1])))
    _assert_same(core, comps, [max(n, 0) for n in isizes])
