"""The lockstep-walk probe's core (``csrc/inflate_probe_core.cuh``) on the
CPU: the per-lane word ring, the window and the length class.

A small C++ harness, held here, runs the core's ``walk_lane`` for each of
the 128 lanes in turn, after the table is built by a block's threads as
loops (``build_table``).  The ring and the table start filled with garbage.
The asynchronous copies are emulated: a copy lands in its ring slot only
when the lane's wait lets its group land, so a read of a slot whose word has
not landed reads garbage or an older word.  Ring sizes of 2-4 words with
blocks of 1-3 waves and 0-2 groups in flight make short walks cross many
refills; the card's ring (32 words, blocks of 8 waves, 4 groups in flight)
runs too.  It is built with ``g++ -O2 -shared -fPIC`` and bound with ctypes.

It is held at tolerance 0 (every cursor and checksum as int32) to
``walk_plain``, to ``reference_walk`` and to the JAX package's
``make_walk(..., interpret=True)``, on ``chip_smoke.probe_cases``: lanes all
equal, spread over the stream, negative, at -1, -33, R * 32 - 1 and R * 32,
within 2**10 of INT32_MAX, lanes whose every wave advances 22 bits, and T =
0, 1 and odd Ts.  Three mutations (the ring read one word off; the
compares built with ``<=``; a wait that lets one group more be in flight)
must each make it differ.  Skips where there is no ``g++``."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from hadoop_bam_tpu.ops.pallas import inflate_probe as jip
from hadoop_bam_tpu_torch.ops.kernels import inflate_probe as kip

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"

HARNESS = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <vector>

// The asynchronous copies of one lane: a copy waits in its group until a
// wait lets the group land.
struct Pending {
  uint32_t* dst;
  uint32_t val;
  unsigned group;
};
static std::vector<Pending> g_pending;
static unsigned g_group;  // the open group's number

static void pr_copy(uint32_t* dst, const int32_t* src, unsigned n) {
  g_pending.push_back({dst, n ? static_cast<uint32_t>(*src) : 0u, g_group});
}

static void pr_wait(unsigned n) {
  size_t keep = 0;
  for (size_t i = 0; i < g_pending.size(); ++i) {
    if (g_pending[i].group + n < g_group) {
      *g_pending[i].dst = g_pending[i].val;
    } else {
      g_pending[keep++] = g_pending[i];
    }
  }
  g_pending.resize(keep);
}

#define HBT_PR_COPY(dst, src, n) pr_copy(dst, src, n)
#define HBT_PR_COMMIT() (++g_group)
#define HBT_PR_WAIT(n) pr_wait(n)

#include "inflate_probe_core.cuh"
using namespace hbt_probe;

static uint32_t g_seed = 12345;
static uint32_t garbage() {
  g_seed = g_seed * 1664525u + 1013904223u;
  return g_seed;
}

template <int K, int W, int D>
static int run(const int32_t* streams, int R, const int32_t* cursors, int T, int nth,
               int32_t* cur, int32_t* acc) {
  std::vector<uint8_t> tab(kTableBytes);
  for (auto& b : tab) b = static_cast<uint8_t>(garbage());
  for (int tid = 0; tid < nth; ++tid) build_table(tab.data(), tid, nth);
  std::vector<uint32_t> ring(static_cast<size_t>(K + 1) * kLanes);  // and the spare slot
  for (auto& w : ring) w = garbage();
  for (int lane = 0; lane < kLanes; ++lane) {
    g_group = 0;
    walk_lane<K, W, D>(streams + lane, R, static_cast<uint32_t>(cursors[lane]), T, tab.data(),
                       ring.data() + lane, kLanes, cur + lane, acc + lane);
    if (!g_pending.empty()) return 1;  // a copy still in flight at the lane's end
  }
  return 0;
}

// The ring geometries (K words, blocks of W waves, D groups in flight): the
// order of GEOMETRIES in the test.
extern "C" int hbt_core_walk(int geometry, const int32_t* streams, int R, const int32_t* cursors,
                             int T, int nth, int32_t* cur, int32_t* acc) {
  switch (geometry) {
    case 0: return run<2, 1, 1>(streams, R, cursors, T, nth, cur, acc);
    case 1: return run<2, 1, 0>(streams, R, cursors, T, nth, cur, acc);
    case 2: return run<3, 1, 2>(streams, R, cursors, T, nth, cur, acc);
    case 3: return run<3, 2, 0>(streams, R, cursors, T, nth, cur, acc);
    case 4: return run<4, 2, 1>(streams, R, cursors, T, nth, cur, acc);
    case 5: return run<4, 3, 0>(streams, R, cursors, T, nth, cur, acc);
    case 6: return run<8, 4, 1>(streams, R, cursors, T, nth, cur, acc);
    case 7: return run<32, 8, 4>(streams, R, cursors, T, nth, cur, acc);
  }
  return 2;
}

// The table as nth threads build it over garbage.
extern "C" void hbt_core_table(int nth, uint8_t* out) {
  for (int i = 0; i < kTableBytes; ++i) out[i] = static_cast<uint8_t>(garbage());
  for (int tid = 0; tid < nth; ++tid) build_table(out, tid, nth);
}
"""

#: (ring words K, waves a block W, groups in flight D), in the harness's
#: order; the card's ring last.
GEOMETRIES = [(2, 1, 1), (2, 1, 0), (3, 1, 2), (3, 2, 0), (4, 2, 1), (4, 3, 0), (8, 4, 1),
              (kip.RING, 8, 4)]

#: (what, the line of the core, what it becomes)
MUTATIONS = {
    "a block reads a group one block before it lands": (
        "HBT_PR_WAIT(D);", "HBT_PR_WAIT(D + 1);"),
    "the ring read one word off": (
        "const uint32_t x = ring[(nr % K) * stride];",
        "const uint32_t x = ring[((nr + 1) % K) * stride];"),
    "the compares built with <=": (
        "m |= static_cast<uint32_t>((rev >> (15 - L)) < bar + L) << (31 - L);",
        "m |= static_cast<uint32_t>((rev >> (15 - L)) <= bar + L) << (31 - L);"),
}

CASES = chip_smoke.probe_cases(0)


def _build(d: Path, header: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the probe core on the host")
    (d / "inflate_probe_core.cuh").write_text(header)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{d}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    return _bind(lib)


def _bind(lib):
    so = ctypes.CDLL(str(lib))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    so.hbt_core_walk.argtypes = [i32, p, i32, p, i32, i32, p, p]
    so.hbt_core_table.argtypes = [i32, p]
    so.hbt_core_table.restype = None
    return so


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    d = tmp_path_factory.mktemp("inflate_probe_core")
    return _build(d, (CSRC / "inflate_probe_core.cuh").read_text())


def _core_walk(so, streams, cursors, T: int, geometry: int, nth: int = 128):
    streams = np.ascontiguousarray(streams, np.int32)
    cursors = np.ascontiguousarray(cursors, np.int32)
    cur = np.empty((1, kip.LANES), np.int32)
    acc = np.empty((1, kip.LANES), np.int32)
    assert so.hbt_core_walk(geometry, streams.ctypes.data, streams.shape[0], cursors.ctypes.data,
                            T, nth, cur.ctypes.data, acc.ctypes.data) == 0
    return cur, acc


def _plain(streams, cursors, T: int):
    cur, acc = kip.walk_plain(torch.from_numpy(streams), torch.from_numpy(cursors), T)
    return cur.numpy(), acc.numpy()


def _i32(a) -> np.ndarray:
    return ((np.asarray(a, np.int64) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _ref_table() -> np.ndarray:
    """L + (rev & 7) for every 15-bit rev, by the reference's compares."""
    rev = np.arange(1 << 15)
    L = np.full_like(rev, 15)
    for n in range(15, 0, -1):
        L = np.where((rev >> (15 - n)) < ((rev >> 7) & 0x7F) + n, n, L)
    return (L + (rev & 7)).astype(np.uint8)


@pytest.fixture(scope="module")
def plain_of():
    return {name: _plain(*case) for name, case in CASES.items()}


# ---------------------------------------------------------------------------
# Tests.


@pytest.mark.parametrize("nth", [1, 7, 32, 128])
def test_table_is_the_reference_class(core, nth):
    """Every entry of the table, built over garbage by nth threads, is the
    reference's length class plus the window's low 3 bits."""
    got = np.empty(1 << 15, np.uint8)
    core.hbt_core_table(nth, got.ctypes.data)
    assert np.array_equal(got, _ref_table())


def test_the_length_class_takes_two_values():
    """The reference's compares give L = 15 exactly where bit 14 of the
    window is set and bits 7-13 are clear, and L = 1 everywhere else: the
    probe's class is cheap by accident of its constants, so the kernel reads
    it from a table as a decoder's class would be read."""
    rev = np.arange(1 << 15)
    length = _ref_table().astype(np.int64) - (rev & 7)
    assert np.array_equal(length, np.where((rev & 0x7F80) == 0x4000, 15, 1))


@pytest.mark.parametrize("geometry", range(len(GEOMETRIES)),
                         ids=[f"K{k}-W{w}-D{d}-table" for k, w, d in GEOMETRIES])
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_plain_and_oracle(core, plain_of, case, geometry):
    """Every lane's cursor and checksum are the plain version's and the
    NumPy oracle's."""
    streams, cursors, T = CASES[case]
    cur, acc = _core_walk(core, streams, cursors, T, geometry)
    p_cur, p_acc = plain_of[case]
    assert np.array_equal(cur, p_cur) and np.array_equal(acc, p_acc)
    c_ref, a_ref = kip.reference_walk(streams, cursors, T)
    assert np.array_equal(cur, _i32(c_ref)) and np.array_equal(acc, _i32(a_ref))


@pytest.mark.parametrize("case", ["all lanes equal", "-1, -33, R * 32 - 1, R * 32",
                                  "within 2**10 of INT32_MAX", "T = 1", "T = 13"])
def test_walk_matches_the_reference(core, case):
    """The JAX package's ``make_walk`` in interpret mode gives the same
    cursors and checksums as the core at the card's ring and a 2-word one."""
    streams, cursors, T = CASES[case]
    j_cur, j_acc = jip.make_walk(streams.shape[0], T, interpret=True)(jnp.asarray(streams),
                                                                      jnp.asarray(cursors))
    for geometry in (0, len(GEOMETRIES) - 1):
        cur, acc = _core_walk(core, streams, cursors, T, geometry)
        assert np.array_equal(cur, np.asarray(j_cur)) and np.array_equal(acc, np.asarray(j_acc))


def test_thousands_of_waves_cross_the_stream(core):
    """A long walk over a short stream: the lanes enter it from below, cross
    it and leave it, with many refills of the card's ring."""
    rng = np.random.default_rng(2)
    streams = rng.integers(-(1 << 31), 1 << 31, (64, kip.LANES), dtype=np.int32)
    cursors = rng.integers(-3000, 64 * 32, (1, kip.LANES), dtype=np.int32)
    want = kip.reference_walk(streams, cursors, 2500)
    for geometry in (0, 5, 6, len(GEOMETRIES) - 1):
        cur, acc = _core_walk(core, streams, cursors, 2500, geometry)
        assert np.array_equal(cur, _i32(want[0])) and np.array_equal(acc, _i32(want[1]))


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_fail(tmp_path, name):
    """Each mutation of the core makes it differ on the cases at some
    geometry."""
    src = (CSRC / "inflate_probe_core.cuh").read_text()
    old, new = MUTATIONS[name]
    assert src.count(old) == 1, f"mutation site of {name} not found"
    so = _build(tmp_path, src.replace(old, new))
    found = any(
        not np.array_equal(_core_walk(so, *CASES[c], g)[1], _plain(*CASES[c])[1])
        for g in range(len(GEOMETRIES)) for c in ("lanes over the whole stream",
                                                  "every wave advancing 22 bits"))
    assert found, name


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_walks_match_the_oracle(core, data):
    """Random streams, cursors, T and geometries; the same examples on every
    run."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    R = data.draw(st.sampled_from([1, 2, 5, 64, 300]))
    streams = rng.integers(-(1 << 31), 1 << 31, (R, kip.LANES), dtype=np.int32)
    lo = data.draw(st.sampled_from([-(2**31), -5000, 0, 2**31 - 3000]))
    cursors = rng.integers(lo, min(lo + 2 * R * 32 + 6000, 2**31), (1, kip.LANES),
                           dtype=np.int64).astype(np.int32)
    T = data.draw(st.integers(0, 200))
    geometry = data.draw(st.integers(0, len(GEOMETRIES) - 1))
    nth = data.draw(st.sampled_from([1, 32, 128]))
    cur, acc = _core_walk(core, streams, cursors, T, geometry, nth)
    c_ref, a_ref = kip.reference_walk(streams, cursors, T)
    assert np.array_equal(cur, _i32(c_ref)) and np.array_equal(acc, _i32(a_ref))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a card: the kernel against the plain version on the cases above,
    exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run chip_smoke.py on the H100)")
    for name, (streams, cursors, T) in CASES.items():
        p_cur, p_acc = _plain(streams, cursors, T)
        gs, gc = torch.from_numpy(streams).cuda(), torch.from_numpy(cursors).cuda()
        cur, acc = kip.make_walk(streams.shape[0], T, "cuda")(gs, gc)
        assert np.array_equal(cur.cpu().numpy(), p_cur), name
        assert np.array_equal(acc.cpu().numpy(), p_acc), name
