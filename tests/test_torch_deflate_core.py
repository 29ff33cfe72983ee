"""The deflate kernel's walk (``csrc/deflate_core.cuh``) on the CPU.

The core is the walk of ``csrc/deflate.cu``: a window of 32 positions a
step, candidates from the earlier lanes of a hash group or from the heads,
the first matching lane F, the head commit of the lanes up to F, the
warp-wide extension and the ring of output bits.  A small C++ harness, held
here, runs it one member at a time through one reused shared-memory buffer
(as a CTA's would be), the 32 lanes in lockstep; it is built with ``g++
-O2 -shared -fPIC`` and bound with ctypes.  The buffer holds garbage
outside each member's bytes, also right past its end, as shared memory
would.

It is held to ``deflate_members_plain`` on the same stream at tolerance 0:
rows (zero past clen), clens, ok, and the literal and copy counts of the
plain version's tokens; a few members also to the JAX package's
``deflate_lanes(..., interpret=True)``.  Two mutations of the core (the
candidates tried in the order c2, c1; the lane after F committed to the
heads) must each make it differ.  Skips where there is no ``g++``."""

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
from hadoop_bam_tpu.ops.pallas import deflate_lanes as jdl
from hadoop_bam_tpu_torch.ops.kernels import deflate as kd
from test_torch_deflate import _corpus

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"

HARNESS = r"""
#include <stdlib.h>
#include "deflate_core.cuh"
using namespace hbt_deflate;

// hbt_deflate_members on the host: member i through one shared-memory
// buffer (garbage outside the member), the 32 lanes in
// lockstep.  faults[i]: 1 if clen passed the row, 2 if the ring or the
// group slots were left dirty.
extern "C" int hbt_core_deflate(const uint8_t* stream, const int64_t* offs, const int32_t* lens,
                                int n, int hb, int stage_bytes, long long out_stride,
                                uint8_t* comp, int32_t* clens, int32_t* ok, int32_t* counts,
                                int32_t* faults) {
  const int H = 1 << hb;
  const size_t bytes = (4 * (2 * H + kRingWords) + stage_bytes + 15) & ~size_t(15);
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, bytes));
  if (!smem) return 1;
  memset(smem, 0xA5, bytes);
  uint32_t* heads = reinterpret_cast<uint32_t*>(smem);
  uint32_t* groups = heads + H;
  uint32_t* ring = groups + H;
  uint8_t* staged = reinterpret_cast<uint8_t*>(ring + kRingWords);
  for (int i = 0; i < n; ++i) {
    memset(heads, 0, 4 * (2 * H + kRingWords));
    const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(stream + offs[i]) & 15);
    memcpy(staged + lead, stream + offs[i], lens[i]);
    memset(staged + lead + lens[i], 0xA5, kReadPast);
    Warp q;
    init_lanes(q, 0);
    const Member m{reinterpret_cast<const uint32_t*>(staged), lead, lens[i], hb, heads, groups,
                   ring, comp + i * out_stride};
    Counts c;
    clens[i] = deflate_member(q, m, &c);
    ok[i] = 1;
    counts[3 * i] = c.literals;
    counts[3 * i + 1] = c.copies;
    counts[3 * i + 2] = c.windows;
    int dirty = 0;
    for (int k = 0; k < kRingWords; ++k) dirty += ring[k] != 0;
    for (int k = 0; k < H; ++k) dirty += groups[k] != 0;
    faults[i] = (clens[i] > out_stride) + 2 * (dirty != 0);
  }
  free(smem);
  return 0;
}

extern "C" void hbt_core_consts(int32_t* c) {
  c[0] = kReadPast;
  c[1] = kRingWords;
  c[2] = kMaxDist;
  c[3] = kMaxMatch;
}
"""

#: (what, the line of the core, what it becomes)
MUTATIONS = {
    "c2_before_c1": ("L.mpos = m1 ? c1 : c2;", "L.mpos = m2 ? c2 : c1;"),
    "commit_past_F": ("L.commit = L.hashes && L.id <= nlit;",
                      "L.commit = L.hashes && L.id <= nlit + 1;"),
}


def _build(d: Path, header: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the deflate core on the host")
    (d / "deflate_core.cuh").write_text(header)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{d}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.hbt_core_deflate.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 5
    so.hbt_core_consts.argtypes = [ctypes.c_void_p]
    return so


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("deflate_core"), (CSRC / "deflate_core.cuh").read_text())


def _stream(payloads, seed=0):
    """Payloads in one stream with random gaps (every lead mod 16 in play)."""
    rng = np.random.default_rng(seed)
    parts, offs, pos = [], [], 0
    for p in payloads:
        gap = int(rng.integers(0, 16))
        parts += [bytes(rng.integers(0, 256, gap, dtype=np.uint8)), p]
        offs.append(pos + gap)
        pos += gap + len(p)
    stream = np.frombuffer(b"".join(parts) + bytes(16), np.uint8).copy()
    return stream, np.array(offs, np.int64), np.array([len(p) for p in payloads], np.int32)


def _run_core(so, stream, offs, lens, hb, row):
    n = len(lens)
    mx = int(lens.max(initial=0))
    comp = np.zeros((n, row), np.uint8)
    clens, ok, faults = (np.zeros(n, np.int32) for _ in range(3))
    counts = np.zeros((n, 3), np.int32)
    rc = so.hbt_core_deflate(stream.ctypes.data, offs.ctypes.data, lens.ctypes.data, n, hb,
                             kd.stage_bytes(mx), row, comp.ctypes.data, clens.ctypes.data,
                             ok.ctypes.data, counts.ctypes.data, faults.ctypes.data)
    assert rc == 0
    return comp, clens, ok, counts, faults


def _differs(so, payloads, hb, seed=0):
    """Run the core and the plain version on ``payloads``; return the
    members where they differ (rows, clens, ok or token counts), after
    checking that the core's rows inflate and leave no fault."""
    stream, offs, lens = _stream(payloads, seed)
    row = kd.out_bytes(max(int(lens.max(initial=0)), 1)) + 3  # odd, as the part's stride
    comp, clens, ok, counts, faults = _run_core(so, stream, offs, lens, hb, row)
    t = torch.from_numpy
    pc, pl, po = (x.numpy() for x in kd.deflate_members_plain(t(stream), t(offs), t(lens), hb,
                                                             row))
    want = chip_smoke.token_counts(t(stream), t(offs), t(lens), hb)
    bad = [i for i in range(len(payloads))
           if not (np.array_equal(comp[i], pc[i]) and clens[i] == pl[i] and ok[i] == po[i]
                   and np.array_equal(counts[i, :2], want[i]))]
    return bad, (comp, clens, ok, counts, faults)


def _check(so, payloads, hb, seed=0):
    bad, (comp, clens, ok, counts, faults) = _differs(so, payloads, hb, seed)
    assert faults.tolist() == [0] * len(payloads)
    assert bad == []
    for i, p in enumerate(payloads):
        d = zlib.decompressobj(-15)
        assert d.decompress(comp[i, : clens[i]].tobytes()) == p and d.eof, i
        assert counts[i, 2] <= max(len(p), 1)  # a window advances at least one byte
    return comp, clens, counts


TROUBLE = chip_smoke.deflate_trouble_cases(7)
CORPUS = _corpus()
HBS = [8, 9, 10, 11]


def test_constants_equal_the_wrapper(core):
    c = np.zeros(4, np.int32)
    core.hbt_core_consts(c.ctypes.data)
    read_past, ring_words, max_dist, max_match = c.tolist()
    assert (max_dist, max_match) == (kd.MAX_DIST, kd.MAX_MATCH)
    # The staging the wrapper sizes covers the word reads past a member.
    assert kd.stage_bytes(kd.MAX_MEMBER) >= 15 + kd.MAX_MEMBER + read_past
    # A full-size member's CTA: heads, group slots and ring at hb = 11, the staged
    # payload; three of them (each with the 1 KiB the card reserves) fit an
    # SM's 228 KiB, four do not.
    smem = 4 * (2 * (1 << 11) + ring_words) + kd.stage_bytes(57_088)
    assert 3 * (smem + 1024) <= 233_472 < 4 * (smem + 1024)


@pytest.mark.parametrize("hb", HBS)
@pytest.mark.parametrize("what", sorted(TROUBLE))
def test_trouble_cases_match_plain(core, what, hb):
    """In-window collisions, short periods, tails in a window, distances
    32,768 and 32,769, copies to plen and of 258, members of 0-3 bytes."""
    _check(core, [TROUBLE[what]], hb)


@pytest.mark.parametrize("hb", HBS)
def test_all_trouble_cases_in_one_call(core, hb):
    """One buffer for every case: the heads, ring and staging of the last
    member are garbage to the next."""
    _check(core, list(TROUBLE.values()), hb, seed=hb)


def test_distance_edges_are_what_they_claim(core):
    """dist_32768 holds a copy at exactly 32,768; dist_32769 holds none
    that far, so its second block is literals."""
    _check(core, [TROUBLE["dist_32768"], TROUBLE["dist_32769"]], 11)
    for name, want in (("dist_32768", 1), ("dist_32769", 0)):
        p = TROUBLE[name]
        tok, ntok, _ = kd._match_waves(np.frombuffer(p, np.uint8), np.array([0]),
                                       np.array([len(p)]), 11)
        live = tok[0, : ntok[0]]
        far = ((live >> 30) & 1).astype(bool) & ((live & 0xFFFF) >= 32_700)
        assert int(far.sum()) == want, name
        assert int(((live & 0xFFFF) == 32_768)[far].sum()) == want


def test_empty_member_is_two_bytes(core):
    comp, clens, _ = _check(core, [b""], 11)
    assert clens.tolist() == [2] and comp[0, :2].tolist() == [3, 0]


@pytest.mark.parametrize("hb", HBS)
@pytest.mark.parametrize("what", sorted(CORPUS))
def test_deflate_corpus_matches_plain(core, what, hb):
    """The corpus of test_torch_deflate.py, member by member."""
    _check(core, [CORPUS[what]], hb)


def test_chip_smoke_corpus_matches_plain(core):
    """``chip_smoke.deflate_corpus``: full-size (57,088-byte) members of
    record bytes and random bytes, zero runs, a chain stream, and the
    trouble cases, in one call at the part's hash width."""
    payloads = chip_smoke.deflate_corpus(7)
    _, clens, counts = _check(core, payloads, kd.hash_bits(kd.round_up(0xDF00, kd.DEFAULT_CHUNK)))
    full = [i for i, p in enumerate(payloads) if len(p) == 0xDF00]
    assert len(full) == 3 and all(counts[i, 2] >= 0xDF00 // 32 for i in full)


def test_core_matches_the_reference_kernel(core):
    """A few members held to the JAX package's Pallas kernel in interpret
    mode, at the wrapper's geometry (P = 4,096, hb = 11)."""
    names = ["bam_like", "period_2", "long_match_258", "empty", "two_symbols"]
    payloads = [CORPUS[k] for k in names]
    P = max(len(p) for p in payloads)
    mat = np.zeros((len(payloads), P), np.uint8)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
    lens = np.array([len(p) for p in payloads], np.int32)
    jc, jl, jo = jdl.deflate_lanes(mat, lens, interpret=True)
    stream, offs, lens = _stream(payloads, 3)
    comp, clens, ok, _, faults = _run_core(core, stream, offs, lens, 11, jc.shape[1])
    assert faults.tolist() == [0] * len(payloads)
    assert clens.tolist() == np.asarray(jl).tolist() and ok.astype(bool).tolist() == np.asarray(jo).tolist()
    assert np.array_equal(comp, np.asarray(jc))


def test_max_clen_declines_on_the_core_clens(core):
    """The wrapper's max_clen decline (``ok &= clens <= max_clen``) acts
    on clens the core computes exactly as the plain version."""
    payloads = [bytes(np.random.default_rng(1).integers(0, 256, 300, dtype=np.uint8)),
                b"easy " * 60]
    _, clens, _ = _check(core, payloads, 11)
    mat = np.zeros((2, 300), np.uint8)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
    _, pl, po = kd.deflate_lanes(torch.from_numpy(mat), [300, 300], max_clen=100)
    assert pl.tolist() == clens.tolist()
    assert po.tolist() == (clens <= 100).tolist() == [False, True]


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_fail(tmp_path, name):
    """Each mutation of the core makes it differ from the plain version
    somewhere on the trouble cases and the corpus."""
    src = (CSRC / "deflate_core.cuh").read_text()
    old, new = MUTATIONS[name]
    assert src.count(old) == 1, f"mutation site of {name} not found"
    so = _build(tmp_path, src.replace(old, new))
    payloads = list(TROUBLE.values()) + list(CORPUS.values())
    assert any(_differs(so, payloads, hb)[0] for hb in HBS), name


def _fuzz_payload(data):
    n = data.draw(st.integers(0, 1200))
    k = data.draw(st.integers(1, 4))
    seed = data.draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    alpha = rng.choice(256, k, replace=False).astype(np.uint8)
    kind = data.draw(st.sampled_from(["random", "period", "period_flips"]))
    if kind == "random":
        return rng.choice(alpha, n).tobytes()
    period = data.draw(st.integers(1, 40))
    motif = rng.choice(alpha, period)
    p = np.resize(motif, n)
    if kind == "period_flips" and n:
        at = rng.integers(0, n, max(1, n // 50))
        p[at] = rng.choice(alpha, len(at))
    return p.tobytes()


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_members_match_plain(core, data):
    """Random sizes (0-1,200 bytes), alphabets of 1-4 symbols, periods of
    1-40 (clean or with a few flipped bytes), hb 8..11, one to three
    members a call."""
    payloads = [_fuzz_payload(data) for _ in range(data.draw(st.integers(1, 3)))]
    hb = data.draw(st.sampled_from(HBS))
    _check(core, payloads, hb, seed=data.draw(st.integers(0, 1000)))
