"""The literal-only inflate kernel's core (``csrc/inflate_fixed_core.cuh``) on the CPU.

The core is the walk of ``csrc/inflate_fixed.cu``: a member's stream read
in rounds of ``threads * seg`` bits (staged into two shared-memory
buffers), each thread's segment mapped from its 9 entry offsets (entry 0
in full with marks, the others until they meet its path), the maps composed
by a block scan (Kogge-Stone within each warp of 32 segments, the warps in
order) into each segment's true entry and the literals before it, the
literals emitted into a shared stage and stored to the row a 16-byte chunk
at a time, then the row's zero tail and the verdict.  A small C++ harness,
held here, runs ``inflate_member`` with the block's threads as loops, in the
kernel's order, with shared memory and the per-thread state filled with
garbage before each member, the output rows (and a guard past them) filled
with garbage, and the members taken last first, so that a write past a row
lands on a row already written.  It is built with ``g++ -O2 -shared -fPIC``
and bound with ctypes.  Segments are tiny here (32-128 bits) and blocks have
1-32 threads, so that short members cross many segments and rounds; the
card's default geometry (``inflate_fixed.SEG`` and ``THREADS``) runs too.

It is held at tolerance 0 to ``inflate_fixed_literal_plain`` (``ok`` and
every byte of every row) on ``chip_smoke.fixed_literal_trouble_cases`` and
``chip_smoke.fixed_literal_cases``' kinds, the cases of
``test_torch_inflate_fixed.py`` and a hypothesis fuzz, and on a few cases to
the JAX package's Pallas kernel (``inflate_fixed_literal(...,
interpret=True)``).  Two mutations (the map ignoring entry offset 8; the
emit writing past ISIZE) must each make it differ.  Skips where there is
no ``g++``."""

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
from test_torch_inflate_fixed import _lit, _rows

import chip_smoke
from hadoop_bam_tpu.ops.pallas.inflate_fixed import inflate_fixed_literal as jlit
from hadoop_bam_tpu_torch.ops import flate as tflate
from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed as kfix

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"

HARNESS = r"""
#include <stdlib.h>
#include <stdint.h>
#include "inflate_fixed_core.cuh"
using namespace hbt_fixed;

// hbt_inflate_fixed_literal on the host: one member at a time, last first,
// the block's nth threads as loops, shared memory and the threads' state
// filled with garbage before each member.
extern "C" int hbt_core_inflate(const uint8_t* comp, long long stride, const int32_t* clens,
                                const int32_t* isizes, long long n, uint8_t* out,
                                long long out_stride, uint8_t* ok, int seg, int nth) {
  const Geometry g = geometry(seg, nth);
  const size_t sb = (static_cast<size_t>(smem_bytes(seg, nth)) + 15) & ~size_t(15);
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, sb));
  Seg* segs = static_cast<Seg*>(malloc(sizeof(Seg) * nth));
  if (!smem || !segs) return 1;
  for (long long i = n - 1; i >= 0; --i) {
    memset(smem, 0xA5, sb);
    memset(segs, 0x5A, sizeof(Seg) * nth);
    const Layout L = carve(smem, g);
    const Member m{comp + i * stride, static_cast<int32_t>(stride),
                   member_bits(clens[i], stride), isizes[i], out + i * out_stride, out_stride};
    ok[i] = inflate_member<false>(m, g, L, segs, nullptr) ? 1 : 0;
  }
  free(segs);
  free(smem);
  return 0;
}

extern "C" long long hbt_core_smem(int seg, int nth) { return smem_bytes(seg, nth); }
"""

#: (what, the line of the core, what it becomes)
MUTATIONS = {
    "the map ignores entry offset 8": (
        "if (++e == kEntries) break;",
        "if (++e == kEntries - 1) break;"),
    "the emit writes past ISIZE": (
        "const int32_t lim = count < m.isize ? count : m.isize;",
        "const int32_t lim = count;"),
}

#: Garbage bytes past the last row that must stay as they are: more than a
#: round's literals at the largest geometry here, so that a write past ISIZE
#: lands in them and not outside the buffer.
GUARD = 8192


def _build(d: Path, header: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the inflate_fixed core on the host")
    (d / "inflate_fixed_core.cuh").write_text(header)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{d}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.hbt_core_inflate.argtypes = [p, i64, p, p, i64, p, i64, p, i32, i32]
    so.hbt_core_smem.argtypes = [i32, i32]
    so.hbt_core_smem.restype = i64
    return so


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("inflate_fixed_core"),
                  (CSRC / "inflate_fixed_core.cuh").read_text())


def _run_core(so, comp, clens, isz, seg: int, nth: int):
    """The core's ``(out [B, max_isize], ok)`` through the wrapper's row
    preparation; asserts that it zeroed each row past ISIZE and wrote
    nothing past the last row."""
    c, out, ok, max_out = kfix._prepare(torch.from_numpy(np.ascontiguousarray(comp)),
                                        torch.from_numpy(np.ascontiguousarray(isz)))
    c = c.numpy()
    B, stride = out.shape
    rng = np.random.default_rng(B)
    mem = rng.integers(0, 256, B * stride + GUARD + 16, dtype=np.uint8)
    at = (-mem.ctypes.data) % 16
    guard = mem[at + B * stride: at + B * stride + GUARD].copy()
    okb = np.full(B, 7, np.uint8)
    cl = np.ascontiguousarray(clens, np.int32)
    iz = np.ascontiguousarray(isz, np.int32)
    assert c.ctypes.data % 16 == 0
    rc = so.hbt_core_inflate(c.ctypes.data, c.shape[1], cl.ctypes.data, iz.ctypes.data, B,
                             mem.ctypes.data + at, stride, okb.ctypes.data, seg, nth)
    assert rc == 0
    assert np.array_equal(mem[at + B * stride: at + B * stride + GUARD], guard), \
        "a write past the last row"
    rows = mem[at: at + B * stride].reshape(B, stride)
    assert set(okb.tolist()) <= {0, 1}
    ok = okb.astype(bool)
    for i in range(B):
        keep = int(isz[i]) if ok[i] else 0
        assert not rows[i, keep:].any(), f"member {i}: nonzero bytes past its payload"
    return rows[:, :max_out].copy(), ok


def _plain(comp, clens, isz):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out, ok = kfix.inflate_fixed_literal_plain(t(comp), t(clens), t(isz))
    return out.numpy(), ok.numpy()


def _differs(so, case, seg, nth, plain=None):
    """Where the core and the plain version disagree (``None`` if nowhere)."""
    out, ok = _run_core(so, *case, seg, nth)
    out_p, ok_p = plain if plain is not None else _plain(*case)
    if not np.array_equal(ok, ok_p):
        k = int(np.flatnonzero(ok != ok_p)[0])
        return f"member {k}: ok {bool(ok[k])} vs {bool(ok_p[k])}"
    if out.shape != out_p.shape:
        return f"shape {out.shape} vs {out_p.shape}"
    if not np.array_equal(out, out_p):
        k = int(np.flatnonzero((out != out_p).any(1))[0])
        return f"member {k}: bytes"
    return None


#: (seg bits, threads): one segment a round, a few, a warp, more than a warp
#: (the scan composes the warps in order); the card's default last.
GEOMETRIES = [(32, 1), (32, 2), (64, 3), (32, 4), (128, 5), (64, 7), (64, 8), (32, 32),
              (64, 32), (32, 33), (kfix.SEG, kfix.THREADS)]
TROUBLE = chip_smoke.fixed_literal_trouble_cases(7)


@functools.lru_cache(maxsize=None)
def _trouble_plain(what):
    return _plain(*TROUBLE[what])


def test_shared_memory_fits_a_block(core):
    """The default geometry's shared memory is the kernel's, and fits: the
    default in 48 KB, the largest segments at 256 threads in a block's
    227 KB."""
    words = kfix.SEG // 32 * kfix.THREADS
    n = 4 * words + 32  # a round's literals and the carried chunk, before the skew
    ibuf, stage = (4 * (words + 1) + 15) & ~15, (n + (n >> 3) + 4 + 15) & ~15
    assert core.hbt_core_smem(kfix.SEG, kfix.THREADS) == \
        2 * ibuf + stage + 5 * words + 32 * kfix.THREADS + 12 * (kfix.THREADS // 32)
    assert core.hbt_core_smem(kfix.SEG, kfix.THREADS) <= 48 * 1024
    assert core.hbt_core_smem(1024, 256) <= 232448


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[f"seg{g[0]}-nth{g[1]}" for g in GEOMETRIES])
@pytest.mark.parametrize("what", sorted(TROUBLE))
def test_trouble_cases_match_plain(core, geom, what):
    """``chip_smoke.fixed_literal_trouble_cases``: the core's ok and every
    byte are the plain version's."""
    assert _differs(core, TROUBLE[what], *geom, _trouble_plain(what)) is None


def _codec_kinds():
    """``chip_smoke.fixed_literal_cases``' kinds, small: literal-only
    members of 0-3,000 bytes of the sort generator's record bytes, an LZ77
    member, a truncated member beside a valid one and a ``btype=10``
    header."""
    rng = np.random.default_rng(17)
    src = chip_smoke.synth_rows(40, 7).reshape(-1)
    payloads = [src[s: s + n].tobytes() for s, n in
                zip(rng.integers(0, len(src) - 3000, 12), [0, 1, 144, 3000, *rng.integers(0, 3000, 8)])]
    comps = [tflate.encode_tokens_fixed([("lit", b) for b in p]) for p in payloads]
    lz = tflate.encode_tokens_fixed([("lit", 65)] * 8 + [("copy", 5, 3)])
    cut = tflate.encode_tokens_fixed([("lit", b) for b in src[:900].tobytes()])
    comps += [lz, cut[: len(cut) // 2], comps[0], bytes([0b101]) + bytes(7)]
    isz = [len(p) for p in payloads] + [13, 900, len(payloads[0]), 4]
    return (_rows(comps), np.asarray([len(c) for c in comps], np.int32),
            np.asarray(isz, np.int32))


def _inflate_fixed_cases():
    """The inputs of ``test_torch_inflate_fixed.py``."""
    rng = np.random.default_rng(7)
    cases = {"byte_equal": _lit([rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                                 for n in (1, 2, 37, 144, 255, 300)]
                                + [bytes([200] * 50), bytes(range(256))])}
    body = [("lit", b) for b in b"ABCDEFGH" * 8]
    c = tflate.encode_tokens_fixed([("lit", 65)] * 8 + [("copy", 5, 3)])
    cases["lz77_copy"] = (_rows([c]), np.array([len(c)], np.int32), np.array([13], np.int32))
    full = tflate.encode_tokens_fixed(body)
    half = full[: len(full) // 2]
    cases["truncated"] = (_rows([half]), np.array([len(half)], np.int32),
                          np.array([64], np.int32))
    comp = np.zeros((1, 8), np.uint8)
    comp[0, 0] = 0b101
    cases["btype_10"] = (comp, np.array([8], np.int32), np.array([4], np.int32))
    for what, n in (("isize_short", 63), ("isize_long", 65)):
        cases[what] = (_rows([full]), np.array([len(full)], np.int32), np.array([n], np.int32))
    e = tflate.encode_tokens_fixed([])
    cases["empty_payload"] = (_rows([e, e]), np.array([len(e)] * 2, np.int32),
                              np.array([0, 1], np.int32))
    rng = np.random.default_rng(3)
    good = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    cutp = rng.integers(0, 256, 900, dtype=np.uint8).tobytes()
    c_cut = tflate.encode_tokens_fixed([("lit", b) for b in cutp])
    c_good = tflate.encode_tokens_fixed([("lit", b) for b in good])
    keep = len(c_cut) - 40
    for tail in ("zero_padded", "bytes_past_clens"):
        cases[f"truncated_then_valid_{tail}"] = (
            _rows([c_cut if tail == "bytes_past_clens" else c_cut[:keep], c_good]),
            np.array([keep, len(c_good)], np.int32), np.array([900, 700], np.int32))
    comp2, clens2, isz2 = _lit([b"hello", b"BGZF"])
    cases["unaligned_width"] = (np.ascontiguousarray(np.pad(comp2, ((0, 0), (0, 3)))), clens2, isz2)
    cases["codec kinds"] = _codec_kinds()
    return cases


IF_CASES = _inflate_fixed_cases()


@pytest.mark.parametrize("geom", GEOMETRIES[::2], ids=[f"seg{g[0]}-nth{g[1]}"
                                                       for g in GEOMETRIES[::2]])
@pytest.mark.parametrize("case", sorted(IF_CASES))
def test_inflate_fixed_cases_match_plain(core, case, geom):
    """The inputs of ``test_torch_inflate_fixed.py`` and the codec corpus's
    kinds."""
    assert _differs(core, IF_CASES[case], *geom) is None


@pytest.mark.parametrize("case", ["byte_equal", "lz77_copy", "isize_long", "empty_payload",
                                  "truncated_then_valid_bytes_past_clens"])
def test_core_matches_the_reference(core, case):
    """A few cases against the JAX package's Pallas kernel in interpret mode:
    ok, and each ok row's payload (the reference leaves the bytes past ISIZE
    unset)."""
    comp, clens, isz = IF_CASES[case]
    ref_out, ref_ok = jlit(comp, clens, isz, interpret=True)
    out, ok = _run_core(core, comp, clens, isz, 32, 3)
    np.testing.assert_array_equal(ok, ref_ok)
    for i in range(len(isz)):
        if ok[i]:
            np.testing.assert_array_equal(out[i, : isz[i]], ref_out[i, : isz[i]])


def test_runs_whose_entries_never_meet_are_walked_exactly(core):
    """A run of byte 37 (code 01010101) decodes as literals from every bit,
    so entries 1-7 never meet entry 0's path: each is walked to its exit."""
    case = TROUBLE["runs whose entries never meet"]
    for geom in ((32, 1), (64, 8), (kfix.SEG, kfix.THREADS)):
        out, ok = _run_core(core, *case, *geom)
        assert ok.all()
        assert out[3, :33].tobytes() == bytes([37]) * 33


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_fail(tmp_path, name):
    """Each mutation of the core makes it differ from the plain version on
    the trouble cases at some geometry.  (A write past ISIZE reaches past
    the row only where a round holds more literals than the row's slack:
    the larger geometries.)"""
    src = (CSRC / "inflate_fixed_core.cuh").read_text()
    old, new = MUTATIONS[name]
    assert src.count(old) == 1, f"mutation site of {name} not found"
    so = _build(tmp_path, src.replace(old, new))

    def differs(g, what):
        try:
            return _differs(so, TROUBLE[what], *g, _trouble_plain(what))
        except AssertionError as e:  # a write past a row, or a dirty tail
            return str(e)

    assert any(differs(g, what) is not None for g in GEOMETRIES[::-1]
               for what in sorted(TROUBLE)), name


def _fuzz_case(data):
    """Members of 0-300 payload bytes (skewed to 0-143, to 144-255, a run
    of one byte, or mixed), some with a length code at a random position,
    ISIZE off by one, clens cut, garbage past clens or a bad header; at
    segments of 32-128 bits and 1-33 threads."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    members = []
    for _ in range(data.draw(st.integers(1, 5))):
        n = int(rng.integers(0, 301))
        skew = data.draw(st.sampled_from(["low", "high", "mixed", "run"]))
        lo, hi = {"low": (0, 144), "high": (144, 256), "mixed": (0, 256), "run": (0, 256)}[skew]
        payload = rng.integers(lo, hi, n, dtype=np.uint8)
        if skew == "run":
            payload[:] = payload[0] if n else 0
        tokens = [("lit", int(b)) for b in payload]
        if n and data.draw(st.booleans()) and rng.random() < 0.3:
            tokens.insert(int(rng.integers(0, n + 1)), ("copy", int(rng.integers(3, 20)), 1))
        s = bytearray(tflate.encode_tokens_fixed(tokens))
        clen, isize = len(s), n
        fault = data.draw(st.sampled_from(["none", "none", "isize-1", "isize+1", "cut", "header"]))
        if fault == "isize-1":
            isize -= 1
        elif fault == "isize+1":
            isize += 1
        elif fault == "cut":
            clen -= int(rng.integers(1, len(s) + 1))
        elif fault == "header":
            s[0] = (s[0] & ~7) | int(rng.choice([0, 1, 2, 4, 5, 6, 7]))
        members.append((bytes(s), clen, isize))
    C = max(len(s) for s, _, _ in members) + int(rng.integers(0, 40))
    fill = rng.integers(0, 256, (len(members), C), dtype=np.uint8) if data.draw(st.booleans()) \
        else None
    case = chip_smoke._fixed_batch(members, C=C, fill=fill)
    seg = data.draw(st.sampled_from([32, 64, 128]))
    nth = data.draw(st.sampled_from([1, 2, 3, 4, 8, 32, 33]))
    return case, seg, nth


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_members_match_plain(core, data):
    """Random payloads, length codes, ISIZE lies, cut clens, garbage past
    clens and bad headers, at segments of 32-128 bits and 1-33 threads.  A
    batch whose every ISIZE is below 0 has no output width: the wrapper
    raises ``ValueError`` for it, as the reference does."""
    case, seg, nth = _fuzz_case(data)
    if int(case[2].max()) < 0:
        with pytest.raises(ValueError):
            kfix.inflate_fixed_literal(*(torch.from_numpy(np.ascontiguousarray(a)) for a in case))
        return
    assert _differs(core, case, seg, nth) is None


def test_tools_import_neither_jax_nor_the_jax_package():
    """``tools/inflate_fixed_pair.py``, ``tools/inflate_fixed_steps.py`` and
    what they import (the port, ``chip_smoke``) load with ``jax`` blocked
    and pull in no module of the JAX package."""
    import os
    import sys

    repo = Path(__file__).resolve().parents[1]
    code = r"""
import importlib.util, sys
sys.modules["jax"] = None  # any import of jax now fails
mods = {}
for name in ("pair", "steps"):
    spec = importlib.util.spec_from_file_location(name, f"tools/inflate_fixed_{name}.py")
    mods[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mods[name])
pair = mods["pair"]
import chip_smoke
from hadoop_bam_tpu_torch.conf import INFLATE_LANES, Configuration
from hadoop_bam_tpu_torch.ops import flate
from hadoop_bam_tpu_torch.ops.kernels import inflate_fixed
bad = [m for m in sys.modules if m == "hadoop_bam_tpu" or m.startswith("hadoop_bam_tpu.")]
assert not bad, bad
assert "import jax" not in pair.ONE_RUN and "hadoop_bam_tpu." not in pair.ONE_RUN
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(repo)), timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
