"""The rANS kernel's decoder core (``csrc/rans_core.cuh``) on the CPU.

The core is the walk of ``csrc/rans.cu`` (split slot tables, u32 states,
the four lanes' votes and branch-free renorm, the payload ring, the
verdicts) and the block's table build written as thread-strided loops.  A
small C++ harness, held here, runs it one stream at a time in the order
the kernel's block runs it, the four lanes in lockstep; it is built with
``g++ -O2 -shared -fPIC`` and bound with ctypes.  The host build copies
each ring chunk with memcpy and counts every read of a chunk that is not
yet copied or already overwritten.

It is held to ``rans_decode_plain`` on the same packed batch: equal ``ok``
for every stream, equal bytes for every ``ok`` stream, no ring fault; and
to the JAX package's ``rans_decode_py`` for the streams that decode.
Tolerance 0.  Each case runs with every table in shared memory (stage 10)
and with order 1's contexts past the first in the spill area (stage 1).
Skips where there is no ``g++``."""

import ctypes
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
from hadoop_bam_tpu.spec import cram_codecs as jcc
from hadoop_bam_tpu_torch.ops.kernels import rans as kr
from hadoop_bam_tpu_torch.spec import cram_codecs as tcc

CSRC = Path(__file__).resolve().parents[1] / "hadoop_bam_tpu_torch" / "csrc"

HARNESS = r"""
#include <stdlib.h>
#include "rans_core.cuh"
using namespace hbt_rans;

// hbt_rans_decode on the host: the kernel's block for stream i, its table
// build on one thread and its four lanes in lockstep, all streams through
// one shared-memory buffer (the ring keeps the last stream's bytes, as a
// reused block's would).  faults[i] counts ring reads of chunks not copied
// yet or already overwritten.
extern "C" int hbt_core_rans(const uint8_t* payload, const int64_t* meta,
                             const uint8_t* lookup, const uint32_t* fc, const int32_t* cmap,
                             uint8_t* spill, uint8_t* out, int32_t* ok, uint32_t* faults,
                             int n, int stage) {
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, smem_bytes(stage)));
  if (!smem) return 1;
  memset(smem, 0xA5, smem_bytes(stage));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* ptrs = reinterpret_cast<uint64_t*>(smem + kPtrOff);
  uint8_t* tabs = smem + kTabOff;
  for (int i = 0; i < n; ++i) {
    const int64_t* mt = meta + static_cast<int64_t>(i) * kMetaCols;
    const int order = static_cast<int>(mt[4]);
    const int32_t* cm = cmap + static_cast<int64_t>(i) * 256;
    Ring g = open_ring(smem, bars, payload + mt[0], static_cast<uint32_t>(mt[1]));
    prime(g, true);
    const Slabs s = stream_slabs(cm, order);
    fill_tables(lookup, fc, s, stage, tabs, spill, 0, 1);
    if (order == 1) fill_ptrs(cm, s, stage, tabs, spill, ptrs, 0, 1);
    ok[i] = decode_stream(g, 0, mt, tabs, ptrs, out + mt[2]);
    faults[i] = g.fault;
  }
  free(smem);
  return 0;
}

extern "C" void hbt_core_consts(uint32_t* c) {
  c[0] = kSlack;
  c[1] = kMaxStage;
  c[2] = smem_bytes(kMaxStage);
  c[3] = kTabWords;
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the rANS core on the host")
    d = tmp_path_factory.mktemp("rans_core")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcore.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{CSRC}",
                    "-o", str(lib), str(d / "harness.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.hbt_core_rans.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int]
    so.hbt_core_consts.argtypes = [ctypes.c_void_p]
    consts = np.zeros(4, np.uint32)
    so.hbt_core_consts(consts.ctypes.data)
    so.consts = consts.tolist()
    return so


def _launchable(datas):
    """``[(data, plan)]`` of the streams that ``rans_lanes`` would launch."""
    out = []
    for d in datas:
        try:
            plan = tcc.parse_rans_plan(d)
        except tcc.CramError:
            continue
        if plan.n_out and all(C[256] <= 4096 for _, C, _ in plan.tables.values()):
            out.append((d, plan))
    return out


def _assert_same(core, plans, stage, datas=None):
    """Decode ``plans`` in one call of the core and of the plain version;
    hold them equal, and each ok stream to the JAX oracle where its
    ``datas`` entry is given.  Returns the ok list."""
    h = kr.pack(plans)
    n = len(plans)
    spill = np.full(h["lookup"].shape[0] * core.consts[3], 0xA5A5A5A5, np.uint32)
    out = np.full(h["out_total"], 0xA5, np.uint8)
    ok = np.zeros(n, np.int32)
    faults = np.zeros(n, np.uint32)
    fc = np.ascontiguousarray(h["fc"])
    arrays = (h["payload"], h["meta"], h["lookup"], fc, h["cmap"], spill, out, ok, faults)
    assert core.hbt_core_rans(*(a.ctypes.data for a in arrays), n, stage) == 0
    t = torch.from_numpy
    out_p, ok_p = kr.rans_decode_plain(t(h["payload"]), t(h["meta"]), t(h["lookup"]),
                                       t(fc.view(np.int32)), t(h["cmap"]), h["out_total"])
    assert faults.tolist() == [0] * n
    assert ok.tolist() == ok_p.tolist()
    out_p = out_p.numpy()
    for i in np.nonzero(ok)[0]:
        o, m = int(h["meta"][i, 2]), int(h["meta"][i, 3])
        assert out[o : o + m].tobytes() == out_p[o : o + m].tobytes(), i
        if datas is not None and datas[i] is not None:
            assert out[o : o + m].tobytes() == jcc.rans_decode_py(datas[i], 0), i
    return ok.tolist()


def _check(core, datas, stage):
    pairs = _launchable(datas)
    return _assert_same(core, [p for _, p in pairs], stage, [d for d, _ in pairs])


STAGES = [1, kr.MAX_STAGE]
#: The cases the kernel gets (an empty stream and a bad order byte tier
#: down before any launch).
EDGE = {what: data for what, (data, _) in chip_smoke.rans_cases(0, b"").items()
        if _launchable([data])}
STATES = chip_smoke.rans_state_cases(0)


def test_constants_equal_the_wrapper(core):
    slack, max_stage, smem, tab_words = core.consts
    assert slack == kr.PAY_SLACK and max_stage == kr.MAX_STAGE
    assert tab_words == kr.TABLE_WORDS
    assert smem <= 232_448  # the shared memory a block of an H100 can use


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("what", sorted(EDGE))
def test_edge_and_corrupt_cases_match_plain(core, what, stage):
    """``chip_smoke.rans_cases`` without the container blocks: empty to
    100,000-byte streams in both orders, n % 4 tails, every order-1
    context, a truncated payload, zeroed states, a missing context."""
    _check(core, [EDGE[what]], stage)


@pytest.mark.parametrize("stage", STAGES)
def test_all_cases_in_one_call(core, stage):
    """Every case in one batch: payloads at many offsets, a ring that holds
    the last stream's bytes."""
    datas = list(EDGE.values()) + list(STATES.values())
    oks = _check(core, datas, stage)
    assert 0 < sum(oks) < len(oks)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("what", sorted(STATES))
def test_state_extremes_match_plain(core, what, stage):
    """Initial states at 0, 2^7 - 1, 2^15 - 1, 2^23 - 1, 2^31 and 2^32 - 1:
    the u32 arithmetic gives the plain version's unbounded integers."""
    _check(core, [STATES[what]], stage)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 63, 64, 65, 67, 4097])
def test_single_symbol_streams(core, order, n):
    """F = 4,096 (stored as 0 with the table's zf)."""
    data = tcc.rans_encode(b"Q" * n, order)
    for stage in STAGES:
        assert _check(core, [data], stage) == [1]


def _order0_stream(F, states, payload, n_out):
    table = tcc._write_freq_table0(F)
    body = table + struct.pack("<4I", *states) + payload
    return bytes([0]) + struct.pack("<II", len(body), n_out) + body


@pytest.mark.parametrize("f0", [0, 7])
@pytest.mark.parametrize("total", [1, 100, 2049, 4095])
def test_tables_below_4096(core, f0, total):
    """A table whose total is below 4,096: the slots past it hold symbol 0,
    with F[0] = 0 (a stored 0 meaning 0) or not.  Random states and
    payloads, so most streams fail a verdict somewhere; both versions must
    agree where."""
    rng = np.random.default_rng(total * 10 + f0)
    datas = []
    for k in range(24):
        F = [0] * 256
        F[0] = min(f0, total)
        syms = rng.choice(np.arange(1, 256), 5, replace=False)
        left = total - F[0]
        for i, s in enumerate(syms):
            F[int(s)] = left if i == len(syms) - 1 else int(rng.integers(0, left // 2 + 1))
            left -= F[int(s)]
        if not any(F):
            F[int(syms[0])] = 1
        states = rng.integers(1 << 23, 1 << 32, 4, dtype=np.uint64).tolist()
        n_out = int(rng.integers(1, 3000))
        payload = rng.integers(0, 256, int(rng.integers(0, 4000)), dtype=np.uint8).tobytes()
        datas.append(_order0_stream(F, states, payload, n_out))
    for stage in STAGES:
        _check(core, datas, stage)


def test_order1_tables_below_4096(core):
    """Order-1 contexts whose totals are below 4,096 (some with F[0] = 0)."""
    rng = np.random.default_rng(5)
    raw = rng.choice(np.frombuffer(b"ACGT", np.uint8), 2000).tobytes()
    plans = []
    for cut in (1, 2, 3, 100, 4095):
        plan = tcc.parse_rans_plan(tcc.rans_encode(raw, 1))
        for ctx, (F, _, _) in list(plan.tables.items()):
            F = list(F)
            top = max(range(256), key=lambda s: F[s])
            F[top] = max(1, F[top] - cut)
            C, lookup = tcc._cum(F)
            plan.tables[ctx] = (F, C, lookup)
        plans.append(plan)
    for stage in STAGES:
        _assert_same(core, plans, stage)


@pytest.mark.parametrize("order", [0, 1])
def test_truncated_payloads(core, order):
    """The payload cut at every eighth byte: the read past clen verdict
    wherever it lands, and bytes up to it."""
    rng = np.random.default_rng(order)
    raw = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 1500).tobytes()
    enc = tcc.rans_encode(raw, order)
    n_pay = len(tcc.parse_rans_plan(enc).payload)
    datas = [enc[: len(enc) - cut] for cut in range(1, n_pay + 1, 8)]
    for stage in STAGES:
        oks = _check(core, datas, stage)
        assert not any(oks)


@pytest.mark.parametrize("ctx", list(b"ACGT"))
def test_missing_order1_context(core, ctx):
    """An order-1 context absent from the stream's tables (cmap -1)."""
    raw = b"ACGT" * 100 + b"TTGA" * 50
    plan = tcc.parse_rans_plan(tcc.rans_encode(raw, 1))
    del plan.tables[ctx]
    good = tcc.parse_rans_plan(tcc.rans_encode(raw, 1))
    for stage in STAGES:
        assert _assert_same(core, [good, plan, good], stage) == [1, 0, 1]


def _fuzz_stream(data):
    order = data.draw(st.sampled_from([0, 1]))
    n = data.draw(st.integers(1, 5000))
    k = data.draw(st.integers(1, 256))
    seed = data.draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    alpha = rng.choice(256, k, replace=False).astype(np.uint8)
    w = rng.random(k) ** 4 + 1e-3
    raw = rng.choice(alpha, n, p=w / w.sum()).tobytes()
    enc = bytearray(tcc.rans_encode(raw, order))
    n_pay = len(tcc.parse_rans_plan(bytes(enc)).payload)
    what = data.draw(st.sampled_from(["clean", "clean", "flip", "cut", "states"]))
    if what == "flip" and n_pay:
        enc[len(enc) - 1 - data.draw(st.integers(0, n_pay - 1))] ^= data.draw(
            st.integers(1, 255))
    elif what == "cut" and n_pay:
        enc = enc[: len(enc) - data.draw(st.integers(1, n_pay))]
    elif what == "states":
        j = data.draw(st.integers(0, 3))
        at = len(enc) - n_pay - 16 + 4 * j
        enc[at : at + 4] = struct.pack("<I", data.draw(st.integers(0, 2**32 - 1)))
    return bytes(enc), raw if what == "clean" else None


@settings(max_examples=120, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_fuzzed_streams_match_plain(core, data):
    """Random bytes over random alphabets, both orders, 1-5,000 bytes, two
    or three streams a call, clean or with a flipped payload byte, a cut
    payload or a random state."""
    streams = [_fuzz_stream(data) for _ in range(data.draw(st.integers(1, 3)))]
    stage = data.draw(st.sampled_from(STAGES))
    oks = _check(core, [enc for enc, _ in streams], stage)
    for (enc, raw), ok in zip(streams, oks):
        if raw is not None:
            assert ok == 1
