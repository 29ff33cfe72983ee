"""The port's record scan (``ops/kernels/record_scan.py``: the plain version
of ``csrc/record_scan.cu``, the launch gate and the host tiers) against the
reference's ``ops/pallas/record_scan.py`` with its Pallas kernel in
interpret mode, exactly: record tables, per-chunk ``[n, ok]`` and the
tier-down reasons.

Every reference launch pins one geometry, as ``tests/test_ingest.py`` does
(256-byte claims + 256 bytes of overlap, ``rec_cap=64``), so the interpret
kernel compiles once; corpora stay under 3 KiB.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ingest import make_fastq

from hadoop_bam_tpu.spec.fragment import FormatException as JFormatException
from hadoop_bam_tpu_torch.ops.kernels import record_scan as trs
from hadoop_bam_tpu_torch.spec.fragment import FormatException

# The package re-exports the function under the module's name.
jrs = importlib.import_module("hadoop_bam_tpu.ops.pallas.record_scan")

CHUNK = 256
OVERLAP = 256
REC_CAP = 64


def chunks_of(run, aligned=True, chunk=CHUNK, overlap=OVERLAP):
    out = []
    for off in range(0, len(run), chunk):
        win = run[off: off + chunk + overlap]
        out.append((win, min(chunk, len(run) - off), aligned and off == 0,
                    off + len(win) >= len(run)))
    return out


def port_record_scan(chunks, rec_cap=None, device="cpu"):
    """The reference's ``record_scan`` interface on the port: ``(window,
    chunk_len, aligned, final)`` chunks packed back to back into one tensor
    on ``device`` and scanned by ``record_scan_windows``."""
    wins = [bytes(c[0]) for c in chunks]
    lens = np.array([len(w) for w in wins], np.int64)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    data = torch.from_numpy(np.frombuffer(b"".join(wins), np.uint8).copy()).to(device)
    return trs.record_scan_windows(data, starts, lens, [c[1] for c in chunks],
                                   [c[2] for c in chunks], [c[3] for c in chunks],
                                   rec_cap=rec_cap)


def ref_meta(chunks, rec_cap=REC_CAP):
    """The Pallas kernel's own ``[n, ok]`` and rows per chunk (one launch
    group at the pinned geometry), read before the wrapper drops them."""
    group = [(i, bytes(w), int(cl), bool(a), bool(f)) for i, (w, cl, a, f) in enumerate(chunks)]
    assert len(group) <= jrs.LANES and max(len(g[1]) for g in group) <= CHUNK + OVERLAP
    n_words, _ = jrs.scan_geometry(CHUNK + OVERLAP, rec_cap)
    meta, words = jrs._pack_windows(group, n_words)
    recs, mout = jrs._launch(jnp.asarray(meta), jnp.asarray(words), n_words=n_words,
                             rec_cap=rec_cap, interpret=True)
    recs, mout = np.asarray(recs), np.asarray(mout)
    rows = [recs[: 8 * int(mout[0, k]), k].reshape(-1, 8) for k in range(len(group))]
    return mout[:, : len(group)].T.copy(), rows


def port_meta(chunks, rec_cap=REC_CAP):
    """The plain version's ``[n, ok]`` and rows per chunk."""
    wins = [bytes(c[0]) for c in chunks]
    lens = np.array([len(w) for w in wins], np.int64)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    data = torch.from_numpy(np.frombuffer(b"".join(wins), np.uint8).copy())
    rows, meta, base = trs.scan_windows(
        data, starts, lens, [c[1] for c in chunks], [c[2] for c in chunks],
        [c[3] for c in chunks], [rec_cap] * len(chunks))
    meta, rows, base = meta.numpy(), rows.numpy(), base.numpy()
    return meta, [rows[b: b + n] for b, n in zip(base.tolist(), meta[:, 0].tolist())]


def assert_same_scan(chunks, rec_cap=REC_CAP):
    """Meta, rows (every chunk, ok or not), the wrapper's tables and stats."""
    mj, rj = ref_meta(chunks, rec_cap)
    mt, rt = port_meta(chunks, rec_cap)
    np.testing.assert_array_equal(mt, mj)
    for k, (a, b) in enumerate(zip(rt, rj)):
        np.testing.assert_array_equal(a, b, err_msg=f"chunk {k}")
    tables_t, st_t = port_record_scan(chunks, rec_cap=rec_cap)
    tables_j, st_j = jrs.record_scan(chunks, rec_cap=rec_cap)
    for k, (a, b) in enumerate(zip(tables_t, tables_j)):
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"chunk {k}")
    assert (st_t.lanes, st_t.host, st_t.reasons) == (st_j.lanes, st_j.host, st_j.reasons)
    return mt


@pytest.mark.parametrize("crlf", [False, True], ids=["lf", "crlf"])
@pytest.mark.parametrize("qual_at", [0, 3], ids=["plain_quals", "at_quals"])
def test_scan_matches_the_reference(crlf, qual_at):
    run = make_fastq(30, seed=11, crlf=crlf, qual_at_every=qual_at)
    assert len(run) <= 3 << 10
    chunks = chunks_of(run)
    meta = assert_same_scan(chunks)
    assert meta[:, 1].sum() >= len(chunks) - 1
    host = [trs.scan_window_host(*c) for c in chunks]
    for k, c in enumerate(chunks):
        np.testing.assert_array_equal(host[k], jrs.scan_window_host(*c))


def test_scan_without_trailing_newline():
    run = make_fastq(12, seed=4, trailing_nl=False)
    assert_same_scan(chunks_of(run))
    small = make_fastq(4, seed=4, trailing_nl=False)
    meta = assert_same_scan([(small, len(small), True, True)])
    assert meta.tolist() == [[4, 1]]  # the synthetic final newline ends the last record


def test_scan_unaligned_run_resyncs():
    run = make_fastq(24, seed=7)[17:]
    assert_same_scan(chunks_of(run, aligned=False))
    walker, _ = trs.scan_window_py(run, len(run), False, True)
    want, _ = jrs.scan_window_py(run, len(run), False, True)
    np.testing.assert_array_equal(walker, want)
    assert len(walker) == 23


def test_final_window_with_one_lone_frame():
    """The kernel needs two verified frames and reports ok = 0; the host tier
    trusts a lone frame at the end of the data and parses it."""
    win = make_fastq(3, seed=9)[5:]
    lone = win[: win.index(b"@r2")]  # torn head + one whole frame (@r1)
    chunks = [(lone, len(lone), False, True)]
    meta = assert_same_scan(chunks)
    assert meta.tolist() == [[0, 0]]
    host = trs.scan_window_host(*chunks[0])
    np.testing.assert_array_equal(host, jrs.scan_window_host(*chunks[0]))
    assert len(host) == 1


def test_garbage_and_clean_chunk_tier_down_per_chunk():
    clean = make_fastq(8, seed=2)[: CHUNK + OVERLAP]
    garbage = bytes(range(1, 128)) * 4
    chunks = [(garbage[: CHUNK + OVERLAP], CHUNK, True, False),
              (clean, min(CHUNK, len(clean)), True, True)]
    meta = assert_same_scan(chunks)
    assert meta[:, 1].tolist() == [0, 1]
    tables, stats = port_record_scan(chunks, rec_cap=REC_CAP)
    assert stats.launches == 1 and stats.reasons == {"scan": 1}
    assert tables[0] is None and tables[1] is not None


def test_record_cap_overflow():
    """A chunk with more claimed records than its cap reports ok = 0 with n
    at the cap, as the reference's record tile overflows."""
    run = b"".join(b"@%d\nA\n+\nI\n" % i for i in range(40))[: CHUNK + OVERLAP]
    chunks = [(run, CHUNK, True, False), (run[:100], 100, True, True)]
    for cap in (8, 64):
        meta = assert_same_scan(chunks, rec_cap=cap)
        assert meta[0].tolist() == ([8, 0] if cap == 8 else [27, 1])


def test_size_gate_tiers_down_per_chunk():
    big = b"\n" * ((1 << 17) + 64)
    ok = make_fastq(6, seed=3)[: CHUNK + OVERLAP]
    chunks = [(big, 1 << 17, True, False), (ok, min(CHUNK, len(ok)), True, True)]
    tables, stats = port_record_scan(chunks, rec_cap=REC_CAP)
    tj, sj = jrs.record_scan(chunks, rec_cap=REC_CAP)
    assert tables[0] is None and tj[0] is None
    np.testing.assert_array_equal(tables[1], tj[1])
    assert (stats.lanes, stats.host, stats.reasons) == (sj.lanes, sj.host, sj.reasons)
    assert stats.reasons == {"size": 1}


def test_launch_gate_equals_the_reference():
    for w in (0, 1, 512, 4096, 17000, 59136, 1 << 17, (1 << 17) + 1):
        for cap in (8, 64, 1664, 1728):
            assert trs.accepts(w, cap) == jrs.accepts(w, cap)
            assert trs.scan_geometry(w, cap) == jrs.scan_geometry(w, cap)


def test_default_rec_cap_equals_the_reference_wherever_its_gate_passes():
    """The reference rounds its cap up after clamping it, so from ~18 KB
    windows up its cap fails its own gate (every group tiers down "vmem",
    and at the ingest's default 59,136-byte windows the scan never runs);
    the port clamps after rounding.  Where the reference's cap passes its
    gate the caps are equal."""
    passes = 0
    for w in list(range(0, 40000, 97)) + [57088, 59136, 65536, 100000, 1 << 17]:
        ref = jrs.default_rec_cap(w)
        port = trs.default_rec_cap(w)
        if jrs.accepts(w, ref)[0]:
            passes += 1
            assert port == ref, w
        assert port % 64 == 0 and port >= 64
    assert passes > 150
    assert jrs.accepts(59136, jrs.default_rec_cap(59136)) == (False, "vmem")
    assert trs.accepts(59136, trs.default_rec_cap(59136)) == (True, "")
    assert trs.default_rec_cap(59136) == 1664
    assert trs.accepts(1 << 17, trs.default_rec_cap(1 << 17)) == (False, "vmem")


def test_host_tiers_equal_the_reference():
    cases = [
        (make_fastq(10, seed=1), True, True),
        (make_fastq(10, seed=1, crlf=True, qual_at_every=2), True, True),
        (make_fastq(10, seed=2)[9:], False, True),
        (make_fastq(10, seed=3)[:300], True, False),
        (make_fastq(10, seed=4, trailing_nl=False), True, True),
    ]
    for run, aligned, final in cases:
        for cl in (len(run), 128):
            for fn_t, fn_j in ((trs.scan_window_host, jrs.scan_window_host),
                               (lambda *a: trs.scan_window_py(*a)[0],
                                lambda *a: jrs.scan_window_py(*a)[0])):
                try:
                    want = fn_j(run, cl, aligned, final)
                except (jrs.WindowOverrun, JFormatException) as e:
                    exc = trs.WindowOverrun if isinstance(e, jrs.WindowOverrun) else FormatException
                    with pytest.raises(exc):
                        fn_t(run, cl, aligned, final)
                    continue
                np.testing.assert_array_equal(fn_t(run, cl, aligned, final), want)


def test_walker_salvage_equals_the_reference():
    torn = b"@a\nACGT\n+\nIII\n@b\nGGGG\n+\nJJJJ\n@c\nTT\n+\nKK\n"
    with pytest.raises(FormatException):
        trs.scan_window_py(torn, len(torn), True, True)
    for run in (torn, torn[:-3], make_fastq(9, seed=5)[:200] + torn):
        got = trs.scan_window_py(run, len(run), True, True, salvage=True)
        want = jrs.scan_window_py(run, len(run), True, True, salvage=True)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_plain_version_does_not_count_launches():
    before = trs.LAUNCHES.value
    port_record_scan(chunks_of(make_fastq(5, seed=1)), rec_cap=REC_CAP)
    assert trs.LAUNCHES.value == before


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the record-scan kernel runs only on the card")
    runs = [make_fastq(30, seed=11, crlf=True, qual_at_every=3), make_fastq(24, seed=7)[17:],
            bytes(range(1, 128)) * 4]
    for run in runs:
        for chunk, overlap in ((CHUNK, OVERLAP), (0xDF00, 2048)):
            chunks = chunks_of(run, aligned=run[:1] == b"@", chunk=chunk, overlap=overlap)
            got, stats = port_record_scan(chunks, device="cuda")
            want, pst = port_record_scan(chunks)
            assert (stats.lanes, stats.host, stats.reasons) == (pst.lanes, pst.host, pst.reasons)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
