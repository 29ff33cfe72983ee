"""QSEQ input and output (QseqInputFormat.java, QseqOutputFormat.java).

Counterpart of ``hadoop_bam_tpu/io/qseq.py``: eleven tab-separated fields a
line (machine, run, lane, tile, x, y, index, read, sequence, quality,
filter); the key is ``machine:run:lane:tile:x:y:read`` (:344-363); ``.``
bases become ``N`` and an index field of ``0`` is none (:378-385); input
quality defaults to Illumina Phred+64, converted to Sanger (:403-426); a
split drops its partial first line (:136-155).  The writer turns ``N`` back
into ``.`` and re-encodes quality (QseqOutputFormat.java:98-157).  A split
reads its own window through the filesystem seam (:mod:`.fs`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..conf import (
    Configuration,
    INPUT_BASE_QUALITY_ENCODING,
    INPUT_FILTER_FAILED_QC,
    QSEQ_BASE_QUALITY_ENCODING,
    QSEQ_FILTER_FAILED_QC,
    QSEQ_OUTPUT_BASE_QUALITY_ENCODING,
)
from ..spec.fragment import (
    ILLUMINA_MAX,
    ILLUMINA_OFFSET,
    SANGER_MAX,
    SANGER_OFFSET,
    FormatException,
    FragmentBatch,
    SequencedFragment,
    convert_quality,
)
from .splits import ByteSplit
from .text import gather_padded, line_table, plan_byte_splits, read_split_window

NUM_QSEQ_COLS = 11


def parse_qseq_line(line: bytes) -> tuple[str, SequencedFragment]:
    fields = line.split(b"\t")
    if len(fields) != NUM_QSEQ_COLS:
        raise FormatException(
            f"found {len(fields)} fields instead of 11. Line: {line!r}"
        )
    frag = SequencedFragment()
    frag.instrument = fields[0].decode()
    frag.run_number = int(fields[1])
    frag.lane = int(fields[2])
    frag.tile = int(fields[3])
    frag.xpos = int(fields[4])
    frag.ypos = int(fields[5])
    frag.read = int(fields[7])
    frag.filter_passed = fields[10][:1] != b"0"
    if fields[6][:1] == b"0":  # 0 is a null index sequence (:378-382)
        frag.index_sequence = None
    else:
        frag.index_sequence = fields[6].decode().replace(".", "N")
    frag.sequence = fields[8].replace(b".", b"N")
    frag.quality = bytes(fields[9])
    key = b":".join(fields[0:6] + [fields[7]]).decode()
    return key, frag


def _qseq_materializer(a, cs, ce, qual_lens):
    """Lazy per-record view: metadata from the field table, seq/qual from
    the already-converted SoA tensors."""

    def build(batch):
        out = []
        for i in range(batch.n_records):
            sl = int(batch.lengths[i])
            ql = int(qual_lens[i])
            frag = SequencedFragment(
                sequence=batch.seq[i, :sl].tobytes(),
                quality=batch.qual[i, :ql].tobytes(),
            )
            frag.instrument = bytes(a[cs[i, 0] : ce[i, 0]]).decode()
            frag.run_number = int(bytes(a[cs[i, 1] : ce[i, 1]]))
            frag.lane = int(bytes(a[cs[i, 2] : ce[i, 2]]))
            frag.tile = int(bytes(a[cs[i, 3] : ce[i, 3]]))
            frag.xpos = int(bytes(a[cs[i, 4] : ce[i, 4]]))
            frag.ypos = int(bytes(a[cs[i, 5] : ce[i, 5]]))
            frag.read = int(bytes(a[cs[i, 7] : ce[i, 7]]))
            filt = bytes(a[cs[i, 10] : ce[i, 10]])
            frag.filter_passed = filt[:1] != b"0"
            index = bytes(a[cs[i, 6] : ce[i, 6]])
            if index[:1] == b"0":  # 0 is a null index sequence (:378-382)
                frag.index_sequence = None
            else:
                frag.index_sequence = index.decode().replace(".", "N")
            out.append(frag)
        return out

    return build


class QseqInputFormat:
    def __init__(self, conf: Optional[Configuration] = None):
        self.conf = conf or Configuration()

    def _encoding(self) -> str:
        enc = self.conf.get(
            QSEQ_BASE_QUALITY_ENCODING,
            self.conf.get(INPUT_BASE_QUALITY_ENCODING, "illumina"),
        )
        if enc not in ("sanger", "illumina"):
            raise ValueError(f"Unknown input base quality encoding value {enc}")
        return enc

    def _filter_failed(self) -> bool:
        raw = self.conf.get(
            QSEQ_FILTER_FAILED_QC, self.conf.get(INPUT_FILTER_FAILED_QC)
        )
        c = Configuration({"k": raw} if raw is not None else None)
        return c.get_boolean("k", False)

    def get_splits(self, paths, split_size: int = 4 << 20) -> List[ByteSplit]:
        out: List[ByteSplit] = []
        for p in sorted(paths):
            out.extend(plan_byte_splits(p, split_size))
        return out

    def read_split(
        self, split: ByteSplit, data: Optional[bytes] = None
    ) -> FragmentBatch:
        """One newline scan and one tab scan build the 11-column field
        table (each line's tabs by a search of the window's tab index);
        seq/qual land in padded arrays through one batched gather; the
        Illumina fields are made lazily."""
        if data is None:
            # The split's own window; gzip reads the whole payload.
            data, split = read_split_window(split)
        encoding = self._encoding()
        filter_failed = self._filter_failed()
        a = np.frombuffer(data, dtype=np.uint8)
        # Split resync: drop the partial first line (:136-155).
        start = split.start
        if start > 0:
            nl = data.find(b"\n", start - 1) if isinstance(data, bytes) else -1
            if not isinstance(data, bytes):
                hits = np.nonzero(a[start - 1 :] == 0x0A)[0]
                nl = start - 1 + int(hits[0]) if len(hits) else -1
            start = len(a) if nl < 0 else nl + 1
        starts, lens = line_table(a, start, split.end)
        keep = lens > 0  # blank lines are skipped, as in the line loop
        starts, lens = starts[keep], lens[keep]
        n = len(starts)
        if n == 0:
            return FragmentBatch(
                seq=np.zeros((0, 0), np.uint8),
                qual=np.zeros((0, 0), np.uint8),
                lengths=np.zeros(0, np.int32),
                _names=[],
            )
        # Field table: the k-th tab of line i, from one scan of the window.
        wlo = int(starts[0])
        whi = int((starts + lens).max())
        tabs = wlo + np.nonzero(a[wlo:whi] == 0x09)[0]
        t0 = np.searchsorted(tabs, starts)
        tk = t0[:, None] + np.arange(NUM_QSEQ_COLS - 1)
        exists = tk < len(tabs)  # clamping alone must not fake a field
        T = tabs[np.minimum(tk, max(len(tabs) - 1, 0))] if len(tabs) else (
            np.zeros_like(tk)
        )
        in_line = exists & (T < (starts + lens)[:, None])
        bad = ~in_line.all(axis=1)
        # Too many tabs: the 11th field would contain another tab.
        over = np.minimum(t0 + NUM_QSEQ_COLS - 1, max(len(tabs) - 1, 0))
        has11 = (
            (t0 + NUM_QSEQ_COLS - 1 < len(tabs))
            & (tabs[over] < starts + lens)
            if len(tabs)
            else np.zeros(n, dtype=bool)
        )
        bad |= has11
        if bad.any():
            i = int(np.argmax(bad))
            line = bytes(a[starts[i] : starts[i] + lens[i]])
            nfields = int(in_line[i].sum()) + 1 if not has11[i] else 12
            raise FormatException(
                f"found {nfields} fields instead of 11. Line: {line!r}"
            )
        # Column c of line i spans [cs[i,c], ce[i,c]).
        cs = np.concatenate([starts[:, None], T + 1], axis=1)
        ce = np.concatenate([T, (starts + lens)[:, None]], axis=1)
        seq_lens = (ce[:, 8] - cs[:, 8]).astype(np.int64)
        qual_lens = (ce[:, 9] - cs[:, 9]).astype(np.int64)

        if filter_failed:
            # An empty trailing field at EOF has cs == len(a): no byte to
            # read, and the empty field counts as passed (b"" != b"0").
            f10 = np.minimum(cs[:, 10], len(a) - 1)
            passed = (cs[:, 10] >= ce[:, 10]) | (a[f10] != 0x30)  # '0'
            sel = np.nonzero(passed)[0]
            if len(sel) < n:
                starts, lens = starts[sel], lens[sel]
                cs, ce = cs[sel], ce[sel]
                seq_lens, qual_lens = seq_lens[sel], qual_lens[sel]
                n = len(sel)

        W = int(max(seq_lens.max(), qual_lens.max())) if n else 0
        seq = gather_padded(a, cs[:, 8].astype(np.int64), seq_lens, W)
        qual = gather_padded(a, cs[:, 9].astype(np.int64), qual_lens, W)
        smask = np.arange(W)[None, :] < seq_lens[:, None]
        qmask = np.arange(W)[None, :] < qual_lens[:, None]
        seq[smask & (seq == 0x2E)] = ord("N")  # '.' → 'N' (:403-426)

        if encoding == "illumina":
            inr = (qual >= ILLUMINA_OFFSET) & (
                qual <= ILLUMINA_OFFSET + ILLUMINA_MAX
            )
            if bool((qmask & ~inr).any()):
                r, c = np.argwhere(qmask & ~inr)[0]
                raise FormatException(
                    "base quality score out of range for Illumina Phred+64 "
                    f"format (found {int(qual[r, c]) - ILLUMINA_OFFSET} but "
                    f"acceptable range is [0,{ILLUMINA_MAX}]).\n"
                    "Maybe qualities are encoded in Sanger format?\n"
                )
            qual = np.where(
                qmask,
                qual.astype(np.int16) - (ILLUMINA_OFFSET - SANGER_OFFSET),
                0,
            ).astype(np.uint8)
        else:
            inr = (qual >= SANGER_OFFSET) & (qual <= SANGER_OFFSET + SANGER_MAX)
            if bool((qmask & ~inr).any()):
                r, c = np.argwhere(qmask & ~inr)[0]
                raise FormatException(
                    "qseq base quality score out of range for Sanger "
                    f"Phred+33 format (found {int(qual[r, c]) - 33})."
                )

        # Keys: machine:run:lane:tile:x:y:read (:344-363), joined from the
        # column slices.
        mv = memoryview(data) if isinstance(data, bytes) else memoryview(a)
        names = [
            ":".join(
                (
                    str(mv[cs[i, 0] : ce[i, 0]], "utf-8"),
                    str(mv[cs[i, 1] : ce[i, 1]], "utf-8"),
                    str(mv[cs[i, 2] : ce[i, 2]], "utf-8"),
                    str(mv[cs[i, 3] : ce[i, 3]], "utf-8"),
                    str(mv[cs[i, 4] : ce[i, 4]], "utf-8"),
                    str(mv[cs[i, 5] : ce[i, 5]], "utf-8"),
                    str(mv[cs[i, 7] : ce[i, 7]], "utf-8"),
                )
            )
            for i in range(n)
        ]
        return FragmentBatch(
            seq=seq,
            qual=qual,
            lengths=seq_lens.astype(np.int32),
            _names=names,
            materializer=_qseq_materializer(a, cs, ce, qual_lens),
        )


class QseqOutputFormat:
    """Write fragments as QSEQ lines (QseqOutputFormat.java:98-157)."""

    def __init__(self, conf: Optional[Configuration] = None):
        self.conf = conf or Configuration()
        enc = self.conf.get(QSEQ_OUTPUT_BASE_QUALITY_ENCODING, "illumina")
        if enc not in ("sanger", "illumina"):
            raise ValueError(f"Unknown output base quality encoding {enc}")
        self.encoding = enc

    def format_record(self, frag: SequencedFragment) -> bytes:
        qual = frag.quality
        if self.encoding == "illumina":
            qual = convert_quality(qual, "sanger", "illumina")
        fields = [
            (frag.instrument or "").encode(),
            str(frag.run_number or 0).encode(),
            str(frag.lane or 0).encode(),
            str(frag.tile or 0).encode(),
            str(frag.xpos or 0).encode(),
            str(frag.ypos or 0).encode(),
            (frag.index_sequence or "0").encode(),
            str(frag.read or 1).encode(),
            frag.sequence.replace(b"N", b"."),
            qual,
            b"1" if frag.filter_passed in (None, True) else b"0",
        ]
        return b"\t".join(fields) + b"\n"

    def write(self, stream, batch: FragmentBatch) -> None:
        for frag in batch.fragments:
            stream.write(self.format_record(frag))
