"""FASTQ input and output with the reference's resync, ID and quality
rules (FastqInputFormat.java, FastqOutputFormat.java).

Counterpart of ``hadoop_bam_tpu/io/fastq.py``:

- split resync: an ``@`` line with a ``+`` line two lines later, trusted
  only when two consecutive records verify (:156-198);
- the Casava 1.8 ID pattern fills the Illumina fields (:92-93, 362-381),
  else the ``/N`` read-number suffix (:349-360), stateful across a batch;
- qualities converted to Sanger (Illumina input) or range-checked
  (:318-341); failed-QC filtering per ``hbam.fastq-input.filter-failed-qc``;
- the writer rebuilds the ID from the Illumina fields when present and
  re-encodes quality per ``hbam.fastq-output.base-quality-encoding``
  (FastqOutputFormat.java:117-183).

A split reads its own window through the filesystem seam (:mod:`.fs`).
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from ..conf import (
    Configuration,
    FASTQ_BASE_QUALITY_ENCODING,
    FASTQ_FILTER_FAILED_QC,
    FASTQ_OUTPUT_BASE_QUALITY_ENCODING,
    INPUT_BASE_QUALITY_ENCODING,
    INPUT_FILTER_FAILED_QC,
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
from .text import (
    MAX_LINE_LENGTH,
    SplitLineReader,
    decode_slices,
    gather_padded,
    line_table,
    plan_byte_splits,
    read_split_window,
)

# Casava 1.8: instrument:run:flowcell:lane:tile:x:y read:filtered:control:index
ILLUMINA_PATTERN = re.compile(
    r"([^:]+):(\d+):([^:]*):(\d+):(\d+):(-?\d+):(-?\d+)\s+([123]):([YN]):(\d+):(.*)"
)


def scan_illumina_id(name: str, frag: SequencedFragment) -> bool:
    m = ILLUMINA_PATTERN.fullmatch(name)
    if not m:
        return False
    frag.instrument = m.group(1)
    frag.run_number = int(m.group(2))
    frag.flowcell_id = m.group(3)
    frag.lane = int(m.group(4))
    frag.tile = int(m.group(5))
    frag.xpos = int(m.group(6))
    frag.ypos = int(m.group(7))
    frag.read = int(m.group(8))
    frag.filter_passed = m.group(9) == "N"
    frag.control_number = int(m.group(10))
    frag.index_sequence = m.group(11)
    return True


def scan_read_number(name: str, frag: SequencedFragment) -> None:
    """``/N`` suffix fallback (FastqInputFormat.java:349-360)."""
    if len(name) >= 2 and name[-2] == "/" and name[-1].isdigit():
        frag.read = int(name[-1])


def _fastq_materializer(qual_lens):
    """The lazy per-record views: replays the reference's stateful
    id-parse chain (Illumina regex until first failure, then ``/N``)."""

    def build(batch):
        out = []
        look_for_illumina = True
        for i, name in enumerate(batch.names):
            sl = int(batch.lengths[i])
            ql = int(qual_lens[i])
            frag = SequencedFragment(
                sequence=batch.seq[i, :sl].tobytes(),
                quality=batch.qual[i, :ql].tobytes(),
            )
            look_for_illumina = look_for_illumina and scan_illumina_id(
                name, frag
            )
            if not look_for_illumina:
                scan_read_number(name, frag)
            out.append(frag)
        return out

    return build


class FastqInputFormat:
    def __init__(self, conf: Optional[Configuration] = None):
        self.conf = conf or Configuration()

    def _encoding(self) -> str:
        enc = self.conf.get(
            FASTQ_BASE_QUALITY_ENCODING,
            self.conf.get(INPUT_BASE_QUALITY_ENCODING, "sanger"),
        )
        if enc not in ("sanger", "illumina"):
            raise ValueError(f"Unknown input base quality encoding value {enc}")
        return enc

    def _filter_failed(self) -> bool:
        raw = self.conf.get(
            FASTQ_FILTER_FAILED_QC, self.conf.get(INPUT_FILTER_FAILED_QC)
        )
        c = Configuration({"k": raw} if raw is not None else None)
        return c.get_boolean("k", False)

    def get_splits(self, paths, split_size: int = 4 << 20) -> List[ByteSplit]:
        out: List[ByteSplit] = []
        for p in sorted(paths):
            out.extend(plan_byte_splits(p, split_size))
        return out

    def position_at_first_record(
        self, data: bytes, start: int, end: int
    ) -> int:
        """The @/+ resync with backtracking (FastqInputFormat.java:156-198),
        hardened to the split-guesser stance: a candidate ``@`` line is
        trusted only when it heads TWO consecutive verified records
        (``@``/``+`` markers plus equal seq/qual lengths, twice over) —
        a lone ``@``-plus-``+`` look-ahead mistakes a quality string
        beginning with ``@`` for a record start whenever the split lands
        mid-quality-line.  The second record is waived only when the
        data ends before it can complete."""
        if start == 0:
            return 0
        r = SplitLineReader(data, start, len(data))
        pos = r.tell()
        while pos < end:
            line_start = pos
            line = r.read_line()
            if line is None:
                return len(data)
            if line.startswith(b"@"):
                backtrack = r.tell()
                window = [line]
                for _ in range(7):
                    nxt = r.read_line()
                    if nxt is None:
                        break
                    window.append(nxt)

                def frame(i: int) -> Optional[bool]:
                    if i + 3 >= len(window):
                        return None  # incomplete: data ran out
                    return (
                        window[i].startswith(b"@")
                        and window[i + 2].startswith(b"+")
                        and len(window[i + 1]) == len(window[i + 3])
                    )

                first, second = frame(0), frame(4)
                if first and (second or second is None):
                    return line_start
                r.pos = backtrack  # not a record start: resume after it
                pos = backtrack
            else:
                pos = r.tell()
        return pos

    def read_split(
        self, split: ByteSplit, data: Optional[bytes] = None
    ) -> FragmentBatch:
        """One newline scan builds the line table, one batched gather the
        padded seq/qual arrays; the quality check and conversion are masked
        array ops.  Per-record ``SequencedFragment`` views are made lazily,
        with the reference's stateful Illumina-then-``/N`` ID rule."""
        if data is None:
            # The split's own window (a record spans 4 lines, so 4 complete
            # lines past the split end); gzip reads the whole payload.
            data, split = read_split_window(split, min_lines_past_end=4)
        start = self.position_at_first_record(data, split.start, split.end)
        encoding = self._encoding()
        filter_failed = self._filter_failed()

        a = np.frombuffer(data, dtype=np.uint8)
        # Keep lines up to the end of a record straddling the split end (3
        # continuation lines at most), never to EOF.
        line_stop = min(len(a), split.end + 4 * (MAX_LINE_LENGTH + 1))
        starts, lens = line_table(a, start, line_stop)
        # Records = consecutive 4-line groups whose id line starts before
        # the split end (the read-past-end protocol finishes the tail).
        id_idx = np.arange(0, len(starts), 4)
        id_idx = id_idx[starts[id_idx] < split.end]
        n = len(id_idx)
        if n == 0:
            return FragmentBatch(
                seq=np.zeros((0, 0), np.uint8),
                qual=np.zeros((0, 0), np.uint8),
                lengths=np.zeros(0, np.int32),
                _names=[],
            )
        if id_idx[-1] + 3 >= len(starts):
            name = bytes(
                a[starts[id_idx[-1]] + 1 :][: 200]
            ).split(b"\n")[0].decode(errors="replace")
            raise FormatException(
                f"unexpected end of file in fastq record. Id: {name}"
            )
        bad_at = a[starts[id_idx]] != 0x40  # '@'
        if bad_at.any():
            k = int(id_idx[np.argmax(bad_at)])
            line = bytes(a[starts[k] : starts[k] + lens[k]])
            raise FormatException(
                f"unexpected fastq record start at {split.path}: {line!r}"
            )
        plus_idx = id_idx + 2
        bad_plus = (lens[plus_idx] < 1) | (a[starts[plus_idx]] != 0x2B)
        if bad_plus.any():
            j = int(np.argmax(bad_plus))
            k = int(plus_idx[j])
            line = bytes(a[starts[k] : starts[k] + lens[k]])
            name = bytes(
                a[starts[id_idx[j]] + 1 : starts[id_idx[j]] + lens[id_idx[j]]]
            ).decode()
            raise FormatException(
                "unexpected fastq line separating sequence and quality: "
                f"{line!r}. Sequence ID: {name}"
            )

        name_starts = starts[id_idx] + 1
        name_lens = lens[id_idx] - 1
        names: Optional[List[str]] = None  # decoded only when needed
        seq_lens = lens[id_idx + 1]
        qual_lens = lens[id_idx + 3]
        W = int(max(seq_lens.max(), qual_lens.max()))
        seq = gather_padded(a, starts[id_idx + 1], seq_lens, W)
        qual = gather_padded(a, starts[id_idx + 3], qual_lens, W)

        def qmask_of():
            return np.arange(W)[None, :] < qual_lens[:, None]

        if filter_failed:
            # filter-failed-qc needs the Casava filter flag — parse ids
            # with the same stateful rule the record loop used.
            names = decode_slices(a, name_starts, name_lens)
            keep = np.ones(n, dtype=bool)
            probing = True
            for i, nm in enumerate(names):
                if not probing:
                    break
                m = ILLUMINA_PATTERN.fullmatch(nm)
                if m is None:
                    probing = False
                elif m.group(9) == "Y":
                    keep[i] = False
            if not keep.all():
                sel = np.nonzero(keep)[0]
                names = [names[i] for i in sel]
                seq, qual = seq[sel], qual[sel]
                seq_lens, qual_lens = seq_lens[sel], qual_lens[sel]
                name_starts, name_lens = name_starts[sel], name_lens[sel]
                n = len(sel)

        if encoding == "illumina":
            qmask = qmask_of()
            q16 = qual.astype(np.int16)
            inr = (q16 >= ILLUMINA_OFFSET) & (
                q16 <= ILLUMINA_OFFSET + ILLUMINA_MAX
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
                qmask, (q16 - (ILLUMINA_OFFSET - SANGER_OFFSET)), 0
            ).astype(np.uint8)
        else:
            # One-pass check: (q - 33) wraps below 33 in uint8, so a single
            # compare flags both bounds; padding zeros wrap too, so the
            # expected violation count is exactly the padding count.
            n_bad = int(
                np.count_nonzero((qual - SANGER_OFFSET) > SANGER_MAX)
            )
            n_pad = int(qual.shape[0] * qual.shape[1] - qual_lens.sum())
            if n_bad != n_pad:
                inr = (qual >= SANGER_OFFSET) & (
                    qual <= SANGER_OFFSET + SANGER_MAX
                )
                r, c = np.argwhere(qmask_of() & ~inr)[0]
                bad_name = str(
                    memoryview(a)[
                        int(name_starts[r]) : int(name_starts[r] + name_lens[r])
                    ],
                    "utf-8",
                )
                raise FormatException(
                    "fastq base quality score out of range for Sanger "
                    f"Phred+33 format (found {int(qual[r, c]) - 33}).\n"
                    "Although Sanger format has been requested, maybe "
                    "qualities are in Illumina Phred+64 format?\n"
                    f"Sequence ID: {bad_name}"
                )

        return FragmentBatch(
            seq=seq,
            qual=qual,
            lengths=seq_lens.astype(np.int32),
            _names=names,
            name_source=(a, name_starts, name_lens),
            materializer=_fastq_materializer(qual_lens.astype(np.int32)),
        )


class FastqOutputFormat:
    """Write fragments as FASTQ (FastqOutputFormat.java semantics)."""

    def __init__(self, conf: Optional[Configuration] = None):
        self.conf = conf or Configuration()
        enc = self.conf.get(FASTQ_OUTPUT_BASE_QUALITY_ENCODING, "sanger")
        if enc not in ("sanger", "illumina"):
            raise ValueError(f"Unknown output base quality encoding {enc}")
        self.encoding = enc

    def format_record(
        self, frag: SequencedFragment, key: Optional[str] = None
    ) -> bytes:
        if frag.instrument is not None:
            # Reconstruct the Casava 1.8 id (FastqOutputFormat.java:117-145).
            name = (
                f"{frag.instrument}:{frag.run_number}:{frag.flowcell_id}:"
                f"{frag.lane}:{frag.tile}:{frag.xpos}:{frag.ypos} "
                f"{frag.read or 1}:"
                f"{'N' if frag.filter_passed in (None, True) else 'Y'}:"
                f"{frag.control_number or 0}:{frag.index_sequence or ''}"
            )
        elif key is not None:
            name = key
        else:
            name = ""
        qual = frag.quality
        if self.encoding == "illumina":
            qual = convert_quality(qual, "sanger", "illumina")
        return b"@" + name.encode() + b"\n" + frag.sequence + b"\n+\n" + qual + b"\n"

    def write(self, stream, batch: FragmentBatch) -> None:
        for name, frag in zip(batch.names, batch.fragments):
            stream.write(self.format_record(frag, key=name))
