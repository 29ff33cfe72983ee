"""SequencedFragment: the FASTQ/QSEQ record, its quality rules and the
batched container.

Counterpart of ``hadoop_bam_tpu/spec/fragment.py`` (SequencedFragment.java):
a read with sequence and quality (Sanger Phred+33 text once inside the
framework) and eleven nullable Illumina fields; the quality conversion and
verification rules of :229-309 (Sanger offset 33 in [0, 93], Illumina offset
64 in [0, 62]).  ``FormatException`` is the interval parser's
:class:`~..utils.intervals.FormatError`, so one ``except`` catches a
malformed region and a malformed record alike.  :class:`FragmentBatch` is
the SoA form: padded uint8 seq/qual arrays, lengths, and names and
per-record views made on first access.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from ..utils.intervals import FormatError as FormatException  # noqa: F401

SANGER_OFFSET = 33
SANGER_MAX = 93
ILLUMINA_OFFSET = 64
ILLUMINA_MAX = 62


@dataclass
class SequencedFragment:
    sequence: bytes = b""
    quality: bytes = b""  # text bytes in the *current* encoding
    instrument: Optional[str] = None
    run_number: Optional[int] = None
    flowcell_id: Optional[str] = None
    lane: Optional[int] = None
    tile: Optional[int] = None
    xpos: Optional[int] = None
    ypos: Optional[int] = None
    read: Optional[int] = None
    filter_passed: Optional[bool] = None
    control_number: Optional[int] = None
    index_sequence: Optional[str] = None

    def __str__(self) -> str:
        return f"{self.sequence.decode()}\t{self.quality.decode()}"


def verify_quality(quality: bytes, encoding: str) -> int:
    """Index of first out-of-range byte, -1 if ok (verifyQuality,
    SequencedFragment.java:271-309)."""
    if encoding == "illumina":
        lo, hi = ILLUMINA_OFFSET, ILLUMINA_OFFSET + ILLUMINA_MAX
    elif encoding == "sanger":
        lo, hi = SANGER_OFFSET, SANGER_OFFSET + SANGER_MAX
    else:
        raise ValueError(f"Unsupported base encoding quality {encoding}")
    a = np.frombuffer(quality, dtype=np.uint8)
    bad = (a < lo) | (a > hi)
    idx = np.nonzero(bad)[0]
    return int(idx[0]) if len(idx) else -1


def convert_quality(quality: bytes, current: str, target: str) -> bytes:
    """Range-checked ±31 shift (convertQuality, SequencedFragment.java:229-268)."""
    if current == target:
        raise ValueError(
            f"current and target quality encodings are the same ({current})"
        )
    a = np.frombuffer(quality, dtype=np.uint8).astype(np.int16)
    dist = ILLUMINA_OFFSET - SANGER_OFFSET
    if current == "illumina" and target == "sanger":
        if len(a) and (a.min() < ILLUMINA_OFFSET or a.max() > ILLUMINA_OFFSET + ILLUMINA_MAX):
            bad = int(a[(a < ILLUMINA_OFFSET) | (a > ILLUMINA_OFFSET + ILLUMINA_MAX)][0])
            raise FormatException(
                "base quality score out of range for Illumina Phred+64 format "
                f"(found {bad - ILLUMINA_OFFSET} but acceptable range is "
                f"[0,{ILLUMINA_MAX}]).\nMaybe qualities are encoded in Sanger format?\n"
            )
        return (a - dist).astype(np.uint8).tobytes()
    if current == "sanger" and target == "illumina":
        if len(a) and (a.min() < SANGER_OFFSET or a.max() > SANGER_OFFSET + SANGER_MAX):
            bad = int(a[(a < SANGER_OFFSET) | (a > SANGER_OFFSET + SANGER_MAX)][0])
            raise FormatException(
                "base quality score out of range for Sanger Phred+64 format "
                f"(found {bad - SANGER_OFFSET} but acceptable range is "
                f"[0,{SANGER_MAX}]).\nMaybe qualities are encoded in Illumina format?\n"
            )
        return (a + dist).astype(np.uint8).tobytes()
    raise ValueError(
        f"unsupported BaseQualityEncoding transformation from {current} to {target}"
    )


@dataclass
class FragmentBatch:
    """SoA batch of fragments, device-ready.

    ``seq``/``qual``: uint8[N, Lmax] 0-padded; ``lengths``: int32[N];
    metadata columns are host lists (ragged strings stay host-side).

    ``fragments`` is lazy: the readers build only the SoA arrays; the
    per-record ``SequencedFragment`` view is made on first access by the
    ``materializer`` the reader installed (names likewise from
    ``name_source``, ``(buffer, starts, lens)``).
    """

    seq: np.ndarray
    qual: np.ndarray
    lengths: np.ndarray
    _names: Optional[List[str]] = None
    name_source: Optional[tuple] = None
    _fragments: Optional[List[SequencedFragment]] = None
    materializer: Optional[Callable[["FragmentBatch"], List[SequencedFragment]]] = None

    @property
    def names(self) -> List[str]:
        if self._names is None:
            if self.name_source is None:
                self._names = [""] * self.n_records
            else:
                buf, starts, lens = self.name_source
                mv = memoryview(buf)
                self._names = [
                    str(mv[int(s) : int(s + l)], "utf-8")
                    for s, l in zip(starts, lens)
                ]
        return self._names

    @property
    def fragments(self) -> List[SequencedFragment]:
        if self._fragments is None:
            if self.materializer is not None:
                self._fragments = self.materializer(self)
            else:
                self._fragments = self._default_fragments()
        return self._fragments

    def _default_fragments(self) -> List[SequencedFragment]:
        out = []
        for i in range(self.n_records):
            ln = int(self.lengths[i])
            out.append(
                SequencedFragment(
                    sequence=self.seq[i, :ln].tobytes(),
                    quality=self.qual[i, :ln].tobytes(),
                )
            )
        return out

    @property
    def n_records(self) -> int:
        return len(self.lengths)

    def valid_mask(self) -> np.ndarray:
        L = self.seq.shape[1] if self.seq.ndim == 2 else 0
        return np.arange(L)[None, :] < self.lengths[:, None]

    @staticmethod
    def from_fragments(
        names: List[str], frags: List[SequencedFragment]
    ) -> "FragmentBatch":
        n = len(frags)
        lengths = np.array([len(f.sequence) for f in frags], dtype=np.int32)
        L = int(lengths.max()) if n else 0
        seq = np.zeros((n, L), dtype=np.uint8)
        qual = np.zeros((n, L), dtype=np.uint8)
        for i, f in enumerate(frags):
            seq[i, : len(f.sequence)] = np.frombuffer(f.sequence, np.uint8)
            qual[i, : len(f.quality)] = np.frombuffer(f.quality, np.uint8)
        return FragmentBatch(
            seq=seq, qual=qual, lengths=lengths,
            _names=list(names), _fragments=list(frags),
        )
