"""Genomic interval parsing: the `chr:start-stop[,...]` property format.

Counterpart of ``hadoop_bam_tpu/utils/intervals.py``, with the same grammar,
shorthands and errors.

Reference semantics: util/IntervalUtil.java:27-53 — a comma-separated list of
``contig:start-stop`` (1-based, inclusive) intervals stored in a single
configuration property (e.g. ``hadoopbam.bam.intervals``,
BAMInputFormat.java:89-111).  The last ``:`` splits contig from the range so
contig names may themselves contain ``:``.

On top of the reference grammar, :func:`parse_interval` accepts the two
samtools-style shorthands the ``view`` endpoint needs: a bare ``contig``
(no colon at all) means the whole contig (``1-MAX_END``), and
``contig:pos`` (numeric, no dash) means the single position ``pos-pos``.
A contig name that itself contains ``:`` still requires the explicit
``contig:start-stop`` form — the shorthand never guesses where such a
name ends (the same ambiguity samtools resolves with ``{...}`` quoting).

Bounds accept samtools-style thousands separators (``1:1,000,000-2,000,000``)
— strictly grouped (1–3 leading digits then exactly-3-digit groups), so a
stray or misplaced comma is still a :class:`FormatError`, never a silent
partial parse.  Note the *property* grammar (:func:`parse_intervals`)
splits the list on ``,`` first, so separators there would tear the list —
the shorthand belongs to single-interval surfaces (CLI regions, serve
requests), matching where samtools itself accepts it.
"""

from __future__ import annotations

import re

from dataclasses import dataclass
from typing import List, Optional

#: Strict samtools grouping: ``1,234,567`` yes; ``12,34`` / ``,123`` /
#: ``1,,2`` no.  A plain ungrouped integer is handled by int() directly.
_GROUPED_INT = re.compile(r"\d{1,3}(?:,\d{3})+$")

#: Largest representable 1-based position: the BAI binning scheme (SAM spec
#: §5.3) addresses coordinates below 2^29, so a whole-contig shorthand ends
#: here — callers with a header in hand may clamp tighter.
MAX_END = (1 << 29) - 1


class FormatError(ValueError):
    """Reference FormatException.java equivalent."""


@dataclass(frozen=True, order=True)
class Interval:
    contig: str
    start: int  # 1-based inclusive
    end: int  # 1-based inclusive

    def __str__(self) -> str:
        return f"{self.contig}:{self.start}-{self.end}"

    def overlaps(self, contig: str, start: int, end: int) -> bool:
        return contig == self.contig and start <= self.end and end >= self.start


def _parse_bound(text: str) -> int:
    """One 1-based bound: a plain integer, or a strictly-grouped
    thousands-separated one.  Raises ValueError on anything else (the
    caller wraps it in FormatError with the full interval text)."""
    if "," in text:
        if not _GROUPED_INT.fullmatch(text):
            raise ValueError(f"bad thousands grouping {text!r}")
        return int(text.replace(",", ""))
    return int(text)


def parse_interval(text: str) -> Interval:
    colon = text.rfind(":")
    if colon < 0:
        # Bare-contig shorthand: the whole contig.
        if not text:
            raise FormatError("empty interval")
        return Interval(text, 1, MAX_END)
    if colon == 0 or colon == len(text) - 1:
        raise FormatError(f"no contig:start-stop in interval '{text}'")
    contig = text[:colon]
    rng = text[colon + 1 :]
    dash = rng.find("-")
    if dash < 0:
        # Single-position shorthand: contig:pos.  Only a clean integer
        # qualifies — anything else is malformed, not a contig name (a
        # name containing ':' must use the explicit range form).
        try:
            pos = _parse_bound(rng)
        except ValueError as e:
            raise FormatError(
                f"non-integer position in interval '{text}'"
            ) from e
        if pos < 1:
            raise FormatError(f"invalid position in interval '{text}'")
        return Interval(contig, pos, pos)
    if dash == 0 or dash == len(rng) - 1:
        raise FormatError(f"no start-stop in interval '{text}'")
    try:
        start = _parse_bound(rng[:dash])
        end = _parse_bound(rng[dash + 1 :])
    except ValueError as e:
        raise FormatError(f"non-integer bound in interval '{text}'") from e
    if start < 1 or end < start:
        raise FormatError(f"invalid range in interval '{text}'")
    return Interval(contig, start, end)


def parse_intervals(prop: Optional[str]) -> Optional[List[Interval]]:
    """Parse the comma-separated property value; None/empty → None."""
    if not prop:
        return None
    return [parse_interval(part) for part in prop.split(",")]
