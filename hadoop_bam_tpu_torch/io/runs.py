"""Sorted spill runs for the bounded-memory (out-of-core) sort.

Counterpart of ``hadoop_bam_tpu/io/runs.py``, with its on-disk format byte
for byte: the same file names, ``.npy`` dtypes and shapes, and manifest
keys.  Records stream through an iterator (BAMRecordReader.java:223-232)
and Hadoop's shuffle spills sorted segments to local disk before the
reduce-side merge; this module is the spill layer:

- **Run** — one sorted chunk spilled to disk: the raw record stream
  (size-word + body per record, already in key order) plus two memmappable
  sidebands, the sorted ``int64`` keys and the ``int64`` record byte
  offsets.  Slicing a key range out of a run is two ``searchsorted`` calls
  on the memmapped keys plus one contiguous disk read — no inflate, no
  record walk.
- **plan_ranges** — exact global key-range partitioning over a set of
  sorted runs such that every range's record-byte total fits a budget.
  Because every run is sorted, range sizes are computed *exactly* (no
  sampling skew) by binary-searching the 64-bit key space with
  ``searchsorted`` sums over the memmapped key arrays; a tie bigger than
  the budget degrades to an in-tie index split that preserves run order
  (and therefore overall stability).

The merge phase concatenates per-run slices in run order and stable-sorts,
which reproduces exactly the single-pass stable sort's output order.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bam import gather_record_array

RUN_DATA_EXT = ".run"
RUN_KEYS_EXT = ".run.keys.npy"
RUN_OFFS_EXT = ".run.offs.npy"
RUN_IDX_EXT = ".run.idx.npy"
MANIFEST_NAME = "manifest.json"
_MANIFEST_VERSION = 1


def run_paths(directory: str, idx: int) -> Tuple[str, str, str, str]:
    base = os.path.join(directory, f"run-{idx:05d}")
    return (
        base + RUN_DATA_EXT,
        base + RUN_KEYS_EXT,
        base + RUN_OFFS_EXT,
        base + RUN_IDX_EXT,
    )


def write_run(
    directory: str,
    idx: int,
    batch,
    perm: np.ndarray,
    orig_idx: Optional[np.ndarray] = None,
) -> None:
    """Spill a sorted chunk: permuted raw record stream + key/offset sidebands.

    ``batch`` is a RecordBatch (or anything with ``.data``, ``.keys`` and
    ``soa['rec_off']/['rec_len']``); ``perm`` is the sort permutation.
    Writes are atomic (tmp + rename) so a crashed spill never leaves a
    half-run behind.

    ``orig_idx`` (int64, batch order) adds a third memmappable sideband:
    each spilled record's global read-order index, permuted like the
    keys.  The dedup fusion stage needs it — its duplicate mask is built
    in read order over the whole job, and the range-merge writes must map
    every range row back to that mask.  Omitted (the default) the run
    format is unchanged.
    """
    data_p, keys_p, offs_p, idx_p = run_paths(directory, idx)
    stream = gather_record_array(batch, perm)
    keys_sorted = np.ascontiguousarray(batch.keys[perm], dtype=np.int64)
    lens = batch.soa["rec_len"].astype(np.int64)[perm] + 4
    offs = np.empty(len(lens) + 1, dtype=np.int64)
    offs[0] = 0
    np.cumsum(lens, out=offs[1:])
    targets = [
        (data_p, lambda f: f.write(stream)),
        (keys_p, lambda f: np.save(f, keys_sorted)),
        (offs_p, lambda f: np.save(f, offs)),
    ]
    if orig_idx is not None:
        idx_sorted = np.ascontiguousarray(
            np.asarray(orig_idx, dtype=np.int64)[perm]
        )
        targets.append((idx_p, lambda f: np.save(f, idx_sorted)))
    for path, writer in targets:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            writer(f)
        os.replace(tmp, path)


@dataclass
class Run:
    """A spilled sorted run.

    Key/offset sidebands are memmapped (binary searches touch O(log n)
    pages); the record stream is read with ``pread`` into fresh buffers so
    spilled bytes never stay mapped into the process — peak RSS tracks the
    working set, not the spill size.
    """

    data_path: str
    keys: np.ndarray  # int64, sorted (memmap)
    offs: np.ndarray  # int64, len n+1, byte offset of each record (memmap)
    orig_idx: Optional[np.ndarray] = None  # int64, read-order index (memmap)

    @classmethod
    def open(cls, directory: str, idx: int) -> "Run":
        data_p, keys_p, offs_p, idx_p = run_paths(directory, idx)
        keys = np.load(keys_p, mmap_mode="r")
        offs = np.load(offs_p, mmap_mode="r")
        orig = (
            np.load(idx_p, mmap_mode="r") if os.path.exists(idx_p) else None
        )
        return cls(data_path=data_p, keys=keys, offs=offs, orig_idx=orig)

    @property
    def n(self) -> int:
        return len(self.keys)

    def bytes_between(self, i0: int, i1: int) -> int:
        return int(self.offs[i1]) - int(self.offs[i0])

    def slice_stream(self, i0: int, i1: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Raw bytes of records [i0, i1) — one contiguous pread, into
        ``out`` (uint8, exactly the slice's size) when given."""
        start = int(self.offs[i0])
        size = int(self.offs[i1]) - start
        if size == 0:
            return np.empty(0, dtype=np.uint8)
        if out is None:
            out = np.empty(size, dtype=np.uint8)
        with open(self.data_path, "rb") as f:
            f.seek(start)
            got = f.readinto(memoryview(out))
        if got != size:
            raise IOError(
                f"short read from spill run {self.data_path}: "
                f"{got} of {size} bytes at {start}"
            )
        return out


def input_identity(paths: Sequence[str]) -> List[Dict]:
    """File-identity fingerprints of the job inputs — ``(path, size,
    mtime_ns)``, the same identity key the serve cache uses.  A resumed
    sort must refuse checkpoints written against different bytes."""
    out: List[Dict] = []
    for p in paths:
        st = os.stat(p)
        out.append(
            {"path": p, "size": st.st_size, "mtime_ns": st.st_mtime_ns}
        )
    return out


def write_manifest(
    spill_dir: str,
    inputs: List[Dict],
    n_records: int,
    run_count: int,
    memory_budget: int,
    mark_duplicates: bool,
    sort_order: str = "coordinate",
) -> None:
    """Checkpoint the completed spill phase: inputs identity, job shape,
    and the byte size of every run sideband.  Written atomically *after*
    phase 1 finishes, so its existence certifies every run file it names
    (a ``kill -9`` mid-spill leaves no manifest → the rerun redoes phase 1
    from scratch; a kill mid-*merge* finds a valid manifest and reuses the
    runs as checkpoints)."""
    runs = []
    for k in range(run_count):
        data_p, keys_p, offs_p, idx_p = run_paths(spill_dir, k)
        entry = {
            "data": os.path.getsize(data_p),
            "keys": os.path.getsize(keys_p),
            "offs": os.path.getsize(offs_p),
        }
        if os.path.exists(idx_p):
            entry["idx"] = os.path.getsize(idx_p)
        runs.append(entry)
    doc = {
        "version": _MANIFEST_VERSION,
        "inputs": inputs,
        "n_records": n_records,
        "run_count": run_count,
        "memory_budget": memory_budget,
        "mark_duplicates": mark_duplicates,
        "sort_order": sort_order,
        "runs": runs,
    }
    path = os.path.join(spill_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def load_manifest(
    spill_dir: str,
    inputs: List[Dict],
    memory_budget: int,
    mark_duplicates: bool,
    sort_order: str = "coordinate",
) -> Optional[Dict]:
    """The validated checkpoint, or None (missing / stale / mismatched).

    Validation is conservative: same format version, same input identity
    (path+size+mtime_ns), same budget, markdup setting and sort order
    (all three change the spill plan — a coordinate checkpoint must
    never seed a queryname rerun), and every named run file present at
    its recorded size.  Anything off → redo phase 1; a checkpoint is an
    optimization, never a correctness dependency."""
    path = os.path.join(spill_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if (
        doc.get("version") != _MANIFEST_VERSION
        or doc.get("inputs") != inputs
        or doc.get("memory_budget") != memory_budget
        or bool(doc.get("mark_duplicates")) != bool(mark_duplicates)
        or doc.get("sort_order", "coordinate") != sort_order
        or doc.get("run_count") != len(doc.get("runs", []))
    ):
        return None
    for k, entry in enumerate(doc["runs"]):
        data_p, keys_p, offs_p, idx_p = run_paths(spill_dir, k)
        try:
            if (
                os.path.getsize(data_p) != entry["data"]
                or os.path.getsize(keys_p) != entry["keys"]
                or os.path.getsize(offs_p) != entry["offs"]
                or ("idx" in entry and os.path.getsize(idx_p) != entry["idx"])
            ):
                return None
        except OSError:
            return None
    return doc


# Per-run (start, stop) record-index cuts defining one key range.
RangeCut = List[Tuple[int, int]]


def plan_ranges(runs: Sequence[Run], budget: int) -> List[RangeCut]:
    """Partition the union of sorted runs into key ranges of ≤ ``budget``
    record-stream bytes each (best effort: a single record larger than the
    budget still forms a 1-record range so progress is guaranteed).

    Ranges are disjoint, cover everything, and are emitted in ascending key
    order; ties are never reordered across ranges (in-tie splits cut in run
    order, matching the stable merge's tie order).
    """
    R = len(runs)
    i = [0] * R
    out: List[RangeCut] = []

    def remaining() -> bool:
        return any(i[r] < runs[r].n for r in range(R))

    def cut_at_value(v: int) -> List[int]:
        """Per-run index of the first key > v (take everything ≤ v).

        Clamped to the current position: after an in-tie split, part of a
        tie is already consumed, and an unclamped searchsorted would point
        *before* ``i[r]`` (negative byte counts, non-termination).
        """
        return [
            max(
                i[r],
                int(np.searchsorted(runs[r].keys, v, side="right")),
            )
            for r in range(R)
        ]

    def nbytes(j: List[int]) -> int:
        return sum(runs[r].bytes_between(i[r], j[r]) for r in range(R))

    while remaining():
        lo_v = min(
            int(runs[r].keys[i[r]]) for r in range(R) if i[r] < runs[r].n
        )
        hi_v = max(
            int(runs[r].keys[runs[r].n - 1])
            for r in range(R)
            if i[r] < runs[r].n
        )
        if nbytes([runs[r].n for r in range(R)]) <= budget:
            out.append([(i[r], runs[r].n) for r in range(R)])
            break
        # Largest v with bytes(keys ≤ v) ≤ budget, by value bisection.
        lo, hi = lo_v - 1, hi_v
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if nbytes(cut_at_value(mid)) <= budget:
                lo = mid
            else:
                hi = mid - 1
        j = cut_at_value(lo)
        if nbytes(j) == 0:
            # The single smallest remaining key's tie exceeds the budget:
            # split inside the tie, consuming runs in order (stability).
            j = list(i)
            rem = budget
            progressed = False
            for r in range(R):
                if i[r] >= runs[r].n or int(runs[r].keys[i[r]]) != lo_v:
                    continue
                stop = int(
                    np.searchsorted(runs[r].keys, lo_v, side="right")
                )
                k = i[r]
                while k < stop:
                    rec = runs[r].bytes_between(k, k + 1)
                    if rec > rem and progressed:
                        break
                    rem -= rec
                    k += 1
                    progressed = True
                j[r] = k
                if k < stop:
                    break  # budget exhausted mid-tie in run order
        out.append([(i[r], j[r]) for r in range(R)])
        i = j
    return out
