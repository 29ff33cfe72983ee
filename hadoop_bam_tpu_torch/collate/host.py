"""Host finishing passes over a collation.

Counterpart of ``hadoop_bam_tpu/collate/host.py``: bucket verification
against the actual name bytes with exact repair of hash collisions,
samtools' ``strnum_cmp`` natural name order (the comparator, and the byte
keys with its order that the queryname permutation sorts by), the queryname
permutation and the pair census.  Host numpy, as in the reference; the collation itself runs
on the caller's device (:func:`~.device.collate_by_name`).  Counters go to
the caller's :class:`~..utils.tracing.Metrics`.
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..spec.bam import FLAG_PAIRED
from ..utils.backend import resolve_device
from ..utils.tracing import Metrics, span
from .device import Collation, collate_by_name


def natural_compare(a: bytes, b: bytes) -> int:
    """samtools ``strnum_cmp`` (bam_sort.c), bit for bit: runs of digits
    compare numerically (leading zeros skipped; equal values with
    different zero counts order by consumed length, more zeros first),
    everything else by byte value.  Returns <0, 0, >0."""
    i = j = 0
    la, lb = len(a), len(b)
    while i < la and j < lb:
        ca, cb = a[i], b[j]
        da, db = 0x30 <= ca <= 0x39, 0x30 <= cb <= 0x39
        if da and db:
            while i < la and a[i] == 0x30:
                i += 1
            while j < lb and b[j] == 0x30:
                j += 1
            while (
                i < la and j < lb
                and 0x30 <= a[i] <= 0x39 and 0x30 <= b[j] <= 0x39
                and a[i] == b[j]
            ):
                i += 1
                j += 1
            da = i < la and 0x30 <= a[i] <= 0x39
            db = j < lb and 0x30 <= b[j] <= 0x39
            if da and db:
                k = 0
                while (
                    i + k < la and j + k < lb
                    and 0x30 <= a[i + k] <= 0x39
                    and 0x30 <= b[j + k] <= 0x39
                ):
                    k += 1
                if i + k < la and 0x30 <= a[i + k] <= 0x39:
                    return 1
                if j + k < lb and 0x30 <= b[j + k] <= 0x39:
                    return -1
                return int(a[i]) - int(b[j])
            if da:
                return 1
            if db:
                return -1
            if i != j:
                return 1 if i < j else -1
        else:
            if ca != cb:
                return int(ca) - int(cb)
            i += 1
            j += 1
    if i < la:
        return 1
    if j < lb:
        return -1
    return 0


natural_sort_key = functools.cmp_to_key(natural_compare)

_DIGIT_RUNS = re.compile(rb"([0-9]+)")


def _digit_run_key(run: bytes) -> bytes:
    sig = run.lstrip(b"0")
    zeros = len(run) - len(sig)
    return b"0" + len(sig).to_bytes(4, "big") + sig + (0xFFFFFFFF - zeros).to_bytes(4, "big")


def natural_keys(names: List[bytes]) -> List[bytes]:
    """One byte string a name whose plain byte order is
    :func:`natural_compare`'s order: each digit run becomes ``'0'``, its
    significant length (4 bytes), its significant digits and the complement
    of its leading zeros (4 bytes), so runs compare by value, then more zeros
    first, and against any other byte as a digit does; every other byte
    stays itself."""
    runs: Dict[bytes, bytes] = {}
    out = []
    for name in names:
        parts = _DIGIT_RUNS.split(name)
        for i in range(1, len(parts), 2):
            r = parts[i]
            k = runs.get(r)
            if k is None:
                k = runs[r] = _digit_run_key(r)
            parts[i] = k
        out.append(b"".join(parts))
    return out


def _name_bytes(cols: Dict[str, np.ndarray], row: int) -> bytes:
    o = int(cols["name_off"][row])
    return cols["names"][o : o + int(cols["name_len"][row])].tobytes()


def _adjacent_equal_mask(cols: Dict[str, np.ndarray], left: np.ndarray,
                         right: np.ndarray) -> np.ndarray:
    """bool per (left, right) row pair: identical name bytes (one ragged
    gather per side, one ``minimum.reduceat``)."""
    ll = cols["name_len"][left].astype(np.int64)
    lr = cols["name_len"][right].astype(np.int64)
    eq = ll == lr
    rows = np.flatnonzero(eq & (ll > 0))
    if len(rows) == 0:
        return eq
    lens = ll[rows]
    starts = np.cumsum(lens) - lens
    within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(starts, lens)
    li = np.repeat(cols["name_off"][left[rows]], lens) + within
    ri = np.repeat(cols["name_off"][right[rows]], lens) + within
    match = (cols["names"][li] == cols["names"][ri]).astype(np.int8)
    eq[rows] = np.minimum.reduceat(match, starts).astype(bool)
    return eq


def verify_and_repair(col: Collation, cols: Dict[str, np.ndarray],
                      metrics: Optional[Metrics] = None) -> Tuple[Collation, int]:
    """Prove every hash bucket name-homogeneous; exactly regroup (and
    re-pair) the ones that aren't.  Returns the verified collation and the
    number of buckets that held a hash collision (counted as
    ``collate.hash_collisions``)."""
    n_act = len(col.order)
    if n_act == 0:
        return col, 0
    same_group = np.concatenate(([False], col.group[1:] == col.group[:-1]))
    pairs = np.flatnonzero(same_group)
    ok = np.ones(n_act, dtype=bool)
    if len(pairs):
        ok[pairs] = _adjacent_equal_mask(cols, col.order[pairs - 1], col.order[pairs])
    bad_rows = np.flatnonzero(~ok)
    if len(bad_rows) == 0:
        return col, 0
    bad_groups = np.unique(col.group[bad_rows])
    bounds = col.bucket_bounds()
    order = col.order.copy()
    mate = col.mate.copy()
    # Subgroup tag per collated row: distinct names of a repaired bucket get
    # distinct tags, so the dense renumber below splits exactly those.
    subtag = np.zeros(n_act, dtype=np.int64)
    for g in bad_groups:
        b0, b1 = int(bounds[g]), int(bounds[g + 1])
        by_name: Dict[bytes, list] = {}
        for r in order[b0:b1]:
            by_name.setdefault(_name_bytes(cols, int(r)), []).append(int(r))
        new_rows = []
        for t, name in enumerate(sorted(by_name)):
            members = by_name[name]
            new_rows.extend(members)
            subtag[b0 + len(new_rows) - len(members) : b0 + len(new_rows)] = t
            # Exactly two candidates sharing the actual name are mates.
            cands = [r for r in members if cols["cand"][r]]
            for r in members:
                mate[r] = -1
            if len(cands) == 2:
                mate[cands[0]], mate[cands[1]] = cands[1], cands[0]
        order[b0:b1] = new_rows
    boundary = np.concatenate(
        ([True], (col.group[1:] != col.group[:-1]) | (subtag[1:] != subtag[:-1])))
    group = (np.cumsum(boundary) - 1).astype(np.int32)
    n_coll = int(len(bad_groups))
    if metrics is not None:
        metrics.count("collate.hash_collisions", n_coll)
    return (
        Collation(order=order, group=group, n_groups=int(group[-1]) + 1, mate=mate,
                  n_pairs=int((mate >= 0).sum()) // 2),
        n_coll,
    )


@dataclass
class QuerynameStats:
    n_records: int
    n_groups: int
    n_collisions: int


def queryname_perm(cols: Dict[str, np.ndarray], device=None,
                   metrics: Optional[Metrics] = None) -> Tuple[np.ndarray, QuerynameStats]:
    """The queryname-sort output permutation (int64[N], read-order indices
    in output order): samtools natural name order, then flag, position and
    read index.  The collation groups by hash on ``device`` (None: the
    card, which raises when there is none); the host sorts only the
    verified bucket representatives, and one ``lexsort`` finishes."""
    device = resolve_device(device)
    n = len(cols["qh1"])
    if n == 0:
        return np.empty(0, np.int64), QuerynameStats(0, 0, 0)
    with span("collate.stage.device", category="stage"):
        col = collate_by_name(cols, candidates=np.zeros(n, np.int32), device=device,
                              metrics=metrics)
    with span("collate.stage.verify", category="stage"):
        col, n_coll = verify_and_repair(col, cols, metrics)
    with span("collate.stage.rank", category="stage"):
        bounds = col.bucket_bounds()
        reps = [_name_bytes(cols, int(col.order[int(bounds[g])])) for g in range(col.n_groups)]
        keys = natural_keys(reps)
        by_name = sorted(range(col.n_groups), key=keys.__getitem__)
        rank_of_group = np.empty(col.n_groups, dtype=np.int64)
        rank_of_group[by_name] = np.arange(col.n_groups, dtype=np.int64)
        grank = np.empty(n, dtype=np.int64)
        grank[col.order] = rank_of_group[col.group]
        perm = np.lexsort((cols["pos"].astype(np.int64), cols["flag"].astype(np.int64),
                           grank)).astype(np.int64)
    if metrics is not None:
        metrics.count("collate.groups", col.n_groups)
    return perm, QuerynameStats(n, col.n_groups, n_coll)


def group_representatives(cols: Dict[str, np.ndarray], col: Collation) -> List[bytes]:
    """One name (bytes) a verified bucket, by group id: after
    :func:`verify_and_repair` every bucket holds one name, so its first
    collated row speaks for it.  The per-process half of the multi-process
    rank pass, which gathers one name a group, never one a record."""
    bounds = col.bucket_bounds()
    return [_name_bytes(cols, int(col.order[int(bounds[g])])) for g in range(col.n_groups)]


def global_name_ranks(rep_lists) -> Dict[bytes, int]:
    """The dense rank of every distinct name of the lists, in samtools'
    natural order.  Every process ranks the same gathered lists, so the
    ranks agree without a coordinator; two different names whose hashes
    collide are two names here."""
    union = sorted(set().union(*rep_lists)) if rep_lists else []
    keys = natural_keys(union)
    ordered = sorted(range(len(union)), key=keys.__getitem__)
    return {union[i]: r for r, i in enumerate(ordered)}


def collation_counts(cols: Dict[str, np.ndarray], col: Collation,
                     metrics: Optional[Metrics] = None) -> Dict[str, int]:
    """The census: ``pairs`` (mated pairs), ``singletons`` (records with
    FLAG_PAIRED unset), ``orphans`` (pairing candidates whose mate never
    collated), each also counted as ``collate.<name>``."""
    counts = {
        "pairs": col.n_pairs,
        "singletons": int(((cols["flag"] & FLAG_PAIRED) == 0).sum()),
        "orphans": int(((cols["cand"] == 1) & (col.mate < 0)).sum()),
    }
    if metrics is not None:
        for k, v in counts.items():
            metrics.count(f"collate.{k}", v)
    return counts
