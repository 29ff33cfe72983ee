"""The name-collation primitive on the stream's device.

Counterpart of ``hadoop_bam_tpu/collate/device.py`` (``collate_core``,
``Collation``, ``collate_by_name``).  The reference's one ``lax.sort`` over
seven signed int32 keys ``(1-act, qh1, qh2, 1-cand, tie1, tie2, idx)``
becomes three stable ``torch.sort`` passes over int64 keys, least
significant first, each key packing two of the reference's in their order
(stability supplies ``idx``); ``.at[].add``/``.at[].min`` become
``index_add_`` and ``scatter_reduce(..., "amin")``.  Rows pad to the next
power of two (at least 8) as inactive rows, as in the reference, because
the padding decides where inactive rows land in ``order``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.backend import resolve_device
from ..utils.tracing import Metrics

_I32MAX = 2**31 - 1


def _prev(a: torch.Tensor) -> torch.Tensor:
    """Row i-1's value at row i (row 0 sees itself)."""
    return torch.cat([a[:1], a[:-1]])


def _stable_order(keys) -> torch.Tensor:
    """The permutation that sorts rows lexicographically by ``keys`` (most
    significant first), ties in index order."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def collate_core(act, qh1, qh2, cand, tie1, tie2) -> Tuple[torch.Tensor, ...]:
    """The shared collation sort over int32[N] tensors.

    Returns collated-space ``(order, seg, size, csize, mated, nb)`` exactly
    as the reference's ``collate_core``: ``order`` (original index per
    collated row), ``seg`` (hash-run segment id), ``size``/``csize``
    (active / candidate rows in the row's segment), ``mated`` (one of a
    segment's exactly-2 candidates), ``nb`` (the mate's collated row; gate
    every use on ``mated``).  Index tensors are int64."""
    n = act.numel()
    i64 = lambda t: t.to(torch.int64)  # noqa: E731
    order = _stable_order((
        (1 - i64(act)) * 2**32 + i64(qh1),
        i64(qh2) * 2 + (1 - i64(cand)),
        i64(tie1) * 2**32 + (i64(tie2) + 2**31),
    ))
    idx = torch.arange(n, device=act.device)
    acts, cands = i64(act[order]), i64(cand[order])
    qh1s, qh2s = qh1[order], qh2[order]
    same = (acts & _prev(acts)).bool() & (qh1s == _prev(qh1s)) & (qh2s == _prev(qh2s))
    same[0] = False
    seg = torch.cumsum((~same).to(torch.int64), 0) - 1
    zeros = torch.zeros(n, dtype=torch.int64, device=act.device)
    size = zeros.index_add(0, seg, acts)[seg]
    csize = zeros.index_add(0, seg, cands)[seg]
    # Candidates sort first within their segment, so a 2-candidate
    # segment's mates sit at ranks 0 and 1 from the segment start.
    start = torch.full((n,), _I32MAX, dtype=torch.int64, device=act.device).scatter_reduce(
        0, seg, idx, "amin")[seg]
    crank = idx - start
    mated = (cands == 1) & (csize == 2)
    nb = torch.clamp(torch.where(crank == 0, idx + 1, idx - 1), 0, n - 1)
    return order, seg, size, csize, mated, nb


@dataclass
class Collation:
    """The host-side view of one collation pass (the reference's).

    ``order``/``group`` cover the *active* rows only, in collated order;
    ``mate`` is read order over all N rows: the mate's original index for
    rows collated into an exactly-two-candidate bucket, else -1."""

    order: np.ndarray  # int64[n_active]
    group: np.ndarray  # int32[n_active], dense 0..n_groups-1
    n_groups: int
    mate: np.ndarray  # int32[N] read order, -1 = no mate
    n_pairs: int

    def bucket_bounds(self) -> np.ndarray:
        """int64[n_groups+1]: collated-row bounds of each bucket."""
        if len(self.group) == 0:
            return np.zeros(1, dtype=np.int64)
        starts = np.flatnonzero(np.concatenate(([True], self.group[1:] != self.group[:-1])))
        return np.concatenate((starts, [len(self.group)])).astype(np.int64)


def collate_by_name(
    cols: Dict[str, np.ndarray],
    active: Optional[np.ndarray] = None,
    candidates: Optional[np.ndarray] = None,
    device: Optional[torch.device] = None,
    metrics: Optional[Metrics] = None,
) -> Collation:
    """Run the collation over read-order columns on ``device``, resolved
    as every entry point of the port resolves it: None means the card, and
    raises when there is none; the CPU runs only when asked for.  ``cols`` needs ``qh1``/``qh2``/``flag``/``pos``; ``active``
    selects the rows to group (default all); ``candidates`` the rows
    eligible for mate pairing (default ``cols['cand']``, else ``active``)."""
    dev = resolve_device(device)
    n = len(cols["qh1"])
    if n == 0:
        return Collation(order=np.empty(0, np.int64), group=np.empty(0, np.int32),
                         n_groups=0, mate=np.empty(0, np.int32), n_pairs=0)
    act = np.ones(n, np.int32) if active is None else np.asarray(active, np.int32)
    if candidates is None:
        cand = cols.get("cand")
        cand = act.copy() if cand is None else np.asarray(cand, np.int32)
    else:
        cand = np.asarray(candidates, np.int32)
    cand = cand & act  # a candidate outside the active set is meaningless
    padded = 1 << max(3, int(np.ceil(np.log2(n))))
    bank = np.zeros((6, padded), dtype=np.int32)
    for r, a in enumerate((act, cols["qh1"], cols["qh2"], cand, cols["flag"], cols["pos"])):
        bank[r, :n] = a
    t = torch.from_numpy(bank).to(dev)
    order_d, seg_d, _, _, mated_d, nb_d = collate_core(*t)
    host = torch.stack([order_d, seg_d, mated_d.to(torch.int64), nb_d]).cpu().numpy()
    if dev.type == "cuda" and metrics is not None:
        metrics.count_h2d(bank.nbytes, "collate_cols")
        metrics.count_d2h(host.nbytes, "collate")
    order, seg, mated, nb = host[0], host[1], host[2].astype(bool), host[3]

    # Active rows form the collated prefix; inactive real rows and padding
    # interleave in the tail.  Mask by the original activity column.
    act_rows = act[np.clip(order, 0, n - 1)].astype(bool) & (order < n)
    order_a = order[act_rows]
    seg_a = seg[act_rows]
    group = (
        np.cumsum(np.concatenate(([0], (seg_a[1:] != seg_a[:-1]).astype(np.int32))))
        if len(seg_a) else np.empty(0, np.int64)
    ).astype(np.int32)
    mate = np.full(n, -1, dtype=np.int32)
    m_rows = np.flatnonzero(mated)
    if len(m_rows):
        mate[order[m_rows]] = order[nb[m_rows]]
    return Collation(order=order_a, group=group,
                     n_groups=int(group[-1]) + 1 if len(group) else 0,
                     mate=mate, n_pairs=len(m_rows) // 2)
