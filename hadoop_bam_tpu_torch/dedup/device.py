"""The duplicate-marking decision on the stream's device.

Counterpart of ``hadoop_bam_tpu/dedup/device.py``.  The reference's
``_mark_core`` is one ``jax.jit`` program of ``lax.sort`` and scatter
reductions (no Pallas kernel); here it is torch ops, in its three passes:

1. **Collation**: the name collation core (:func:`~..collate.device.
   collate_core`) groups pair candidates by the 64-bit name hash with
   content tie-breaks; a hash run of exactly two candidates is a mated pair,
   and the mates exchange end signature, score and index.
2. **Grouping**: every row sorted by (exempt, own end signature, mated
   first, mate's end signature, index).  The reference's one sort over nine
   signed int32 keys becomes five stable ``torch.sort`` passes over int64
   keys, least significant first, each packing two of the reference's keys
   (``a * 2**32 + (b + 2**31)``) as the collation core does.
3. **Elections**: segmented arg-max by ``scatter_reduce`` on the
   reference's initial tensors (0 for the ``amax``, INT32_MAX for the
   ``amin``, ``include_self=True``): pairs by their int32 pair score,
   fragments by their own score; a fragment loses to any pair sharing its
   end.  Ties break on the name hash and the flag before the index, so the
   decision does not depend on the input order.

Rows pad to the next power of two (at least 8) as exempt rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..collate.device import _prev, _stable_order, collate_core
from ..utils.backend import resolve_device
from ..utils.tracing import Metrics
from .signature import _COLUMNS

_I32MAX = 2**31 - 1


def _pack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One int64 key that orders like the int32 pair ``(a, b)``."""
    return a.to(torch.int64) * 2**32 + (b.to(torch.int64) + 2**31)


def _segments(same: torch.Tensor) -> torch.Tensor:
    """Segment ids from a "same as the row before" mask (row 0 starts one)."""
    same[0] = False
    return torch.cumsum((~same).to(torch.int64), 0) - 1


def _mark_core(refid, pos5, rev, exempt, cand, score, qh1, qh2, flag) -> torch.Tensor:
    """bool[N] duplicate mask from int32[N] columns (N padded)."""
    n = refid.numel()
    dev = refid.device
    i64 = lambda t: t.to(torch.int64)  # noqa: E731
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    imax = torch.full((n,), _I32MAX, dtype=torch.int64, device=dev)

    def elect(seg, member, score_col, tie_cols):
        """Each segment's winner rows: the largest ``score_col``, ties
        resolved by successive minima over ``tie_cols``."""
        best = zeros.scatter_reduce(0, seg, torch.where(member, score_col, -1), "amax",
                                    include_self=True)[seg]
        sel = member & (score_col == best)
        for c in tie_cols:
            m = imax.scatter_reduce(0, seg, torch.where(sel, c, _I32MAX), "amin",
                                    include_self=True)[seg]
            sel = sel & (c == m)
        return sel

    # Pass 1: the name collation of the pair candidates.
    idxs, _, _, _, mated, nb = collate_core(cand, qh1, qh2, cand, flag, pos5)
    refids, pos5s, revs = i64(refid[idxs]), i64(pos5[idxs]), i64(rev[idxs])
    exempts, flags = i64(exempt[idxs]), i64(flag[idxs])
    qh1s, qh2s = i64(qh1[idxs]), i64(qh2[idxs])
    scores = i64(score[idxs])
    m_refid = torch.where(mated, refids[nb], 0)
    m_pos5 = torch.where(mated, pos5s[nb], 0)
    m_rev = torch.where(mated, revs[nb], 0)
    # The pair score is the int32 sum, wrapping as the reference's does.
    pscore = torch.where(mated, ((scores + scores[nb] + 2**31) & 0xFFFFFFFF) - 2**31, 0)
    pidx = torch.where(mated, torch.minimum(idxs, idxs[nb]), 0)
    nmated = 1 - i64(mated)

    # Pass 2: the signature grouping.
    p2 = _stable_order((_pack(exempts, refids), _pack(pos5s, revs), _pack(nmated, m_refid),
                        _pack(m_pos5, m_rev), idxs))
    refid3, pos53, rev3 = refids[p2], pos5s[p2], revs[p2]
    ex3 = exempts[p2] != 0
    mated3 = mated[p2]
    idx3, score3 = idxs[p2], scores[p2]
    qh1_3, qh2_3, flag3 = qh1s[p2], qh2s[p2], flags[p2]
    mr3, mp3, mv3 = m_refid[p2], m_pos5[p2], m_rev[p2]
    pscore3, pidx3 = pscore[p2], pidx[p2]
    ekey_same = (refid3 == _prev(refid3)) & (pos53 == _prev(pos53)) & (rev3 == _prev(rev3))
    eseg = _segments(~ex3 & ~_prev(ex3) & ekey_same)

    # Pass 3: the elections.
    any_pair = zeros.scatter_reduce(0, eseg, i64(mated3), "amax", include_self=True)[eseg] > 0
    frag3 = ~ex3 & ~mated3
    sel_f = elect(eseg, frag3, score3, (qh1_3, qh2_3, flag3, idx3))
    frag_dup = frag3 & (any_pair | ~sel_f)
    pseg = _segments(mated3 & _prev(mated3) & ekey_same & (mr3 == _prev(mr3))
                     & (mp3 == _prev(mp3)) & (mv3 == _prev(mv3)))
    # Every pair tie-break column is the pair's (the name hash is both
    # mates'), so the two row-side groups of a family elect alike.
    sel_p = elect(pseg, mated3, pscore3, (qh1_3, qh2_3, pidx3))
    pair_dup = mated3 & ~sel_p
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    out[idx3] = frag_dup | pair_dup
    return out


def mark_duplicates_device(cols: Dict[str, np.ndarray], device: Optional[torch.device] = None,
                           metrics: Optional[Metrics] = None) -> np.ndarray:
    """bool[N] duplicate mask (read order) from the job's signature columns,
    decided on ``device``, resolved as every entry point of the port
    resolves it: None means the card, and raises when there is none.  The
    columns go up in one upload and the mask comes back in one read-back,
    counted into ``metrics``; on the card the decision's device time, by
    CUDA events, is counted there too (``dedup.decision_device_us``)."""
    dev = resolve_device(device)
    n = len(cols["refid"])
    if n == 0:
        return np.zeros(0, dtype=bool)
    padded = 1 << max(3, int(np.ceil(np.log2(n))))
    bank = np.zeros((len(_COLUMNS), padded), dtype=np.int32)
    for r, k in enumerate(_COLUMNS):
        bank[r, :n] = cols[k]
    bank[_COLUMNS.index("exempt"), n:] = 1  # the padding never takes part
    cols_d = torch.from_numpy(bank).to(dev)
    timed = dev.type == "cuda" and metrics is not None
    if timed:
        span = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        span[0].record()
    dup_d = _mark_core(*cols_d)
    if timed:
        span[1].record()
    dup = dup_d[:n].cpu().numpy()
    if timed:
        metrics.count_h2d(bank.nbytes, "dedup_cols")
        metrics.count_d2h(dup.nbytes, "dup_mask")
        metrics.count("dedup.decision_device_us", round(span[0].elapsed_time(span[1]) * 1e3))
    return dup
