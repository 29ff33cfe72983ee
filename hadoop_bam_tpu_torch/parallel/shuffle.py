"""Range-partitioned distributed sort: the MapReduce shuffle as an exchange
between mesh shards.

Counterpart of ``hadoop_bam_tpu/parallel/shuffle.py``.  The reference
sorts by shipping ``(refIdx<<32|pos0)``-keyed records through Hadoop's
shuffle to range-partitioned reducers (BAMRecordReader.java:81-121 +
total-order partitioner, SURVEY.md §3.5).  Here every shard of a
:class:`~.mesh.Mesh` runs the same steps:

1. it sorts its valid keys and contributes ``S`` evenly spaced samples;
   the samples of every shard are gathered and sorted, and ``D-1``
   splitters are cut at the quantiles of their valid prefix (the splitter
   election a total-order partitioner does host-side),
2. each row's destination shard is the count of splitters <= its key
   (ties stay on one shard, so no cross-shard stability issue),
3. each row takes the slot of its stable rank within its destination in
   the shard's ``[D, capacity]`` send buffers (rows past the capacity are
   counted, never silently dropped),
4. :func:`_exchange` moves shard i's bucket j to shard j (the shuffle's
   data plane),
5. each shard sorts what it received on ``(invalid, key, [key2,] orig)``;
   the shards' outputs in mesh order are the global order.

The key travels as one packed int64 (:mod:`~..ops.keys`), whose signed
order is the reference's (hi int32, lo uint32) pair order; the payload is
(src_dev, src_row), so the host can permute the ragged record bytes
afterwards.  The shards that sit on one device run each step batched over
a leading shard axis, so the launches do not grow with the shard count,
and their exchange is one ``[D, D, cap]`` transpose on that device; shards
on different devices exchange by a copy to each peer.  On a mesh whose
shards live in several processes (a :class:`~.mesh.ProcessLayout`) every
process runs the steps on its own shards: the samples are gathered from
every process, so all cut the same splitters, the buckets cross in one
``all_to_all_single`` regrouped by destination process, and the overflow
is summed over the processes.  Every step is a torch op: the reference's
are plain XLA programs (``lax.sort``, ``argsort``, ``searchsorted``, a
scatter, ``all_to_all``), not Pallas kernels.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.keys import pack_keys_np
from .mesh import Mesh

#: Bytes one routed row carries across the five :func:`_exchange` buffers
#: (key int64 + valid bool + src_dev int32 + src_row int32 + orig int32),
#: the reference's six all_to_all buffers with its (hi, lo) pair packed:
#: the key-plane cost of shipping one record's key to its destination.
#: Padding slots of the fixed ``[D, capacity]`` send buffers also cross
#: but carry no record, so they are not counted.  A two-word sort
#: (``key_words=2``, queryname's (rank, flag|pos) pair) ships one more
#: int64 buffer; use the instance's ``key_row_bytes`` for accounting.
KEY_ROW_BYTES = 21
_WORD2_BYTES = 8  # the second key word per routed row when key_words=2
#: The reference's pad key (hi 0x7FFFFFFF, lo 0xFFFFFFFF): the largest int64.
_KEY_PAD = (0x7FFFFFFF << 32) | 0xFFFFFFFF
_ORIG_PAD = 0x7FFFFFFF
#: Bytes ``sort_global`` uploads a placed row (key int64 + valid bool +
#: orig int32); the shard and row columns are made on the device.
_UPLOAD_ROW_BYTES = 13
_PLACEMENT_SEED = 0xB462


class ShuffleCapacityError(RuntimeError):
    """Rows overflowed a (source, destination) pair's capacity even after
    the doubled-capacity retry.  The one error of a shuffle that a caller
    may answer with a larger capacity: a card failure is another
    ``RuntimeError`` and propagates."""


class ShuffleResult(NamedTuple):
    """The columns of this process's shards (every shard on a one-process
    mesh), in global shard order from ``mesh.first_shard``: ``L`` shards,
    ``D*C`` rows each."""

    hi: torch.Tensor  # int32[L*D*C] sorted within+across shards
    lo: torch.Tensor  # uint32[L*D*C]
    valid: torch.Tensor  # bool[L*D*C]
    src_dev: torch.Tensor  # int32[L*D*C]
    src_row: torch.Tensor  # int32[L*D*C]
    overflow: torch.Tensor  # int32[] — rows that did not fit, every process's (must be 0)
    dest: torch.Tensor  # int32[L*rows] — destination shard of each INPUT row
    # (-1 for an invalid row: the sender-side routing table that the
    # multi-host byte shuffle ships record payloads by)


class _Routed(NamedTuple):
    """One device group's outputs: ``[k, D*C]`` columns, ``[k, rows]``
    destinations and the group's overflow count."""

    key: torch.Tensor
    valid: torch.Tensor
    src_dev: torch.Tensor
    src_row: torch.Tensor
    overflow: torch.Tensor
    dest: torch.Tensor


def _exchange_processes(buffers: Sequence[Sequence[torch.Tensor]],
                        mesh: Mesh) -> List[List[torch.Tensor]]:
    """:func:`_exchange` across the processes of ``mesh.layout``: this
    process's ``L`` shards (one device group) send their ``[L, D, C]``
    buckets, every column's bytes side by side, regrouped by destination
    process into one ``all_to_all_single``."""
    lay = mesh.layout
    L, P = len(mesh), lay.num_processes
    cols = [col[0] for col in buffers]
    parts = [c.contiguous().view(torch.uint8).view(L, P, L, -1) for c in cols]
    widths = [p.shape[-1] for p in parts]
    send = torch.cat(parts, dim=3).transpose(0, 1)  # [P (dst), L (src), L (dst), bytes]
    recv = lay.all_to_all(send)  # [P (src), L (src), L (dst), bytes]
    recv = recv.permute(2, 0, 1, 3).reshape(L, P * L, -1)  # [L (dst), D (src), bytes]
    out, at = [], 0
    for c, w in zip(cols, widths):
        out.append([recv[..., at : at + w].contiguous().view(c.dtype)])
        at += w
    return out


def _exchange(buffers: Sequence[Sequence[torch.Tensor]], mesh: Mesh) -> List[List[torch.Tensor]]:
    """The shuffle's data plane.  ``buffers`` holds one entry per column;
    a column holds one ``[k, D, C]`` send buffer per device group of
    ``mesh`` (:meth:`~.mesh.Mesh.groups`; ``k`` its shards), bucket j of
    shard i bound for shard j.  Returns the columns as received: per
    group ``[k, D, C]``, bucket i of shard j from shard i.  One group is
    one transpose on its device; otherwise each group takes its shards'
    buckets from every group, a copy to the peer's device; across
    processes, :func:`_exchange_processes`."""
    if mesh.layout is not None:
        return _exchange_processes(buffers, mesh)
    groups = mesh.groups()
    out: List[List[torch.Tensor]] = []
    for col in buffers:
        if len(groups) == 1:
            out.append([col[0].transpose(0, 1).contiguous()])
            continue
        recv = []
        for dev, t0, t1 in groups:
            pieces = [b[:, t0:t1].to(dev) for b in col]  # [k_g, k_h, C] from each group g
            recv.append(torch.cat(pieces).transpose(0, 1).contiguous())
        out.append(recv)
    return out


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-wise stable lexicographic order of ``[k, n]`` columns, the most
    significant first: one stable argsort a column, least significant
    first."""
    idx = None
    for col in reversed(keys):
        c = col if idx is None else col.gather(1, idx)
        o = torch.argsort(c, dim=1, stable=True)
        idx = o if idx is None else idx.gather(1, o)
    return idx


def placement(keys: np.ndarray, total: int, valid: Optional[np.ndarray] = None):
    """``sort_global``'s randomized placement of ``keys`` over ``total``
    rows: ``(key, valid, orig)`` columns, the pad key and an invalid flag
    in the rows no key takes, and ``orig`` each row's input ordinal (the
    rows past the input count on from ``len(keys)``).  A block-concentrated
    layout (e.g. an already-sorted input) would otherwise route one shard's
    whole batch into a single (src, dst) pair and overflow its capacity."""
    n = len(keys)
    scatter = np.random.default_rng(_PLACEMENT_SEED).permutation(total)
    key = np.full(total, _KEY_PAD, np.int64)
    v = np.zeros(total, dtype=bool)
    key[scatter[:n]] = keys
    v[scatter[:n]] = True if valid is None else valid
    orig = np.empty(total, dtype=np.int64)
    orig[scatter] = np.arange(total)
    return key, v, orig


def _packed(hi, lo) -> torch.Tensor:
    """The int64 key of an (int32 hi, uint32 lo) pair (tensors or arrays)."""
    hi = torch.as_tensor(hi)
    lo = torch.as_tensor(lo)
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) & 0xFFFFFFFF)


class DistributedSort:
    """A distributed sort over a fixed mesh/shape configuration."""

    def __init__(
        self,
        mesh: Mesh,
        rows_per_device: int,
        capacity_per_pair: Optional[int] = None,
        samples_per_device: int = 64,
        key_words: int = 1,
        splitters: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ):
        if key_words not in (1, 2):
            raise ValueError(f"key_words must be 1 or 2, got {key_words}")
        self.mesh = mesh
        self.n_devices = mesh.devices.size
        self.rows = rows_per_device
        d = self.n_devices
        # Default capacity: perfectly balanced load + 60% headroom.
        self.capacity = capacity_per_pair or max(
            16, int(np.ceil(rows_per_device / d * 1.6))
        )
        self.samples = samples_per_device
        self.key_words = key_words
        #: Wire bytes per routed row across the exchange buffers (see
        #: KEY_ROW_BYTES); two-word keys ship 8 more per row.
        self.key_row_bytes = KEY_ROW_BYTES + (
            _WORD2_BYTES if key_words == 2 else 0
        )
        # Explicit range splitters on the primary word, np arrays of
        # shape [D-1].  When given, the per-round sample election is
        # skipped entirely: the adaptive-repartition hook, where the host
        # re-cuts balanced quantiles from a key reservoir and hands the
        # mesh a corrected partitioner.
        if splitters is not None:
            sp_hi, sp_lo = splitters
            sp_hi = np.asarray(sp_hi, np.int32)
            sp_lo = np.asarray(sp_lo, np.uint32)
            if sp_hi.shape != (d - 1,) or sp_lo.shape != (d - 1,):
                raise ValueError(
                    f"splitters must be [{d - 1}] arrays, got "
                    f"{sp_hi.shape}/{sp_lo.shape}"
                )
            self.splitters = (sp_hi, sp_lo)
        else:
            self.splitters = None

    # -- the per-shard steps ------------------------------------------------

    def _elect(self, placed) -> torch.Tensor:
        """The ``[D-1]`` splitters (sorted int64) on the first group's
        device: the given ones, else the quantiles of every shard's samples
        (of every process's shards).  A shard with no valid row contributes
        pad samples flagged invalid, so they cannot poison the cuts."""
        d, S = self.n_devices, self.samples
        dev0 = self.mesh.groups()[0][0]
        if self.splitters is not None:
            # The count of splitters <= a key does not depend on their order.
            sp = np.sort(pack_keys_np(*self.splitters))
            return torch.from_numpy(sp).to(dev0)
        samples, oks = [], []
        for key, valid, _, _ in placed:
            # Only the values of the valid prefix are read, so the invalid
            # rows may sink as the pad key.
            srt = torch.sort(torch.where(valid, key, _KEY_PAD), dim=1).values
            nvalid = valid.sum(1)
            pos = (torch.arange(S, device=key.device)[None, :]
                   * torch.clamp(nvalid, min=1)[:, None]) // S
            ok = (nvalid > 0)[:, None].expand(-1, S)
            samples.append(torch.where(ok, srt.gather(1, pos), _KEY_PAD).reshape(-1).to(dev0))
            oks.append(ok.reshape(-1).to(dev0))
        all_ok, all_samples = torch.cat(oks), torch.cat(samples)
        lay = self.mesh.layout
        if lay is not None:
            all_ok = lay.all_gather(all_ok).reshape(-1)
            all_samples = lay.all_gather(all_samples).reshape(-1)
        g = torch.sort(torch.where(all_ok, all_samples, _KEY_PAD)).values
        n_ok = all_ok.sum()
        # Quantile cuts over the valid sample prefix only.
        cut = torch.clamp(torch.arange(1, d, device=dev0) * n_ok // d, 0, d * S - 1)
        return g[cut]

    def _step(self, placed) -> List[_Routed]:
        """The sort of ``placed`` (per device group: ``[k, rows]`` key,
        valid, orig and key2 (or None) on the group's device)."""
        d, rows, cap = self.n_devices, self.rows, self.capacity
        groups = self.mesh.groups()
        first = self.mesh.first_shard
        sp = self._elect(placed)
        send: List[List[torch.Tensor]] = [[] for _ in range(6 if self.key_words == 2 else 5)]
        overflow, dests = [], []
        for (dev, s0, s1), (key, valid, orig, key2) in zip(groups, placed):
            k = s1 - s0
            # Destination: the count of splitters <= the key ("right" keeps
            # ties together on the lower shard).
            dest = torch.searchsorted(sp.to(dev), key, right=True)
            # Rank within the destination among the shard's valid rows.
            d_eff = torch.where(valid, dest, d)
            order = torch.argsort(d_eff, dim=1, stable=True)
            counts = torch.zeros(k, d + 1, dtype=torch.int64, device=dev)
            counts.scatter_add_(1, d_eff, torch.ones_like(d_eff))
            start = torch.cumsum(counts, 1) - counts
            rank_sorted = torch.arange(rows, device=dev)[None, :] - start.gather(
                1, d_eff.gather(1, order))
            rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
            fits = valid & (rank < cap)
            base = (torch.arange(k, device=dev) * (d * cap))[:, None]
            slot = torch.where(fits, base + dest * cap + rank, k * d * cap).reshape(-1)
            overflow.append((valid & ~fits).sum())
            dests.append(torch.where(valid, dest, -1).to(torch.int32))

            def scatter(col, pad):
                buf = torch.full((k * d * cap + 1,), pad, dtype=col.dtype, device=dev)
                buf.scatter_(0, slot, col.reshape(-1))
                return buf[:-1].view(k, d, cap)  # the last slot takes the dropped rows

            shard = torch.arange(first + s0, first + s1, dtype=torch.int32, device=dev)[:, None]
            cols = [scatter(key, _KEY_PAD), scatter(valid, False),
                    scatter(shard.expand(k, rows), -1),
                    scatter(torch.arange(rows, dtype=torch.int32, device=dev).expand(k, rows), -1),
                    scatter(orig, _ORIG_PAD)]
            if key2 is not None:
                cols.append(scatter(key2, _KEY_PAD))
            for c, b in zip(send, cols):
                c.append(b)
        recv = _exchange(send, self.mesh)
        out = []
        for gi, (dev, s0, s1) in enumerate(groups):
            r = [c[gi].reshape(s1 - s0, d * cap) for c in recv]
            r_key, r_val, r_dev, r_row, r_org = r[:5]
            words = [r_key] + r[5:]  # key, [key2]
            # ``orig`` is the last key, so tie order equals input order.
            idx = _lexsort([(~r_val).to(torch.uint8)] + words + [r_org])
            out.append(_Routed(r_key.gather(1, idx), r_val.gather(1, idx),
                               r_dev.gather(1, idx), r_row.gather(1, idx),
                               overflow[gi], dests[gi]))
        return out

    def _place(self, key, valid, orig, key2) -> list:
        """``[L*rows]`` columns (this process's ``L`` shards) → per device
        group ``[k, rows]`` tensors on the group's device."""
        total = len(self.mesh) * self.rows
        if key.numel() != total:
            raise ValueError(f"inputs must be [{total}] (L*rows), got {tuple(key.shape)}")
        placed = []
        for dev, s0, s1 in self.mesh.groups():
            a, b, k = s0 * self.rows, s1 * self.rows, s1 - s0

            def part(col):
                return col.reshape(-1)[a:b].to(dev).view(k, self.rows)

            placed.append((part(key), part(valid.to(torch.bool)), part(orig.to(torch.int32)),
                           None if key2 is None else part(key2)))
        return placed

    def _overflow(self, routed: List[_Routed]) -> torch.Tensor:
        """The rows past a pair's capacity, summed over every process
        (int64, on the first group's device)."""
        dev0 = self.mesh.groups()[0][0]
        ovf = torch.stack([r.overflow.to(dev0) for r in routed]).sum()
        if self.mesh.layout is not None:
            ovf = self.mesh.layout.all_gather(ovf.reshape(1)).sum()
        return ovf

    # -- host-facing API ----------------------------------------------------

    def __call__(
        self,
        hi,
        lo,
        valid,
        orig=None,
        hi2=None,
        lo2=None,
    ) -> ShuffleResult:
        """Inputs are [L*rows] tensors or arrays of this process's ``L``
        shards (all ``D`` on a one-process mesh; any device, each shard's
        rows move to its device).

        ``orig`` (int32 global input ordinals) makes tie order
        deterministic (input order); omitted → arbitrary tie order.
        ``hi2``/``lo2`` carry the secondary key word and are required
        iff the sorter was built with ``key_words=2`` (routing stays on
        the primary word; the secondary word orders rows after
        arrival).  The result's columns are the shards' outputs in mesh
        order, on the first shard's device."""
        key = _packed(hi, lo)
        valid = torch.as_tensor(valid)
        if orig is None:
            orig = torch.zeros(key.shape, dtype=torch.int32, device=key.device)
        orig = torch.as_tensor(orig)
        if self.key_words == 2:
            if hi2 is None or lo2 is None:
                raise ValueError("key_words=2 sorter requires hi2 and lo2")
            key2 = _packed(hi2, lo2)
        else:
            if hi2 is not None or lo2 is not None:
                raise ValueError("hi2/lo2 given but sorter has key_words=1")
            key2 = None
        routed = self._step(self._place(key, valid, orig, key2))
        dev0 = self.mesh.groups()[0][0]

        def cat(field):
            return torch.cat([getattr(r, field).reshape(-1).to(dev0) for r in routed])

        s_key = cat("key")
        ovf = self._overflow(routed).to(torch.int32)
        return ShuffleResult((s_key >> 32).to(torch.int32),
                             (s_key & 0xFFFFFFFF).to(torch.uint32), cat("valid"),
                             cat("src_dev"), cat("src_row"), ovf, cat("dest"))

    def sort_global(
        self,
        keys: np.ndarray,
        valid: Optional[np.ndarray] = None,
        metrics=None,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Host convenience: int64 keys (padded to D*rows) → globally sorted
        keys + the permutation (indices into the input), via the mesh.

        Capacity overflow (a skewed input concentrating one (src, dst)
        pair past ``capacity_per_pair``) retries ONCE automatically with
        the capacity doubled, counted as ``mh.shuffle.capacity_retry`` into
        ``metrics`` (a :class:`~..utils.tracing.Metrics`, or None), so
        skew degrades to one extra round-trip instead of a failed sort;
        only a retry that *still* overflows raises
        :class:`ShuffleCapacityError`.  The key upload (key, valid and
        orig columns) and the download of the sorted keys and positions
        count into ``metrics``' ``transfers.*`` on a card."""
        if self.mesh.layout is not None and self.mesh.layout.num_processes > 1:
            raise ValueError("sort_global sorts one process's keys; a multi-process "
                             "mesh sorts through __call__")
        n = len(keys)
        total = self.n_devices * self.rows
        if n > total:
            raise ValueError(f"{n} rows exceed mesh budget {total}")
        if self.key_words == 2:
            raise ValueError("key_words=2 sorter requires hi2 and lo2")
        # The host-side placement costs no exchange; it is inverted via the
        # source ids below.
        pad_keys, v, inv = placement(keys, total, valid)
        placed = self._place(torch.from_numpy(pad_keys), torch.from_numpy(v),
                             torch.from_numpy(inv.astype(np.int32)), None)
        cuda_rows = sum((s1 - s0) * self.rows for dev, s0, s1 in self.mesh.groups()
                        if dev.type == "cuda")
        if metrics is not None and cuda_rows:
            metrics.count_h2d(cuda_rows * _UPLOAD_ROW_BYTES, "keys")
        routed = self._step(placed)
        ovf = int(self._overflow(routed))
        if ovf > 0:
            if metrics is not None:
                metrics.count("mh.shuffle.capacity_retry", 1)
            retry = DistributedSort(
                self.mesh,
                rows_per_device=self.rows,
                capacity_per_pair=min(self.rows, self.capacity * 2),
                samples_per_device=self.samples,
            )
            routed = retry._step(placed)
            ovf = int(self._overflow(routed))
            if ovf > 0:
                raise ShuffleCapacityError(
                    f"shuffle capacity exceeded by {ovf} "
                    f"rows even after the doubled-capacity retry "
                    f"(capacity {retry.capacity}); re-run with larger "
                    "capacity_per_pair"
                )
        s_keys, pos = [], []
        for r in routed:
            m = r.valid
            k = r.key[m]
            p = r.src_dev[m].to(torch.int64) * self.rows + r.src_row[m].to(torch.int64)
            if metrics is not None and k.device.type == "cuda":
                metrics.count_d2h(k.numel() * 8, "keys")
                metrics.count_d2h(p.numel() * 8, "perm")
            s_keys.append(k.cpu().numpy())
            pos.append(p.cpu().numpy())
        perm = inv[np.concatenate(pos)]  # undo the randomization pre-pass
        return np.concatenate(s_keys), perm, ovf
