"""DeviceStream: one job's device policy, member decode, parse, split drive.

Counterpart of ``hadoop_bam_tpu/device_stream.py`` for the in-core sort:
``StreamPolicy.resolve`` (the inflate, deflate-lanes and device-write
gates), ``decode_members`` (the inflate seam of the split reader),
``read_splits`` (the double-buffered split drive), ``parse_split`` (the
inflate→parse seam), ``encode_part`` (the gather→deflate seam of the
part writer), ``deflate_stream`` (the BGZF seam of the ingest writer),
``walk_bcf_records`` (the BCF record-chain seam of the variant plane) and
``decompress_cram_blocks`` (the rANS seam of the CRAM reader).  The
device is explicit; counters go to the stream's
:class:`~.utils.tracing.Metrics` (its own, or the ``metrics`` it is given:
the serve daemon's registry).  A request's ``deadline`` is checked at the
stage boundaries: before each split is taken (``stream_read``), before a
split's parse (``stream_parse``) and before a part's encode
(``stream_encode``).
"""

from __future__ import annotations

import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .conf import (
    BCF_CHAIN,
    CRAM_RANS_LANES,
    DEFLATE_LANES,
    INFLATE_LANES,
    READ_DEPTH,
    WRITE_DEVICE,
    gate,
)
from .io.bam import ChunkedRecords, RecordBatch, _empty_soa
from .spec.fragment import FormatException
from .ops import decode, flate
from .ops.kernels import OutsideInt32Domain
from .ops.kernels.bcf_chain import walk_chain
from .ops.kernels.gather import gather_stream_device
from .spec import bam, bgzf, cram_codecs
from .utils.tracing import Metrics

DEFAULT_DEPTH = 2

#: The data errors a salvaging split read turns into an empty batch.
DATA_ERRORS = (bgzf.BgzfError, bam.BamError, FormatException, zlib.error)


def resolve_depth(conf=None) -> int:
    """``hadoopbam.read.depth`` → ``HBAM_READ_DEPTH`` → 2; at least 1."""
    if conf is not None:
        v = conf.get_int(READ_DEPTH, 0)
        if v > 0:
            return v
    env = os.environ.get("HBAM_READ_DEPTH")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            return DEFAULT_DEPTH
    return DEFAULT_DEPTH


class StreamPolicy:
    """The gates, resolved once per stream, each by its env var, then its
    conf key, then the reference's local-accelerator auto rule: on for a
    CUDA device, off for the CPU."""

    def __init__(self, inflate_lanes: bool, deflate_lanes: bool, device_write: bool,
                 depth: int, use_bcf_chain: bool = False, use_rans_lanes: bool = False) -> None:
        self.inflate_lanes = inflate_lanes
        self.deflate_lanes = deflate_lanes
        self.device_write = device_write
        self.use_bcf_chain = use_bcf_chain
        self.use_rans_lanes = use_rans_lanes
        self.depth = depth

    @classmethod
    def resolve(cls, conf, device: torch.device) -> "StreamPolicy":
        on_card = device.type == "cuda"
        return cls(
            inflate_lanes=gate("HBAM_INFLATE_LANES", conf, INFLATE_LANES, on_card),
            deflate_lanes=gate("HBAM_DEFLATE_LANES", conf, DEFLATE_LANES, on_card),
            device_write=gate("HBAM_DEVICE_WRITE", conf, WRITE_DEVICE, on_card),
            depth=resolve_depth(conf),
            use_bcf_chain=gate("HBAM_BCF_CHAIN", conf, BCF_CHAIN, on_card),
            use_rans_lanes=gate("HBAM_RANS_LANES", conf, CRAM_RANS_LANES, on_card),
        )


class DeviceStream:
    def __init__(self, device: torch.device, conf=None, metrics: Optional[Metrics] = None,
                 deadline=None) -> None:
        self.device = device
        self.policy = StreamPolicy.resolve(conf, device)
        self.metrics = metrics if metrics is not None else Metrics()
        self.deadline = deadline
        self.inflate_stats = flate.CodecTierStats()
        self._stats_lock = threading.Lock()

    def check_deadline(self, seam: str) -> None:
        """Raise ``DeadlineExceeded`` at a stage boundary once the
        request's deadline has expired; one branch without a deadline."""
        if self.deadline is not None:
            self.deadline.check(seam, self.metrics)

    def default_device_parse(self) -> bool:
        """The device parse runs by default on a CUDA device."""
        return self.device.type == "cuda"

    def attach_window(self, dev: torch.Tensor) -> torch.Tensor:
        """The inflate kernel left a split window on the device; the
        reader's batch keeps it."""
        self.metrics.count("device_stream.windows")
        return dev

    def decode_members(self, data, coffsets, csizes, usizes):
        """Inflate a batch of members on the stream's device:
        ``(out, out_offsets, window)`` (see
        :func:`~.ops.flate.inflate_blocks_device`).  Failures raise.  The
        call counts into its own tier stats, folded into
        :attr:`inflate_stats` under a lock: ``read_splits`` decodes
        ``depth`` splits at once."""
        self.metrics.count("device_stream.decodes")
        stats = flate.CodecTierStats()
        res = flate.inflate_blocks_device(
            data, coffsets, csizes, usizes, self.device, self.metrics, stats=stats,
        )
        with self._stats_lock:
            for k in stats.__slots__:
                setattr(self.inflate_stats, k, getattr(self.inflate_stats, k) + getattr(stats, k))
        return res

    def read_splits(self, fmt, splits, fields=None, with_keys: bool = True,
                    errors: Optional[str] = None) -> Iterator:
        """Yield decoded split batches in order, ``depth`` splits in flight:
        split k+1's file read, upload and inflate run while the caller
        handles split k.

        Under ``errors="salvage"`` a split whose read fails outright with a
        data error (:data:`DATA_ERRORS`) becomes an empty batch in its slot,
        counted ``salvage.splits_failed``; any other failure (a kernel, the
        card) raises, where the reference catches every exception."""
        d = self.policy.depth

        def read_one(s):
            try:
                return fmt.read_split(s, fields=fields, with_keys=with_keys, stream=self,
                                      errors=errors)
            except DATA_ERRORS:
                if errors != "salvage":
                    raise
                self.metrics.count("salvage.splits_failed", 1)
                return RecordBatch(soa=_empty_soa(fields), data=np.empty(0, np.uint8),
                                   keys=np.empty(0, np.int64), salvaged=True)

        if d <= 1 or len(splits) <= 1:
            for s in splits:
                self.check_deadline("stream_read")
                yield read_one(s)
            return
        pool = ThreadPoolExecutor(max_workers=d)
        futs = [pool.submit(read_one, s) for s in splits[: d + 1]]
        nxt = d + 1
        try:
            for i in range(len(splits)):
                self.check_deadline("stream_read")
                b = futs[i].result()
                futs[i] = None  # keep only ~depth + 1 batches alive
                if nxt < len(splits):
                    futs.append(pool.submit(read_one, splits[nxt]))
                    nxt += 1
                yield b
                del b
        finally:
            for f in futs:
                if f is not None:
                    f.cancel()
            pool.shutdown(wait=True, cancel_futures=True)

    def parse_split(self, b):
        """Launch the chain and key kernels over one split's record stream.

        Returns ``(keys, unmapped, meta)`` tensors on the device (``meta`` =
        ``[count, ok]`` of the walk), or None for an empty split.  The
        stream is a view of the resident window when the batch has one;
        otherwise the host bytes are uploaded (counted).  Nothing waits on
        the device."""
        n_i = b.n_records
        if n_i == 0:
            return None
        self.check_deadline("stream_parse")
        rec_off = b.soa["rec_off"]
        s0 = int(rec_off[0]) - 4
        s1 = int(rec_off[-1] + b.soa["rec_len"][-1])
        dd = b.device_data
        if dd is not None:
            stream = dd[s0:s1]
            self.metrics.count("sort_bam.device_parse_residency")
        elif self.device.type == "cuda":
            stream = torch.from_numpy(np.ascontiguousarray(b.data[s0:s1])).to(self.device)
            self.metrics.count("device_stream.uploaded_windows")
            self.metrics.count_h2d(s1 - s0, "parse_stream")
        else:
            stream = torch.from_numpy(np.ascontiguousarray(b.data[s0:s1]))
        return decode.keys_from_stream_device(stream, s1 - s0, n_i)

    def encode_part(
        self, batch, order: Optional[np.ndarray], dup_mask: Optional[np.ndarray], level: int
    ) -> Optional[Tuple[bytes, np.ndarray]]:
        """The device-resident part: the sorted gather with the duplicate
        flag patch, the deflate lanes and the CRC32 column all run on the
        card from the batch's resident stream, and only compressed rows and
        the CRC column come back.  Returns ``(blob, member sizes)`` blocked
        at ``DEV_LZ_PAYLOAD``, or None to send the part to the host gather:
        no resident stream (``bam.device_write_tierdown.no_residency``), a
        geometry past the int32 domain (``...size``), or no records.
        Kernel failures raise."""
        if isinstance(batch, ChunkedRecords):
            flat = batch.device_flat
            if flat is None:
                self.metrics.count("bam.device_write_tierdown.no_residency")
                return None
            base = batch.chunk_base[np.asarray(batch.chunk_id, dtype=np.int64)]
            src = base + np.asarray(batch.soa["rec_off"], np.int64) - 4
        else:
            flat = batch.device_data
            if flat is None:
                self.metrics.count("bam.device_write_tierdown.no_residency")
                return None
            src = np.asarray(batch.soa["rec_off"], np.int64) - 4
        lens = np.asarray(batch.soa["rec_len"], np.int64) + 4
        if order is not None:
            src = src[order]
            lens = lens[order]
        if len(src) == 0:
            return None  # an empty part: the host path writes its canonical form
        self.check_deadline("stream_encode")
        dm = None
        if dup_mask is not None:
            dm = dup_mask[order] if order is not None else dup_mask
            if not dm.any():
                dm = None
        try:
            gathered, _ = gather_stream_device(flat, src, lens, dup_mask=dm)
        except OutsideInt32Domain:
            self.metrics.count("bam.device_write_tierdown.size")
            return None
        if self.device.type == "cuda":
            self.metrics.count_h2d(len(src) * 16 + (0 if dm is None else len(dm)), "write_cols")
        res = flate.deflate_blocks_device(
            None, level=level, block_payload=flate.DEV_LZ_PAYLOAD, device_input=gathered,
            metrics=self.metrics,
        )
        if dm is not None:
            self.metrics.count("bam.duplicate_flags_patched", int(dm.sum()))
        self.metrics.count("bam.device_write_parts")
        self.metrics.count("device_stream.parts_encoded")
        return res

    def deflate_stream(self, payload, level: int, block_payload: int) -> bytes:
        """Back-to-back BGZF members of a host byte stream, no terminator,
        a cut every ``block_payload`` bytes.  With the deflate lanes armed:
        :func:`~.ops.flate.deflate_blocks_device` on the stream's device
        (per-member host-zlib tier-down, counted; ``block_payload`` at most
        ``DEV_MAX_PAYLOAD``); otherwise host zlib at ``level``, byte for
        byte what the reference's ``native.deflate_blocks`` writes."""
        a = np.frombuffer(payload, dtype=np.uint8)
        if self.policy.deflate_lanes:
            self.metrics.count("device_stream.deflates")
            blob, _ = flate.deflate_blocks_device(
                a, level=level, block_payload=block_payload, use_lanes=True,
                device=self.device, metrics=self.metrics,
            )
            return blob
        return bgzf.deflate_blocks(a, level=level, block_payload=block_payload)[0]

    def walk_bcf_records(self, payload, start: int, limit: int,
                         resident: Optional[torch.Tensor] = None):
        """Walk a BCF record chain through the stream's gate: ``(cols,
        count, ok, tier)`` from :func:`~.ops.kernels.bcf_chain.walk_chain`,
        or None when the gate is off.  ``resident`` is the window the
        inflate kernel left on the device (the same bytes as ``payload``):
        the walk reads it in place; otherwise ``payload`` is uploaded
        (counted)."""
        if not self.policy.use_bcf_chain:
            return None
        self.metrics.count("device_stream.bcf_walks")
        if resident is not None:
            t = resident
            self.metrics.count("bcf.chain.resident_windows")
        else:
            t = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(self.device)
            if self.device.type == "cuda":
                self.metrics.count("bcf.chain.uploaded_windows")
                self.metrics.count_h2d(t.numel(), "bcf_payload")
        return walk_chain(t, start, limit, host=payload)

    def decompress_cram_blocks(self, blocks, errors: str = "strict"):
        """Decompress one CRAM container's blocks ``(method, payload,
        raw_size)`` (:func:`~.spec.cram_codecs.decompress_batch`): with the
        rANS gate armed, its rANS 4x8 blocks decode in one launch of the
        card's kernel (per-block tier-down to the host tiers, counted under
        ``cram.rans.*``); disarmed, on the host, moving no ``cram.rans.*``
        or ``device_stream.*`` counter."""
        if self.policy.use_rans_lanes:
            self.metrics.count("device_stream.cram_decodes")
        return cram_codecs.decompress_batch(blocks, errors=errors, stream=self)
