"""The ranged variant query: a region of a BCF call set as a small BCF.

Counterpart of the variant half of ``hadoop_bam_tpu/serve/endpoints.py``
(``_variant_rows``, ``variants_records``, ``variants_blob``), the code the
reference's ``variants`` CLI one-shot and daemon op run.  The reference's
``ServeContext`` (conf, resource cache, residency arena, lane batcher, the
daemon's stream) becomes explicit ``conf``/``device``/``stream`` arguments:
the cache, arena and batcher come with the serve slice (ROADMAP A.11), so
every call plans and reads cold, as the reference's one-shot does.

Per split of the file: the inflate kernel (the stream's inflate gate), the
BCF record-chain kernel and the ragged interval join on the stream's
device; the kept rows are decoded and re-encoded on the host.
"""

from __future__ import annotations

import io
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..conf import Configuration
from ..device_stream import DeviceStream
from ..io.bcf import BcfInputFormat, BcfRecordWriter, _read_bcf_header_prefix
from ..ops.overlap import ragged_overlap_mask
from ..utils.backend import resolve_device
from ..utils.intervals import MAX_END, FormatError, parse_interval


def _variant_rows(batch, rid: int, beg0: int, end0: int, use_device: bool,
                  stream: Optional[DeviceStream] = None) -> np.ndarray:
    """Row indices of the batch's records overlapping ``[beg0, end0)`` on
    VCF contig index ``rid``: the ragged interval join over the key/pos/end
    columns (a record spans ``[pos - 1, end)``).  With ``use_device`` the
    join runs on ``stream``'s device (on the batch's device columns when it
    has them, else on an upload of its host columns) inside the int32
    coordinate domain; outside it the host twin answers.  Counted as
    ``variants.join_device``/``variants.join_host``."""
    n = batch.n_records
    if n == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.asarray(batch.pos, dtype=np.int64) - 1
    ends = np.asarray(batch.end, dtype=np.int64)
    use_dev = use_device and bool(
        starts.size
        and int(starts.min()) >= -(2**31)
        and int(ends.max()) < 2**31 - 8
        and end0 < 2**31 - 8
    )
    q = (np.asarray([rid], np.int64), np.asarray([beg0], np.int64), np.asarray([end0], np.int64))
    if use_dev:
        dev = stream.device
        if batch.device_columns is not None:
            keys_t, pos_t, end_t = batch.device_columns
        else:
            keys_t, pos_t, end_t = (
                torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                for a in (batch.keys, batch.pos, batch.end)
            )
            if dev.type == "cuda":
                stream.metrics.count_h2d(24 * n, "variant_columns")
        mask = ragged_overlap_mask(keys_t >> 32, pos_t - 1, end_t, *q, use_device=True,
                                   device=dev)
        rows = torch.nonzero(mask).flatten().cpu().numpy()
    else:
        refid = np.asarray(batch.keys, dtype=np.int64) >> 32
        rows = np.nonzero(ragged_overlap_mask(refid, starts, ends, *q))[0]
    if stream is not None:
        stream.metrics.count("variants.join_device" if use_dev else "variants.join_host")
    return rows.astype(np.int64)


def variants_records(
    path: str,
    region: str,
    deadline=None,
    conf: Optional[Configuration] = None,
    device=None,
    stream: Optional[DeviceStream] = None,
    timings: Optional[dict] = None,
) -> Tuple[object, List[Tuple[object, np.ndarray]]]:
    """Resolve a ranged BCF query to ``(BcfHeader, [(batch, row indices)])``.

    The split plan is the reference's one-shot plan (the guesser over the
    whole file at the default 4 MiB split size; BCF has no index here, so
    every split is read); each split is read through ``stream`` (a new
    ``DeviceStream`` on ``device``, resolved as every entry point of the
    port does, when none is given) and cut by the join.  An unknown contig
    raises ``FormatError``.  ``timings``, when given, receives the seconds
    of the ``plan``, ``read`` and ``join`` phases."""
    if deadline is not None:
        raise NotImplementedError("variants deadlines (the serve path) are not ported: ROADMAP A.11")
    iv = parse_interval(region)
    if stream is None:
        stream = DeviceStream(resolve_device(device), conf=conf)
    t = {"plan": 0.0, "read": 0.0, "join": 0.0}
    t0 = time.perf_counter()
    hdr, _ = _read_bcf_header_prefix(path)
    splits = BcfInputFormat(Configuration(), metrics=stream.metrics).get_splits([path])
    if iv.contig not in hdr.contigs:
        raise FormatError(f"unknown contig {iv.contig!r} in {path!r}") from None
    rid = hdr.vcf.contig_index(iv.contig)
    beg0 = iv.start - 1  # 1-based inclusive -> 0-based half-open
    end0 = min(iv.end, MAX_END)
    t["plan"] = time.perf_counter() - t0
    fmt = BcfInputFormat(conf, metrics=stream.metrics)
    use_dev = stream.policy.use_bcf_chain
    picks: List[Tuple[object, np.ndarray]] = []
    for s in splits:
        t1 = time.perf_counter()
        batch = fmt.read_split(s, stream=stream)
        t2 = time.perf_counter()
        rows = _variant_rows(batch, rid, beg0, end0, use_dev, stream)
        t["join"] += time.perf_counter() - t2
        t["read"] += t2 - t1
        if len(rows):
            picks.append((batch, rows))
    if timings is not None:
        timings.update(t)
    return hdr, picks


def variants_blob(
    path: str,
    region: str,
    deadline=None,
    conf: Optional[Configuration] = None,
    device=None,
    stream: Optional[DeviceStream] = None,
    timings: Optional[dict] = None,
) -> bytes:
    """A complete small BCF (header, the records overlapping ``region`` in
    file order, terminator), like ``bcftools view -r``.  Runs on the card
    unless ``device="cpu"`` is passed.  ``timings`` also receives the
    ``encode`` phase (decode of the kept rows, BCF encode, BGZF)."""
    t = {} if timings is None else timings
    if stream is None:
        stream = DeviceStream(resolve_device(device), conf=conf)
    hdr, picks = variants_records(path, region, deadline=deadline, conf=conf, stream=stream,
                                  timings=t)
    t0 = time.perf_counter()
    buf = io.BytesIO()
    w = BcfRecordWriter(buf, hdr.vcf, append_terminator=True)
    n_records = 0
    for batch, rows in picks:
        for v in batch.select(rows):
            w.write(v)
        n_records += len(rows)
    w.close()
    t["encode"] = time.perf_counter() - t0
    stream.metrics.count("serve.variants.requests")
    stream.metrics.count("serve.variants.records", n_records)
    return buf.getvalue()
