"""Sorted record gather with the duplicate-flag patch: ``csrc/write.cu``
(``gather_stream_kernel``) and its plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/gather_stream.py``
(``gather_stream_device``): a part's records, in sorted order, are copied
out of the resident split payloads into one stream on the device, so the
uncompressed part never visits the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ... import _build
from . import LaunchCounter, OutsideInt32Domain, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("gather_stream")

#: SAM FLAG_DUPLICATE, the patch the duplicate-marking write applies.
FLAG_DUPLICATE = 0x400


def gather_stream_device(
    stream: torch.Tensor,
    src_starts,
    lens,
    dup_mask: Optional[np.ndarray] = None,
    bits: int = FLAG_DUPLICATE,
) -> Tuple[torch.Tensor, int]:
    """Assemble a permuted record stream on ``stream``'s device.

    Output record r is ``stream[src_starts[r] : + lens[r]]`` (size word +
    body, already in output order), placed back to back; where
    ``dup_mask[r]`` is set, the low and high bytes of ``bits`` are ORed into
    the record's bytes 18 and 19 (the flag field).  ``src_starts``, ``lens``
    and ``dup_mask`` are host columns.  Returns ``(uint8 tensor [total],
    total)``.  A geometry past the reference's int32 domain raises
    :class:`~hadoop_bam_tpu_torch.ops.kernels.OutsideInt32Domain` before
    any launch; a record outside ``stream`` raises ``IndexError``."""
    check_tensor(stream, "stream", torch.uint8)
    src = np.asarray(src_starts, dtype=np.int64)
    ln = np.asarray(lens, dtype=np.int64)
    r = len(src)
    if len(ln) != r:
        raise ValueError("src_starts and lens differ in length")
    if r == 0:
        return torch.empty(0, dtype=torch.uint8, device=stream.device), 0
    dst_end = np.cumsum(ln)
    total = int(dst_end[-1])
    if total >= 2**31 or int((src + ln).max()) >= 2**31:
        raise OutsideInt32Domain("gather geometry outside the int32 domain")
    if int(src.min()) < 0 or int(ln.min()) < 0 or int((src + ln).max()) > stream.numel():
        raise IndexError("gather_stream_device: a record lies outside the stream")
    dev = stream.device
    cols = [
        torch.from_numpy(src).to(dev),
        torch.from_numpy(dst_end - ln).to(dev),
        torch.from_numpy(ln.astype(np.int32)).to(dev),
    ]
    dup = None
    if dup_mask is not None:
        dup = torch.from_numpy(np.asarray(dup_mask, dtype=np.uint8)).to(dev)
        if dup.numel() != r:
            raise ValueError("dup_mask differs in length from src_starts")
    if use_plain(stream, *cols):
        return gather_stream_plain(stream, *cols, dup, bits), total
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    lib = _build.load("write")
    rc = lib.hbt_gather_stream(
        stream.data_ptr(), cols[0].data_ptr(), cols[1].data_ptr(), cols[2].data_ptr(),
        None if dup is None else dup.data_ptr(), r, int(bits), out.data_ptr(),
        stream_handle(stream),
    )
    _build.check(rc, "gather_stream")
    LAUNCHES.add()
    return out, total


def gather_stream_plain(stream, src, dst, lens, dup, bits: int) -> torch.Tensor:
    """The plain version on CPU tensors: one slice per record, joined, then
    the flag bytes of the marked records ORed in."""
    mv = memoryview(stream.numpy())
    s = src.numpy().tolist()
    n = lens.numpy().tolist()
    out = np.frombuffer(
        bytearray(b"".join(mv[a : a + k] for a, k in zip(s, n))), dtype=np.uint8
    )
    if dup is not None:
        mark = dup.numpy() != 0
        d, n = dst.numpy(), lens.numpy()
        out[d[mark & (n > 18)] + 18] |= np.uint8(bits & 0xFF)
        out[d[mark & (n > 19)] + 19] |= np.uint8((bits >> 8) & 0xFF)
    return torch.from_numpy(out)
