"""BAM records of a raw record stream, decoded on the device.

Counterpart of ``hadoop_bam_tpu/ops/decode.py``.  The sort's path
(``keys_from_stream_device``, ``patch_unmapped_keys``): the chain kernel
finds the record boundaries and its emit gathers refid/pos/flag and packs
the key from the bytes it staged (the reference's separate key gather,
folded into the walk), and the host's murmur3 hashes are patched into the
unmapped rows.  The full parse (``parse_stream_device``): the same walk,
then every fixed field gathered into the SoA columns with torch ops
(``soa_decode_device``, the reference's XLA program) and the keys built
from them.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..spec.bam import INT_MAX
from ..utils.backend import resolve_device
from .keys import make_keys
from .kernels import chain

#: Bytes of a record's size word and fixed fields: the gathers read this
#: far past an offset, so a shorter stream is padded to it.
MIN_RECORD = 36


def soa_decode_device(data: torch.Tensor, offsets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 13 SoA columns of ``spec.bam.soa_decode`` (int32, the
    reference's names) of the records whose size words sit at ``offsets``
    in the uint8 ``data``, on ``data``'s device: one gather of each
    record's first :data:`MIN_RECORD` bytes (an index past the stream reads
    its last byte, as the reference's gathers clamp), read as nine
    little-endian int32 words, one contiguous row a word."""
    offs = offsets.to(device=data.device, dtype=torch.int64)
    at = offs[:, None] + torch.arange(MIN_RECORD, device=data.device)
    w = data[at.clamp_(max=data.numel() - 1)].view(torch.int32).t().contiguous()  # [9, N]
    return {
        "refid": w[1],
        "pos": w[2],
        "l_read_name": w[3] & 0xFF,
        "mapq": (w[3] >> 8) & 0xFF,
        "bin": (w[3] >> 16) & 0xFFFF,
        "n_cigar_op": w[4] & 0xFFFF,
        "flag": (w[4] >> 16) & 0xFFFF,
        "l_seq": w[5],
        "next_refid": w[6],
        "next_pos": w[7],
        "tlen": w[8],
        "rec_off": (offs + 4).to(torch.int32),
        "rec_len": w[0],
    }


def parse_stream_device(
    data,
    n_bytes: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
):
    """The whole device parse of a raw BAM record stream: the record-chain
    walk (kernel row 2), the fixed-field SoA gather, then the sort keys.

    ``data``: uint8 bytes, a NumPy array or a tensor.  A tensor stays on
    its device unless ``device`` names another; host input goes to the
    card unless ``device="cpu"``.  Returns ``(soa, hi, lo, valid, ok)`` on
    that device: the SoA columns and the key halves (``hi`` int32, ``lo``
    uint32) padded to :func:`~.kernels.chain.offsets_capacity` rows,
    ``valid`` marking the live rows, ``ok`` a bool 0-d tensor, False on a
    misaligned or truncated chain.  Unmapped rows key with hash 0, as in
    the reference (its mapped-key fast path).  Nothing is synchronised."""
    if isinstance(data, torch.Tensor):
        dev = data.device if device is None else resolve_device(device)
        a = data.to(dev)
    else:
        dev = resolve_device(device)
        host = (np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview))
                else np.asarray(data, np.uint8))
        # Writable for torch.from_numpy; a copy only when the buffer is read-only.
        a = torch.from_numpy(np.require(host, requirements=["C", "W"])).to(dev)
    n = a.numel() if n_bytes is None else int(n_bytes)
    offs, count, ok = chain.record_chain_device(a, n)
    valid = torch.arange(offs.numel(), device=dev) < count
    offs = torch.where(valid, offs, 0)
    if a.numel() < MIN_RECORD:
        a = torch.cat([a, a.new_zeros(MIN_RECORD - a.numel())])
    soa = soa_decode_device(a, offs)
    keys = make_keys(soa["refid"], soa["pos"], soa["flag"], torch.zeros_like(soa["refid"]))
    hi = (keys >> 32).to(torch.int32)
    lo = keys.to(torch.int32).view(torch.uint32)
    return soa, hi, lo, valid, ok


def keys_from_stream_device(stream: torch.Tensor, n_bytes: int, n_rows: int):
    """``(keys, unmapped, meta)`` of the records in ``stream[:n_bytes]``:
    int64 keys and the unmapped mask of rows ``[0, n_rows)`` and int64
    ``[count, ok]`` from the walk.  Nothing is synchronised: the caller
    reads ``meta`` when it validates the count against the host walk."""
    _, meta, keys, unm = chain.record_chain_keys(stream, n_bytes, n_rows)
    return keys, unm, meta


def patch_unmapped_keys(
    keys: torch.Tensor, unmapped: torch.Tensor, hash32: torch.Tensor
) -> torch.Tensor:
    """Unmapped rows get ``(long)INT_MAX << 32 | hash`` with Java's sign
    extension: a negative hash floods the high word (the key is then the
    hash itself, sign-extended)."""
    h = hash32.to(torch.int64)
    patched = torch.where(h < 0, h, INT_MAX * (1 << 32) + h)
    return torch.where(unmapped, patched, keys)


def pad_offsets(offsets, batch: int):
    """``offsets`` padded to ``batch`` rows: ``(padded int32, valid)``,
    the pad rows at offset 0 and masked out."""
    n = len(offsets)
    if n > batch:
        raise ValueError(f"batch {batch} < record count {n}")
    padded = np.zeros(batch, dtype=np.int32)
    padded[:n] = offsets
    valid = np.zeros(batch, dtype=bool)
    valid[:n] = True
    return padded, valid
