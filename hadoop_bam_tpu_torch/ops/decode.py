"""Sort keys of a raw BAM record stream, built on the device.

Counterpart of ``hadoop_bam_tpu/ops/decode.py``
(``keys_from_stream_device``, ``_stream_keys``, ``patch_unmapped_keys``):
the chain kernel finds the record boundaries and its emit gathers
refid/pos/flag and packs the key from the bytes it staged (the reference's
separate key gather, folded into the walk), and the host's murmur3 hashes
are patched into the unmapped rows.
"""

from __future__ import annotations

import torch

from ..spec.bam import INT_MAX
from .kernels import chain


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
