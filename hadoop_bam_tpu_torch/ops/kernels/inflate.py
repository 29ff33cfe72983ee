"""BGZF member inflate: ``csrc/inflate.cu`` and its plain version.

Counterpart of ``hadoop_bam_tpu/ops/pallas/inflate_lanes.py``.  Both
versions take the same tensors and return the same ``[n_out, ok]`` meta per
member; the bytes of a member with ``ok = 1`` are its exact payload.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ... import _build
from . import LaunchCounter, check_tensor, stream_handle, use_plain

LAUNCHES = LaunchCounter("inflate_members")

#: Bytes the compressed buffer must hold past its last member: the kernel
#: reads each member in place with aligned 8-byte loads.
COMP_PAD = 8

#: Dynamic shared memory of one CTA (``csrc/inflate.cu``): 8,448 bytes of
#: tables, tokens and state, then the 16 KiB output ring and 16 bytes to
#: align it with the member's place in ``out``.  Nine CTAs fit an SM.
SMEM_BYTES = 8448 + 16384 + 16


def inflate_members(
    comp: torch.Tensor,
    comp_off: torch.Tensor,
    clens: torch.Tensor,
    out_off: torch.Tensor,
    isizes: torch.Tensor,
    out: torch.Tensor,
    max_clen: int,
) -> torch.Tensor:
    """Inflate raw DEFLATE members into one flat buffer.

    Member i's stream is ``comp[comp_off[i] : +clens[i]]``; its payload goes
    to ``out[out_off[i] : +isizes[i]]``.  ``comp`` must hold
    :data:`COMP_PAD` bytes past the end of its last member; ``max_clen`` is
    ``clens.max()``, which the kernel no longer needs (it reads each member
    in place), kept so the callers' signature stands.  Returns
    int32 ``[n, 2]`` meta: bytes produced and ok.  Dtypes: ``comp``/``out``
    uint8, ``comp_off``/``out_off`` int64, ``clens``/``isizes`` int32."""
    for t, name, dt in (
        (comp, "comp", torch.uint8), (comp_off, "comp_off", torch.int64),
        (clens, "clens", torch.int32), (out_off, "out_off", torch.int64),
        (isizes, "isizes", torch.int32), (out, "out", torch.uint8),
    ):
        check_tensor(t, name, dt)
    n = comp_off.numel()
    if not (clens.numel() == out_off.numel() == isizes.numel() == n):
        raise ValueError("member columns differ in length")
    if use_plain(comp, comp_off, clens, out_off, isizes, out):
        return inflate_members_plain(comp, comp_off, clens, out_off, isizes, out)
    meta = torch.empty((n, 2), dtype=torch.int32, device=comp.device)
    if n == 0:
        return meta
    lib = _build.load("inflate")
    rc = lib.hbt_inflate_members(
        comp.data_ptr(), comp_off.data_ptr(), clens.data_ptr(),
        out_off.data_ptr(), isizes.data_ptr(), out.data_ptr(),
        meta.data_ptr(), n, SMEM_BYTES, stream_handle(comp),
    )
    _build.check(rc, "inflate_members")
    LAUNCHES.add()
    return meta


def _inflate_one(raw: memoryview, start: int, clen: int, isize: int):
    d = zlib.decompressobj(-15)
    try:
        got = d.decompress(raw[start : start + clen], isize + 1)
    except zlib.error:
        return b"", False
    return got[:isize], d.eof and len(got) == isize


def inflate_members_plain(comp, comp_off, clens, out_off, isizes, out):
    """The plain version on CPU tensors: zlib per member, same contract.
    DEFLATE has no tensor formulation; zlib checks what the kernel checks."""
    raw = memoryview(comp.numpy())
    co = comp_off.numpy()
    cl = clens.numpy()
    oo = out_off.numpy()
    isz = isizes.numpy()
    dst = out.numpy()
    n = len(co)
    meta = np.zeros((n, 2), dtype=np.int32)

    def one(i: int) -> None:
        got, ok = _inflate_one(raw, int(co[i]), int(cl[i]), int(isz[i]))
        o = int(oo[i])
        dst[o : o + len(got)] = np.frombuffer(got, dtype=np.uint8)
        meta[i] = (len(got), int(ok))

    with ThreadPoolExecutor() as pool:
        list(pool.map(one, range(n)))
    return torch.from_numpy(meta)
