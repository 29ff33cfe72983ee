"""Post-job merge: headerless parts → one BAM (+ merged ``.splitting-bai``)
or one CRAM.

Counterpart of ``hadoop_bam_tpu/io/merger.py`` (util/SAMFileMerger.java
semantics): require the ``_SUCCESS`` marker, take ``part-[mr]-NNNNN`` in
order, write the header block, append the parts untouched and the BGZF
terminator, and merge the per-part indices by shifting their offsets; CRAM
parts get the file definition and header container before them and the EOF
container after them.
"""

from __future__ import annotations

import os
import shutil
from typing import List

from ..spec import bam, bgzf, cram, indices
from ..utils import nio

SUCCESS_MARKER = nio.SUCCESS_MARKER


def list_parts(directory: str) -> List[str]:
    """Sorted part files, their ``.splitting-bai`` companions excluded."""
    return [str(p) for p in nio.list_parts(directory, indices.SPLITTING_BAI_EXT)]


def prepare_bam_header_block(header: bam.BamHeader, level: int = 6) -> bytes:
    """The leading BGZF members holding magic, header text and refs, a
    member every ``MAX_PAYLOAD`` bytes (the reference's ``BgzfWriter``)."""
    return bgzf.deflate_blocks(header.encode(), level=level)[0]


def merge_bam_parts(
    part_dir: str,
    out_path: str,
    header: bam.BamHeader,
    write_splitting_bai: bool = False,
) -> None:
    nio.check_success(part_dir)
    parts = list_parts(part_dir)
    header_block = prepare_bam_header_block(header)
    part_lengths: List[int] = []
    with open(out_path, "wb") as out:
        out.write(header_block)
        for p in parts:
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out, 4 << 20)
            part_lengths.append(os.path.getsize(p))
        out.write(bgzf.TERMINATOR)
    if not write_splitting_bai:
        return
    idx_paths = [p + indices.SPLITTING_BAI_EXT for p in parts]
    if parts and all(os.path.exists(p) for p in idx_paths):
        with open(out_path + indices.SPLITTING_BAI_EXT, "wb") as f:
            indices.merge_splitting_bais(
                [indices.SplittingBai.load(p) for p in idx_paths],
                part_lengths,
                header_length=len(header_block),
                total_length=os.path.getsize(out_path),
                out=f,
            )


def merge_cram_parts(
    part_dir: str,
    out_path: str,
    header: bam.BamHeader,
    check_success: bool = True,
) -> None:
    """Headerless CRAM parts → one CRAM: the file definition (version 3.0,
    a zero file id) and the header container, the parts' containers
    untouched, the EOF container (util/SAMFileMerger.java:77-78,96-102)."""
    if check_success:
        nio.check_success(part_dir)
    with open(out_path, "wb") as out:
        out.write(cram.MAGIC + bytes([3, 0]) + b"\x00" * 20)
        out.write(cram.encode_file_header_container(header.text, 3))
        nio.concat_files(list_parts(part_dir), out)
        out.write(cram.EOF_V3)
