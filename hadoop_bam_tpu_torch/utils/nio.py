"""Part-file conventions: the part listing, ``_SUCCESS`` markers, concat.

Counterpart of ``hadoop_bam_tpu/utils/nio.py`` (util/NIOFileUtil.java): the
sorted ``part-[mr]-NNNNN`` listing without companion index files, the
``_SUCCESS`` completeness check of the mergers (util/SAMFileMerger.java:50-54)
and the byte concat of a merge.  The part file is the restart unit of
:class:`~..parallel.executor.ElasticExecutor`.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Union

PathLike = Union[str, os.PathLike]

_PART_RE = re.compile(r"^part-[mr]-\d{5}.*$")
SUCCESS_MARKER = "_SUCCESS"


def as_path(p: PathLike) -> Path:
    return Path(p)


def list_parts(directory: PathLike, excludes_ext: str = ".splitting-bai") -> List[Path]:
    """Sorted part files, without the companion index files
    (NIOFileUtil.getFilesMatching's excludesExt)."""
    d = as_path(directory)
    return sorted(
        x for x in d.iterdir()
        if _PART_RE.match(x.name) and not (excludes_ext and x.name.endswith(excludes_ext))
    )


def check_success(directory: PathLike) -> None:
    """Raise ``FileNotFoundError`` unless the job wrote its ``_SUCCESS``."""
    d = as_path(directory)
    if not (d / SUCCESS_MARKER).exists():
        raise FileNotFoundError(f"no {SUCCESS_MARKER} marker in {d}: job output incomplete")


def write_success(directory: PathLike) -> None:
    (as_path(directory) / SUCCESS_MARKER).touch()


def concat_files(sources: List[PathLike], out_stream) -> int:
    """Append each file's bytes to an open binary stream; returns the bytes
    copied."""
    total = 0
    for src in sources:
        with open(src, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                out_stream.write(chunk)
                total += len(chunk)
    return total
