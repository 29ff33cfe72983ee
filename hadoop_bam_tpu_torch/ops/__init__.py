"""The dense phases of the pipeline as torch programs and hand-written
CUDA kernels: the record-field decode and keys (``decode``, ``keys``), the
key sort (``sort``), the cigar and quality ops, the BGZF codec (``flate``)
and the kernels' wrappers (``kernels``)."""

from . import cigar, decode, keys, quality, sort  # noqa: F401
