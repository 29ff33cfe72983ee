"""Host-side I/O: split planning, record readers and writers, mergers."""

from .splits import FileVirtualSplit  # noqa: F401
from .guesser import BamSplitGuesser  # noqa: F401
from .bam import BamInputFormat, BamOutputWriter  # noqa: F401
from .merger import merge_bam_parts  # noqa: F401
