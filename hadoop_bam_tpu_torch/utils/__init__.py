"""Host utilities: murmur3 hashes, intervals, part-file conventions,
tracing, the HBM ledger, deadlines and device resolution."""

from .murmur3 import murmurhash3_bytes, murmurhash3_chars  # noqa: F401
from .intervals import Interval, parse_intervals  # noqa: F401
