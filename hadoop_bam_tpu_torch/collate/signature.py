"""The read-name hash pair of the collation key.

Counterpart of ``QNAME_SEED2`` in ``hadoop_bam_tpu/collate/signature.py``:
names hash with murmur3 under seed 0 and under this seed, 64 bits in all.
"""

QNAME_SEED2 = 0x9747B28C
