"""PyTorch and CUDA port of ``hadoop_bam_tpu`` for NVIDIA Hopper (H100).

The port covers the in-core coordinate sort (:func:`pipeline.sort_bam`):
BGZF inflate, the BAM record chain, the sorted record gather, the member
CRC32 and the LZ77 + fixed-Huffman deflate run as hand-written CUDA kernels
(``csrc/``), keys sort with ``torch.sort``, and the host frames the BGZF
members and merges the parts; ``.cram`` input decodes its rANS 4x8
blocks with a hand-written kernel too.  FASTQ ingest
(:func:`ingest.ingest_fastq`) adds the FASTQ record-scan kernel and the
name collation; the ranged BCF query (:func:`serve.endpoints.variants_blob`,
which takes a :class:`serve.endpoints.ServeContext` first, as the region
endpoints do) the BCF record-chain kernel.  The resident daemon
(:class:`serve.server.BamDaemon`) answers those queries and sort and
ingest jobs over a socket from one process on the card.
``python -m hadoop_bam_tpu_torch <subcommand>`` (:mod:`cli`) is the
operator's front door to all of it; ``--trace`` and ``--metrics`` report a
run through the batch tracer, the run manifest and the HBM residency
ledger (:mod:`utils.hbm`).
Module names mirror the reference package, which the port never imports.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .conf import Configuration  # noqa: E402,F401
