"""PyTorch and CUDA port of ``hadoop_bam_tpu`` for NVIDIA Hopper (H100).

The port covers the in-core coordinate sort (:func:`pipeline.sort_bam`):
BGZF inflate, the BAM record chain, the sorted record gather, the member
CRC32 and the LZ77 + fixed-Huffman deflate run as hand-written CUDA kernels
(``csrc/``), keys sort with ``torch.sort``, and the host frames the BGZF
members and merges the parts; ``.cram`` input decodes its rANS 4x8
blocks with a hand-written kernel too.  FASTQ ingest
(:func:`ingest.ingest_fastq`) adds the FASTQ record-scan kernel and the
name collation; the ranged BCF query (:func:`serve.endpoints.variants_blob`)
the BCF record-chain kernel.
Module names mirror the reference package, which the port never imports.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
