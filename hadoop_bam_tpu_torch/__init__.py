"""PyTorch and CUDA port of ``hadoop_bam_tpu`` for NVIDIA Hopper (H100).

This slice ports the in-core coordinate sort (:func:`pipeline.sort_bam`):
BGZF inflate and the BAM record chain run as hand-written CUDA kernels
(``csrc/``), keys sort with ``torch.sort``, parts are written on the host.
Module names mirror the reference package, which the port never imports.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
