"""A decoded variant split: key/pos/end columns and lazy ``VariantContext``s.

Counterpart of ``hadoop_bam_tpu/io/vcf.py VariantBatch``.  The port adds
:meth:`VariantBatch.select`, which decodes only the rows a query keeps.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from ..spec.vcf import VariantContext, VcfHeader


class VariantBatch:
    """Decoded split: int64 key/pos/end SoA columns, with the per-row
    ``VariantContext`` objects materialized lazily — the sort and interval
    paths touch only the columns, so the per-record Python decode runs only
    for the rows a consumer asks for.

    ``materializer(rows=None)`` decodes every row, or the rows at the
    indices ``rows``; ``device_columns``, when set, holds the key/pos/end
    columns as int64 tensors on the device that computed them, so a join
    there needs no upload."""

    def __init__(
        self,
        header: VcfHeader,
        variants: Optional[List[VariantContext]] = None,
        keys: Optional[np.ndarray] = None,
        pos: Optional[np.ndarray] = None,
        end: Optional[np.ndarray] = None,
        materializer: Optional[Callable] = None,
        device_columns=None,
    ):
        self.header = header
        self.keys = keys if keys is not None else np.empty(0, np.int64)
        self.pos = pos if pos is not None else np.empty(0, np.int64)
        self.end = end if end is not None else np.empty(0, np.int64)
        self._variants = variants
        self._materializer = materializer
        self.device_columns = device_columns

    @property
    def variants(self) -> List[VariantContext]:
        if self._variants is None:
            self._variants = self._materializer() if self._materializer else []
        return self._variants

    def select(self, rows: Sequence[int]) -> List[VariantContext]:
        """The variants at ``rows``, in that order: from the materialized
        list when there is one, else decoded for those rows only."""
        if self._variants is None and self._materializer is not None:
            return self._materializer(np.asarray(rows, np.int64))
        vs = self.variants
        return [vs[int(i)] for i in rows]

    @property
    def n_records(self) -> int:
        return len(self.keys)
