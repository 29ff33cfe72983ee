"""The device mesh: one logical data axis ``d`` of shards.

Counterpart of ``hadoop_bam_tpu/parallel/mesh.py``.  The reference's mesh
is a ``jax.sharding.Mesh`` over the visible devices; here a :class:`Mesh`
is an ordered tuple of ``torch.device``s, one per shard (the analog of
"one mapper per split").  A device may repeat: eight shards on one card
are ``make_mesh(devices=[torch.device("cuda")] * 8)``, and the shuffle
(:mod:`.shuffle`) then runs every shard's steps batched on that card and
exchanges the buckets by one on-card transpose.

A mesh whose shards live in several processes carries a
:class:`ProcessLayout`: the tuple holds this process's shards, which are
the global shards ``[pid*L, (pid+1)*L)`` of a ``L * P``-shard mesh (the
reference's mesh-contiguity contract, :func:`process_of_device`), and the
layout's collectives move the shuffle's samples and buckets between the
processes (``parallel/multihost.py`` builds it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from ..utils.backend import resolve_device

DATA_AXIS = "d"


def data_axis() -> str:
    return DATA_AXIS


def process_of_device(global_dev, local_device_count: int):
    """Owning process of a global mesh device (scalar or array).

    Valid under the mesh-contiguity contract of a multi-process run (each
    process's devices occupy ``[pid*L, (pid+1)*L)`` of the mesh); the
    shuffle byte/key accounting maps destination devices to destination
    processes through this."""
    return global_dev // local_device_count


def choose_transport(idents: Sequence[str]) -> str:
    """The key plane's transport from every rank's shard device
    (:func:`device_ident`): "nccl" when every rank holds a card of its own,
    else "gloo" (ranks on the host, or ranks that share a card: a card
    cannot host two NCCL ranks)."""
    cards = [i for i in idents if i.startswith("cuda/")]
    if len(cards) == len(idents) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def device_ident(dev: torch.device) -> str:
    """A name of the physical device a shard sits on, equal across the
    processes that share it: the card's UUID on ``cuda``, else "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return f"cuda/{torch.cuda.get_device_properties(dev).uuid}"


@dataclass
class ProcessLayout:
    """This process's place in a multi-process mesh: its id, the process
    count and the key plane's group and transport ("nccl", or the default
    gloo group, staged through pinned host memory when the shards sit on a
    card; the default group is also the control plane's: barriers and the
    host allgathers).  The collectives take and return tensors on the
    shards' device; the bytes staged count as ``transfers.*.mh_keys`` into
    ``metrics`` (the running job's, set by the job; None counts nothing)."""

    process_id: int
    num_processes: int
    key_group: Any = None
    transport: str = "gloo"
    metrics: Any = None

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        if self.transport == "nccl" or t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        if self.metrics is not None:
            self.metrics.count_d2h(t.numel() * t.element_size(), "mh_keys")
        return host

    def _unstage(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        if t.device == dev:
            return t
        if self.metrics is not None:
            self.metrics.count_h2d(t.numel() * t.element_size(), "mh_keys")
        return t.to(dev, non_blocking=True)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[P, *t.shape]``: every process's ``t`` (same shape and dtype)
        in process order, on ``t``'s device."""
        import torch.distributed as dist

        src = self._stage(t.contiguous().reshape(-1).view(torch.uint8))
        out = torch.empty((self.num_processes, src.numel()), dtype=torch.uint8,
                          device=src.device)
        dist.all_gather(list(out.unbind(0)), src, group=self.key_group)
        out = self._unstage(out, t.device)
        return out.view(t.dtype).reshape((self.num_processes,) + tuple(t.shape))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` is ``[P, ...]`` uint8, row q bound for process q; returns
        ``[P, ...]``, row p from process p, on ``t``'s device."""
        import torch.distributed as dist

        src = self._stage(t.contiguous())
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.key_group)
        return self._unstage(out, t.device)


class Mesh(tuple):
    """An ordered tuple of ``torch.device``s, one per shard of the data
    axis.  ``mesh.devices`` is the mesh itself and ``.size`` its shard
    count, so ``mesh.devices.size`` reads as it does on the reference's
    mesh.  With a :class:`ProcessLayout` the tuple holds this process's
    shards, the first at global index :attr:`first_shard`, and ``size``
    counts the shards of every process."""

    def __new__(cls, devices: Sequence[Union[str, torch.device]],
                layout: Optional[ProcessLayout] = None):
        devs = tuple(resolve_device(d) for d in devices)  # a cuda shard needs a card
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if layout is not None and len(set(devs)) != 1:
            raise ValueError("a process's shards of a multi-process mesh share one device")
        mesh = super().__new__(cls, devs)
        mesh.layout = layout
        return mesh

    @property
    def devices(self) -> "Mesh":
        return self

    @property
    def size(self) -> int:
        return len(self) * (self.layout.num_processes if self.layout is not None else 1)

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.layout.process_id * len(self) if self.layout is not None else 0

    def groups(self) -> List[Tuple[torch.device, int, int]]:
        """``(device, first, stop)`` of each run of consecutive shards on
        one device: the shards the shuffle batches into one set of
        launches."""
        out: List[Tuple[torch.device, int, int]] = []
        for i, d in enumerate(self):
            if out and out[-1][0] == d:
                out[-1] = (d, out[-1][1], i + 1)
            else:
                out.append((d, i, i + 1))
        return out


def _visible_devices(dev: torch.device, n_devices: Optional[int]) -> List[torch.device]:
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    # The host is as many shards as asked for (one by default): the
    # counterpart of the reference's forced host device count.
    return [dev] * (n_devices or 1)


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: all visible devices).

    Without ``devices`` the visible devices are ``device``'s (None: the
    card, which raises when there is none): on ``cuda`` the visible cards,
    on ``cpu`` ``n_devices`` shards of the host (one by default)."""
    if devices is None:
        devices = _visible_devices(resolve_device(device), n_devices)
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)
