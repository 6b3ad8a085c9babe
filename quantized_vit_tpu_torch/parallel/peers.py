"""The processes of one mesh axis: the port's counterpart of a JAX mesh
axis (the 'model' axis of FSDP and TP serving, the 'data' axis of the
gradient sync).

One process per shard, all on CUDA devices the processes can map into
each other (one card shared by the processes, or the cards of one host),
joined by a gloo group for the host-side handshakes: the default group,
or one of the axis groups of a :class:`~.partition.ProcessMesh`. A
:class:`Peers` holds:

- the rank and size along the axis (``rank``, ``tp``), the process's
  coordinate on the data axis (``data_index`` of ``dp``: which slice of
  a batch it serves) and its gloo ``group``;
- the peers' buffers mapped into this process through CUDA IPC
  (:meth:`Peers.open`: the handles of ``torch.multiprocessing``'s sharing
  of CUDA tensors, exchanged over gloo);
- two interprocess events per process (:meth:`Peers.fence`).

At tp = 1 it holds no group, no IPC and no event: an IPC handle cannot be
opened in the process that made it, and there is nobody to wait for.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch


class Peers:
    """tp processes of one mesh axis (see the module docstring). ``group``:
    their gloo group (None: the default process group, which :meth:`close`
    then leaves); ``data_index``/``dp``: this process's coordinate on the
    data axis of its mesh."""

    def __init__(self, rank: int, tp: int, device, group=None,
                 data_index: int = 0, dp: int = 1):
        self.rank, self.tp = int(rank), int(tp)
        self.device = torch.device(device)
        self.group = group
        self.data_index, self.dp = int(data_index), int(dp)
        self._events: Optional[List[torch.cuda.Event]] = None
        self._peer_events: Optional[List[Optional[list]]] = None
        self._fences = 0
        # host seconds spent in fence() (its gloo barrier mostly)
        self.fence_s = 0.0
        self._opened: List[list] = []

    def __repr__(self):
        return (f"Peers(rank={self.rank}, tp={self.tp}, "
                f"data={self.data_index}/{self.dp}, device={self.device})")

    def barrier(self) -> None:
        """A host barrier of the tp processes (gloo)."""
        if self.tp > 1:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    def all_gather_object(self, obj) -> list:
        """``obj`` of every process, in rank order."""
        if self.tp == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.tp
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A CPU tensor ``t`` of every process, in rank order (gloo; its
        bytes moved as uint8, so any dtype goes; the same shape on every
        process)."""
        if self.tp == 1:
            return [t]
        import torch.distributed as dist

        t = t.contiguous()
        raw = t.reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(self.tp)]
        dist.all_gather(parts, raw, group=self.group)
        return [p.view(t.dtype).reshape(t.shape) for p in parts]

    def open(self, tensors: List[torch.Tensor]) -> List[list]:
        """Map every peer's ``tensors`` (CUDA, one list of the same
        length from each process: a collective call) into this process.
        Returns one list per rank: this process's own tensors at its rank,
        the peers' mapped through CUDA IPC elsewhere. The peers' tensors
        stay mapped while this object lives; their owners keep them."""
        from torch.multiprocessing.reductions import reduce_tensor

        if self.tp == 1:
            return [list(tensors)]
        for t in tensors:
            if t.device.type != "cuda":
                raise ValueError(f"Peers.open: CUDA tensors only, got one on "
                                 f"{t.device}")
        # one share per consumer: each share carries one reference that
        # its consumer releases when it unmaps (torch's CUDA IPC counting)
        every = self.all_gather_object([
            None if p == self.rank else [reduce_tensor(t) for t in tensors]
            for p in range(self.tp)])
        out = [list(tensors) if q == self.rank else
               [fn(*args) for fn, args in every[q][self.rank]]
               for q in range(self.tp)]
        self._opened.append(out)
        return out

    def _make_events(self) -> None:
        self._events = [torch.cuda.Event(interprocess=True)
                        for _ in range(2)]
        handles = self.all_gather_object([e.ipc_handle()
                                          for e in self._events])
        self._peer_events = [
            None if p == self.rank else
            [torch.cuda.Event.from_ipc_handle(self.device, h) for h in hs]
            for p, hs in enumerate(handles)]

    def fence(self) -> None:
        """Order this process's stream after the work every peer enqueued
        before its matching call: record an interprocess event, pass a
        host barrier, make the stream wait on every peer's event. No
        device thread waits on another process. Two events alternate, so
        a peer that races ahead to its next fence records into the other
        event; every process makes the same sequence of calls."""
        if self.tp == 1:
            return
        t0 = time.perf_counter()
        if self._events is None:
            self._make_events()
        k = self._fences % 2
        self._fences += 1
        stream = torch.cuda.current_stream(self.device)
        self._events[k].record(stream)
        self.barrier()
        for p, evs in enumerate(self._peer_events):
            if evs is not None:
                stream.wait_event(evs[k])
        self.fence_s += time.perf_counter() - t0

    @property
    def fences(self) -> int:
        """The fences this process has passed."""
        return self._fences

    def close(self) -> None:
        """Drop the mapped peer buffers and events after every process has
        finished with them (the caller holds no plan that maps them), let
        each process free the buffers its peers had mapped, then leave the
        gloo group (the default group only: a mesh's groups stay)."""
        if self.tp == 1:
            return
        import gc

        import torch.distributed as dist

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        self.barrier()
        self._opened.clear()
        self.__dict__.pop("_collective_wire", None)  # collectives.py's
        self._peer_events = None
        gc.collect()
        self.barrier()
        if cuda:  # every peer has unmapped: free what they mapped of ours
            torch.cuda.ipc_collect()
        self.barrier()
        if self.group is None and dist.is_initialized():
            dist.destroy_process_group()
