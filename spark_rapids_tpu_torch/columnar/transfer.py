"""Host-to-device uploads and device-to-host downloads through pinned
memory on a copy stream.

The port's own module: the reference hands its numpy arrays to
``jax.device_put``.  On the card an upload here is three steps:

  * the arrays are written into pinned host buffers (:class:`PinnedStage`):
    built in place there, as ``columnar/batch.from_arrow`` pads its
    columns and the fused Parquet reader's ``assemble`` packs its value
    buffers, or copied there when small and finished;
  * the copies go with ``non_blocking=True`` on the stream a
    :class:`CopyStream` owns, one event recorded after the last, so the
    host does not wait for them;
  * the consumer's stream waits on that event before it reads the
    tensors (:meth:`PinnedUpload.wait`), and every tensor is
    ``record_stream``-ed on it, so the caching allocator never hands a
    block out again while the consumer may still read it.

A pinned buffer is released only after its copy's event has completed:
the copy stream holds the buffers of each upload until then.  Any
failure to pin, copy or record raises; nothing falls back to a pageable
copy.

A download (:meth:`CopyStream.download`, the collect's
``columnar/batch.to_arrow_all``) goes the other way: the copy stream
waits for the work already enqueued, copies each packed buffer once into
pinned host memory, and the host waits on one event for all of them.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Sequence

import numpy as np
import torch


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


class PinnedStage:
    """The pinned host buffers of one upload set.  ``empty`` and ``put``
    return numpy views of pinned tensors; only those views may be passed
    to :meth:`CopyStream.upload` with this stage."""

    def __init__(self):
        self.tensors: List[torch.Tensor] = []
        self._of: Dict[int, torch.Tensor] = {}

    def empty(self, shape, np_dtype) -> np.ndarray:
        """An uninitialised pinned buffer, as ``np.empty``."""
        t = torch.empty(shape, dtype=_torch_dtype(np_dtype), pin_memory=True)
        view = t.numpy()
        self.tensors.append(t)
        self._of[id(view)] = t
        return view

    def put(self, a: np.ndarray) -> np.ndarray:
        """``a`` in pinned memory: itself when it is a buffer of this
        stage, else a pinned copy (the one host copy of a finished
        array)."""
        if id(a) in self._of:
            return a
        view = self.empty(a.shape, a.dtype)
        np.copyto(view, a)
        return view

    def tensor(self, view: np.ndarray) -> torch.Tensor:
        return self._of[id(view)]


class PinnedUpload(dict):
    """An upload set on the card, key by key (a dict of tensors), with the
    event recorded after its last copy and the pinned buffers the copies
    read."""

    def __init__(self, tensors: Dict[str, torch.Tensor], device,
                 event: torch.cuda.Event, pinned: Sequence[torch.Tensor]):
        super().__init__(tensors)
        self.device = device
        self.event = event
        self.pinned = list(pinned)

    def wait(self) -> None:
        """Make the calling thread's current stream wait for the copies,
        and mark every tensor as used on it."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self.event)
        for t in self.values():
            t.record_stream(cur)


class CopyStream:
    """A stream for host-to-device copies on one CUDA device, and the
    pinned buffers of its uploads until their copies complete."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a copy stream needs a CUDA device, got "
                             f"{self.device}")
        self.stream = torch.cuda.Stream(self.device)
        self._held: deque = deque()
        self._lock = threading.Lock()
        self.peak_held_bytes = 0   # the most pinned bytes held at once

    def upload(self, stage: PinnedStage,
               arrays: Dict[str, np.ndarray]) -> PinnedUpload:
        """Copy ``arrays`` (views from ``stage``) to the device on this
        stream; the consumer calls :meth:`PinnedUpload.wait` before it
        reads them."""
        self.sweep()
        with torch.cuda.stream(self.stream):
            out = {k: stage.tensor(a).to(self.device, non_blocking=True)
                   for k, a in arrays.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        with self._lock:
            self._held.append((event, stage.tensors))
            held = sum(t.numel() * t.element_size()
                       for _, ts in self._held for t in ts)
            self.peak_held_bytes = max(self.peak_held_bytes, held)
        return PinnedUpload(out, self.device, event, stage.tensors)

    def download(self, buffers: Sequence[Dict[str, torch.Tensor]]
                 ) -> List[Dict[str, np.ndarray]]:
        """Copy every device tensor of ``buffers`` into pinned host memory
        on this stream (after the work the calling stream has enqueued)
        and wait once, on one event, for all of them."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        out: List[Dict[str, np.ndarray]] = []
        with torch.cuda.stream(self.stream):
            for bufs in buffers:
                host = {}
                for k, t in bufs.items():
                    pinned = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                    pinned.copy_(t, non_blocking=True)
                    t.record_stream(self.stream)
                    host[k] = pinned
                out.append(host)
            event = torch.cuda.Event()
            event.record(self.stream)
        event.synchronize()
        return [{k: t.numpy() for k, t in h.items()} for h in out]

    def sweep(self) -> None:
        """Release the pinned buffers of every upload whose copies have
        completed (events complete in order on one stream)."""
        with self._lock:
            while self._held and self._held[0][0].query():
                self._held.popleft()


def stamp_copy_stream(plan, copy_stream) -> None:
    """Give every transfer exec of ``plan`` (those with a ``copy_stream``
    attribute: HostToDeviceExec, DeviceToHostExec, the Parquet scan, the
    cached scans) the session's stream; None leaves them as they are."""
    if copy_stream is not None:
        plan.foreach(lambda n: setattr(n, "copy_stream", copy_stream)
                     if hasattr(n, "copy_stream") else None)


def upload_arrays(arrays: Dict[str, np.ndarray], device,
                  copy_stream=None) -> Dict[str, torch.Tensor]:
    """``arrays`` as tensors on ``device``, key by key.  On the CPU they
    are the arrays themselves (a copy only of a read-only or strided
    one).  On the card they are written once into one pinned stage and
    copied in one upload on ``copy_stream`` (a fresh one when None); the
    calling thread's stream waits for the copies."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {k: torch.from_numpy(
            a if a.flags.writeable and a.flags.c_contiguous
            else np.array(a)) for k, a in arrays.items()}
    stream = copy_stream if copy_stream is not None else CopyStream(dev)
    stage = PinnedStage()
    up = stream.upload(stage, {k: stage.put(a) for k, a in arrays.items()})
    up.wait()
    return up
