"""Host staging arena: one slab, first-fit sub-allocation.

Ported from ``spark_rapids_tpu/mem/host_arena.py`` (the ctypes binding of
``native/arena.cpp``).  The interface is the reference's:
``HostArena(capacity, alignment=64)``, ``alloc`` returning ``None`` when
no block fits (the caller spills elsewhere), ``allocated``, ``peak``,
``largest_free``, ``num_live``, ``close`` and
``ArenaAllocation.as_numpy``.

The slab is one ``torch.empty(capacity, dtype=torch.uint8)`` tensor:
pinned (page-locked) when ``pin_memory`` is set, so the spill catalog's
device -> host copies into it run at the card's DMA rate (the
reference's pinned host pool), and plain memory on the CPU.  The
allocator is the native arena's: sizes round up to the alignment, the
lowest-offset free block that fits is taken, and freed blocks coalesce
with their neighbours, so the same calls give the same offsets,
``allocated`` and ``peak`` as the reference's arena.
"""

from __future__ import annotations

import bisect
import threading
from typing import List, Optional

import numpy as np
import torch


class ArenaAllocation:
    """One allocation; views of it share the slab's memory."""

    def __init__(self, arena: "HostArena", offset: int, size: int):
        self._arena = arena
        self.offset = offset
        self.size = size
        self._closed = False

    def as_tensor(self) -> torch.Tensor:
        """The allocation's bytes as a uint8 tensor view of the slab."""
        assert not self._closed
        return self._arena._slab[self.offset:self.offset + self.size]

    def as_numpy(self, dtype=np.uint8, shape=None) -> np.ndarray:
        assert not self._closed
        n = self.size // np.dtype(dtype).itemsize
        arr = self.as_tensor().numpy().view(dtype)[:n]
        return arr.reshape(shape) if shape is not None else arr

    def close(self) -> None:
        if not self._closed:
            self._arena._free(self.offset)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class HostArena:
    """First-fit host arena over one slab; alloc failure returns None."""

    def __init__(self, capacity: int, alignment: int = 64,
                 pin_memory: bool = False):
        self.capacity = capacity
        self._align = alignment \
            if alignment >= 8 and alignment & (alignment - 1) == 0 else 64
        self._slab: Optional[torch.Tensor] = torch.empty(
            capacity, dtype=torch.uint8, pin_memory=pin_memory)
        # free blocks as parallel sorted lists (offset, length), kept
        # coalesced; live allocations offset -> length
        self._free_off: List[int] = [0]
        self._free_len: List[int] = [capacity]
        self._live = {}
        self._allocated = 0
        self._peak = 0
        self._lock = threading.Lock()

    def alloc(self, size: int) -> Optional[ArenaAllocation]:
        if size <= 0 or self._slab is None:
            return None
        a = self._align
        block = (size + a - 1) & ~(a - 1)
        with self._lock:
            for i, ln in enumerate(self._free_len):
                if ln >= block:  # first fit
                    off = self._free_off[i]
                    if ln > block:
                        self._free_off[i] = off + block
                        self._free_len[i] = ln - block
                    else:
                        del self._free_off[i]
                        del self._free_len[i]
                    self._live[off] = block
                    self._allocated += block
                    self._peak = max(self._peak, self._allocated)
                    return ArenaAllocation(self, off, size)
        return None

    def _free(self, off: int) -> None:
        with self._lock:
            ln = self._live.pop(off, None)
            if ln is None:
                return
            self._allocated -= ln
            i = bisect.bisect_left(self._free_off, off)
            self._free_off.insert(i, off)
            self._free_len.insert(i, ln)
            # coalesce with the next block, then the previous one
            if i + 1 < len(self._free_off) and \
                    off + ln == self._free_off[i + 1]:
                self._free_len[i] += self._free_len.pop(i + 1)
                del self._free_off[i + 1]
            if i > 0 and self._free_off[i - 1] + self._free_len[i - 1] == off:
                self._free_len[i - 1] += self._free_len.pop(i)
                del self._free_off[i]

    @property
    def allocated(self) -> int:
        return self._allocated

    @property
    def peak(self) -> int:
        return self._peak

    @property
    def largest_free(self) -> int:
        with self._lock:
            return max(self._free_len, default=0)

    @property
    def num_live(self) -> int:
        return len(self._live)

    def close(self) -> None:
        self._slab = None
