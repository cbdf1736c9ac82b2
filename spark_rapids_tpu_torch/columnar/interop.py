"""Carry a batch's state across as numpy arrays.

The second carrier, :func:`fused_arrays_to_torch`, uploads the numpy
upload set of a fused Parquet plan (``_FusedPlan.arrays`` of either
package) for the port's device half: on the card through pinned memory
on a copy stream (columnar/transfer.py).

A batch is fully described by its *leaves*: the column names, each
column's dtype name, data, validity, lengths, elem_validity, ``vbits``
and ``nonnull`` hints, and the batch's ``num_rows``.  Parity tests read
the leaves of a reference (JAX) batch with ``numpy.asarray`` and hand
the very same padded batch, or the same partial-aggregate buffers, to
the port through :func:`batch_from_numpy` — the counterpart of carrying
a model's weights across.

The leaves are a plain dict::

    {"names": [...], "num_rows": int,
     "columns": [{"dtype": "bigint", "data": ndarray, "validity": ndarray,
                  "lengths": ndarray | None, "elem_validity": ndarray | None,
                  "vbits": int | None, "nonnull": bool}, ...]}
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, DeviceColumn,
                                                   resolve_device)
from spark_rapids_tpu_torch.columnar.transfer import CopyStream, PinnedStage


def dtype_from_name(name: str) -> dt.DType:
    """Inverse of ``DType.name`` for the device-supported types."""
    if name.startswith("array<") and name.endswith(">"):
        return dt.list_of(dtype_from_name(name[len("array<"):-1]))
    return dt.DType(dt.TypeId(name))


def _tensor(a, dev):
    if a is None:
        return None
    return torch.from_numpy(np.array(a)).to(dev)  # a writable copy


def batch_from_numpy(leaves: Dict[str, Any], device="cuda") -> DeviceBatch:
    """Build the port's DeviceBatch from numpy leaves (see module doc)."""
    dev = resolve_device(device)
    cols = []
    for c in leaves["columns"]:
        cols.append(DeviceColumn(
            dtype_from_name(c["dtype"]), _tensor(c["data"], dev),
            _tensor(np.asarray(c["validity"], dtype=bool), dev),
            _tensor(c.get("lengths"), dev),
            _tensor(c.get("elem_validity"), dev),
            vbits=c.get("vbits"), nonnull=bool(c.get("nonnull", False))))
    return DeviceBatch(leaves["names"], cols, int(leaves["num_rows"]), dev)


def batch_to_numpy(batch: DeviceBatch) -> Dict[str, Any]:
    """The numpy leaves of a port DeviceBatch (reads ``num_rows``)."""
    def host(a):
        return None if a is None else a.cpu().numpy()
    return {
        "names": list(batch.names),
        "num_rows": int(batch.num_rows),
        "columns": [{"dtype": c.dtype.name, "data": host(c.data),
                     "validity": host(c.validity),
                     "lengths": host(c.lengths),
                     "elem_validity": host(c.elem_validity),
                     "vbits": c.vbits, "nonnull": bool(c.nonnull)}
                    for c in batch.columns],
    }


def fused_arrays_to_torch(np_arrays: Dict[str, np.ndarray], device="cuda",
                          copy_stream: Optional[CopyStream] = None,
                          stage: Optional[PinnedStage] = None
                          ) -> Dict[str, torch.Tensor]:
    """A fused Parquet plan's upload set (``_FusedPlan.arrays``: packed
    bits, run tables, meta, plain and dictionary buffers, all numpy) as
    tensors on ``device``, key by key.

    On the CPU a writable array is shared, not copied; the decode never
    writes into its inputs.  On the card every array is staged in pinned
    memory (``stage``, where ``assemble`` built the large ones in place;
    the others are copied there) and copied on ``copy_stream`` (a fresh
    one when None) without blocking the host: the result is a
    :class:`~spark_rapids_tpu_torch.columnar.transfer.PinnedUpload`, whose
    ``wait()`` the consumer calls before it reads the tensors."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {k: torch.from_numpy(v if v.flags.writeable else v.copy())
                .to(dev) for k, v in np_arrays.items()}
    stage = stage or PinnedStage()
    views = {k: stage.put(v) for k, v in np_arrays.items()}
    return (copy_stream or CopyStream(dev)).upload(stage, views)
