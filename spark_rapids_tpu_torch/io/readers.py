"""File scan helpers shared by the scan execs.

Ported from ``spark_rapids_tpu/io/readers.py``: only
``scan_file_indices`` so far (the host Arrow readers are not ported).
"""

from __future__ import annotations

import os
from typing import List


def scan_file_indices(scan) -> List[int]:
    """File indices a scan should actually read: all of them, unless a
    ``file_subset`` restriction is stamped in the scan options.
    Index-based so ``part_values``/``part_fields`` alignment survives the
    restriction."""
    subset = scan.options.get("file_subset")
    if subset is None:
        return list(range(len(scan.paths)))
    keep = {os.path.abspath(p) for p in subset}
    return [i for i, p in enumerate(scan.paths)
            if os.path.abspath(p) in keep]
