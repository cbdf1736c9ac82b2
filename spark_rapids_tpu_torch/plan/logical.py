"""Logical-plan schema types: ``Field`` and ``Schema``.

Ported from ``spark_rapids_tpu/plan/logical.py``: the schema half and
``FileScan``, the node a Parquet scan exec reads its files and options
from; the other logical plan nodes arrive with the planner.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import pyarrow as pa

from spark_rapids_tpu_torch import dtypes as dt


@dataclass(frozen=True)
class Field:
    name: str
    dtype: dt.DType
    nullable: bool = True


class Schema:
    def __init__(self, fields: Sequence[Field]):
        self.fields = list(fields)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def dtypes(self) -> List[dt.DType]:
        return [f.dtype for f in self.fields]

    @property
    def nullables(self) -> List[bool]:
        return [f.nullable for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.name}:{f.dtype.name}" for f in self.fields)
        return f"Schema({inner})"

    @staticmethod
    def from_arrow(schema: pa.Schema) -> "Schema":
        fields = []
        for f in schema:
            d = dt.from_arrow(f.type)
            if d is None:
                raise TypeError(f"unsupported Arrow type {f.type} for "
                                f"column {f.name}")
            fields.append(Field(f.name, d if d != dt.NULL else dt.BOOL,
                                f.nullable))
        return Schema(fields)


class FileScan:
    """Parquet file scan: paths, schema and reader options
    (``columns``, ``part_values``, ``part_fields``, ``file_subset``)."""

    def __init__(self, fmt: str, paths: Sequence[str], schema: Schema,
                 options: Optional[dict] = None):
        self.fmt = fmt
        self.paths = list(paths)
        self._schema = schema
        self.options = dict(options or {})

    @property
    def schema(self) -> Schema:
        return self._schema
