"""The port's CPU expression evaluator against the reference's.

``spark_rapids_tpu_torch/expr/eval_cpu.py`` is a copy of the reference's
CPU engine (the port's fallback path and the oracle of its CPU sessions).
Each expression is built with each package's own ``col``/``functions``,
bound against a ``tests/data_gen.py`` table (nulls and edge cases in every
column) and evaluated by both evaluators; the Arrow results must be equal
(NaN equal to NaN).
"""

import math

import pyarrow as pa
import pytest

from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.expr import eval_cpu as jeval
from spark_rapids_tpu.expr import ir as jir
from spark_rapids_tpu.plan.logical import Schema as JSchema

from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.expr import eval_cpu as teval
from spark_rapids_tpu_torch.expr import ir as tir
from spark_rapids_tpu_torch.plan.logical import Schema as TSchema

from tests import data_gen as g
from tests.torch_threads import one_torch_thread  # noqa: F401

COLS = {"i": g.int_gen, "l": g.long_gen, "s16": g.short_gen,
        "d": g.double_gen, "f": g.float_gen, "b": g.boolean_gen,
        "s": g.string_gen, "dt": g.date_gen, "ts": g.timestamp_gen,
        "k": g.int_key_gen}
SIDES = {"ref": (jcol, JF, jir, JSchema, jeval),
         "port": (tcol, TF, tir, TSchema, teval)}

# name -> make(col, F): one Column
EXPRS = {
    "add": lambda c, F: c("i") + c("l"),
    "sub_float": lambda c, F: c("d") - c("f"),
    "mul": lambda c, F: c("s16") * c("k"),
    "div": lambda c, F: c("l") / c("k"),
    "mod": lambda c, F: c("i") % c("k"),
    "neg": lambda c, F: -c("d"),
    "eq": lambda c, F: c("i") == c("k"),
    "lt_float": lambda c, F: c("d") < c("f"),
    "ge_string": lambda c, F: c("s") >= "m",
    "and_or": lambda c, F: (c("b") & (c("k") > 5)) | (c("i") < 0),
    "not": lambda c, F: ~c("b"),
    "isnull": lambda c, F: F.isnull(c("s")),
    "isnan": lambda c, F: F.isnan(c("d")),
    "isin": lambda c, F: c("k").isin(1, 3, 5),
    "coalesce": lambda c, F: F.coalesce(c("i"), c("k")),
    "when": lambda c, F: F.when(c("k") > 10, c("i")).otherwise(c("l")),
    "abs": lambda c, F: F.abs(c("i")),
    "sqrt": lambda c, F: F.sqrt(c("d")),
    "floor": lambda c, F: F.floor(c("d")),
    "pow": lambda c, F: F.pow(c("k"), 2),
    "pmod": lambda c, F: F.pmod(c("l"), c("k")),
    "shiftleft": lambda c, F: F.shiftleft(c("i"), 3),
    "upper": lambda c, F: F.upper(c("s")),
    "length": lambda c, F: F.length(c("s")),
    "trim": lambda c, F: F.trim(c("s")),
    "initcap": lambda c, F: F.initcap(c("s")),
    "substring": lambda c, F: F.substring(c("s"), 2, 3),
    "concat": lambda c, F: F.concat(c("s"), F.lit("-"), c("s")),
    "like": lambda c, F: c("s").like("%a%"),
    "startswith": lambda c, F: c("s").startswith("a"),
    "regexp_replace": lambda c, F: F.regexp_replace(c("s"), "[aeiou]", "_"),
    "md5": lambda c, F: F.md5(c("s")),
    "hash": lambda c, F: F.hash(c("i"), c("s")),
    "cast_int_string": lambda c, F: c("i").cast("string"),
    "cast_double_int": lambda c, F: c("d").cast("int"),
    "cast_string_double": lambda c, F: c("s").cast("double"),
    "year": lambda c, F: F.year(c("dt")),
    "dayofweek": lambda c, F: F.dayofweek(c("dt")),
    "hour": lambda c, F: F.hour(c("ts")),
    "date_add": lambda c, F: F.date_add(c("dt"), 30),
    "datediff": lambda c, F: F.datediff(c("dt"), F.date_add(c("dt"), 7)),
}


@pytest.fixture(scope="module")
def table():
    return g.gen_table(list(COLS.values()), list(COLS), n=400, seed=21)


def _eval(side: str, name: str, table: pa.Table) -> pa.Array:
    col, F, ir, Schema, ev = SIDES[side]
    schema = Schema.from_arrow(table.schema)
    e = ir.bind(EXPRS[name](col, F).expr, schema.names, schema.dtypes,
                schema.nullables)
    return ev.to_arrow_array(ev.evaluate(e, table))


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and \
            math.isnan(a) and math.isnan(b):
        return True
    return a == b


@pytest.mark.parametrize("name", list(EXPRS))
def test_eval_cpu_matches_reference(table, name):
    ref, port = (_eval(side, name, table) for side in SIDES)
    assert port.type == ref.type
    assert port.null_count == ref.null_count < len(port)
    bad = [i for i, (a, b) in enumerate(zip(ref.to_pylist(),
                                            port.to_pylist()))
           if not _same(a, b)]
    assert not bad, (name, bad[:5])
