"""The port's SQL front end against the reference's.

``session.sql`` parses a query against the temp views
(``sql/parser.py``, copied from the reference with its imports
retargeted).  Over ``tests/test_sql.py``'s query corpus (its queries,
the SELECT-surface sweeps and the join surface, over the same tables):

  * ``parse_sql`` lowers each query to the same logical plan as the
    reference's (their tree strings);
  * each query's rows on a port session (``device="cpu"``) equal the
    reference's CPU engine (``sql.enabled=false``, no XLA compiles):
    integers, strings and nulls exactly, floats to ``tests/parity.py``'s
    tolerance, order-insensitively where the query has no total order;
  * the bad queries raise ``SqlParseError`` with the reference's text;
  * the function registry has the reference's names, no more, no fewer;
  * the view surface: ``register_view``, ``drop_view``, ``catalog`` and
    ``create_or_replace_temp_view``; prepared statements' parameters.
"""

import pyarrow as pa
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.sql import parser as jparser

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.sql import parser as tparser

from tests import test_sql as ref_sql
from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.castStringToFloat.enabled": True}

# test_sql.py's single queries beyond its QUERIES list
EXTRA = [
    "SELECT name, city_name FROM people JOIN "
    "(SELECT city_code AS city, city_name FROM cities) c "
    "USING (city) ORDER BY name",
    "SELECT bracket, count(*) AS n FROM (SELECT CASE WHEN age > 25 "
    "THEN 'old' ELSE 'young' END AS bracket FROM people WHERE age "
    "IS NOT NULL) t GROUP BY bracket ORDER BY bracket",
    "SELECT name FROM people WHERE age >= 30 UNION ALL "
    "SELECT emp FROM hires WHERE emp = 'gus' ORDER BY name DESC",
    "SELECT lpad(name, 5, '.') AS l, rpad(name, 5, '.') AS r, "
    "replace(name, 'a', 'o') AS rep, locate('a', name) AS loc "
    "FROM people WHERE name = 'ann'",
    "SELECT city, count(DISTINCT age) AS n FROM people "
    "GROUP BY city ORDER BY city NULLS LAST",
    "SELECT sum(DISTINCT salary) AS s FROM people",
]
CORPUS = (ref_sql.QUERIES + EXTRA + ref_sql._QA_SWEEP +
          ref_sql._QA_SWEEP2 + ref_sql._QA_JOINS)


def _register(s):
    for name, t in ref_sql._data().items():
        s.create_dataframe(t).create_or_replace_temp_view(name)
    s.create_dataframe(ref_sql._qa_table(), num_partitions=3) \
        .create_or_replace_temp_view("qa")
    return s


@pytest.fixture(scope="module")
def sessions():
    return {"ref": _register(JSession({"spark.rapids.tpu.sql.enabled":
                                       False})),
            "port": _register(TSession(CONF, device="cpu"))}


@pytest.mark.parametrize("q", CORPUS)
def test_parse_sql_plan_matches_reference(sessions, q):
    ref = jparser.parse_sql(q, sessions["ref"].catalog).tree_string()
    port = tparser.parse_sql(q, sessions["port"].catalog).tree_string()
    assert port == ref


@pytest.mark.parametrize("q", CORPUS)
def test_sql_rows_match_reference(sessions, q):
    ignore = "ORDER BY" not in q or "GROUP BY" in q
    assert_tables_equal(sessions["ref"].sql(q).collect(),
                        sessions["port"].sql(q).collect(),
                        ignore_order=ignore)


@pytest.mark.parametrize("bad", [
    "SELECT * FROM nope",
    "SELECT name FROM people WHERE",
    "SELECT unknown_fn(age) FROM people",
    "SELECT p.oops FROM people p",
])
def test_bad_queries_raise_the_reference_error(sessions, bad):
    with pytest.raises(jparser.SqlParseError) as ref:
        sessions["ref"].sql(bad)
    with pytest.raises(tparser.SqlParseError) as port:
        sessions["port"].sql(bad)
    assert str(port.value) == str(ref.value)


def test_function_registry_has_the_reference_names():
    assert set(tparser._FUNCTIONS) == set(jparser._FUNCTIONS)


def test_views_register_drop_and_catalog():
    t = pa.table({"k": [3, 1, 2], "v": ["c", "a", "b"]})
    out = {}
    for side, s in (("ref", JSession({"spark.rapids.tpu.sql.enabled":
                                      False})),
                    ("port", TSession(CONF, device="cpu"))):
        df = s.create_dataframe(t)
        df.create_or_replace_temp_view("T")
        df.createOrReplaceTempView("Big")
        s.register_view("Big", df)     # replaces the view of that name
        assert sorted(s.catalog) == ["big", "t"]
        rows = s.sql("SELECT v FROM t WHERE k >= 2 ORDER BY v").collect()
        s.drop_view("BIG")
        s.drop_view("absent")
        assert sorted(s.catalog) == ["t"]
        with pytest.raises(ValueError, match="not found"):
            s.sql("SELECT * FROM big")
        out[side] = rows
    assert out["port"].equals(out["ref"])
    assert out["port"].column("v").to_pylist() == ["b", "c"]


def test_prepared_parameters_match_reference(sessions):
    q = "SELECT name, age FROM people WHERE age > :lo AND city <> :c"
    plans = {}
    for side, (mod, dtm) in (("ref", (jparser, jdt)),
                             ("port", (tparser, tdt))):
        types = {"lo": dtm.INT32, "c": dtm.STRING, "unused": dtm.DATE32}
        plan, seen = mod.parse_prepared(q, sessions[side].catalog, types)
        assert sorted(seen) == ["c", "lo"]
        assert repr(mod.SqlParam("lo")) == ":lo"
        plans[side] = plan.tree_string()
    assert plans["port"] == plans["ref"]
    with pytest.raises(tparser.SqlParseError):
        tparser.parse_sql("SELECT * FROM people WHERE age > :lo",
                          sessions["port"].catalog)


def test_port_sources_import_neither_jax_nor_the_reference():
    """No module of the port, and neither ``chip_smoke.py``, has an
    import statement naming jax or the reference package (the new SQL,
    cache, writer and TPC-H modules among them)."""
    import pathlib
    import re
    repo = pathlib.Path(__file__).resolve().parents[1]
    pat = re.compile(r"^\s*(import|from)\s+(jax|spark_rapids_tpu)(\.|\s|$)")
    files = sorted((repo / "spark_rapids_tpu_torch").rglob("*.py")) + \
        [repo / "chip_smoke.py"]
    bad = [f"{f.name}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert (repo / "spark_rapids_tpu_torch" / "sql" / "parser.py") in files
    assert bad == []
