"""The port's device regex (expr/device_regex.py), RLIKE and
regexp_replace vs the reference's.

The NFA engine's ``rlike`` and ``match_ends`` over the same byte matrix
equal the reference's and Python's ``re`` (find anywhere; the longest
match per start); patterns outside the subset raise ``Unsupported`` in
both.  RLIKE and regexp_replace (the literal-needle path and the NFA
path) go through ``eval_tpu.evaluate`` in both packages on one seeded
batch, bytes and lengths exactly.  At the DataFrame level the port's
device session equals the reference's CPU engine, and a pattern or
replacement the device cannot take stays on the CPU with the reference's
reason text, word for word.  The cases mirror the reference's
``tests/test_device_regex.py`` and the regexp_replace cases of
``tests/test_expr_longtail.py`` (the Java template ones among them).
"""

import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.columnar.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.config import RapidsTpuConf as JConf
from spark_rapids_tpu.expr import device_regex as jdr
from spark_rapids_tpu.expr import eval_tpu as jev
from spark_rapids_tpu.expr import ir as jir
from spark_rapids_tpu.plan import overrides as jov

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.columnar.batch import from_arrow as tfrom_arrow
from spark_rapids_tpu_torch.config import RapidsTpuConf as TConf
from spark_rapids_tpu_torch.expr import device_regex as tdr
from spark_rapids_tpu_torch.expr import eval_tpu as tev
from spark_rapids_tpu_torch.expr import ir as tir
from spark_rapids_tpu_torch.plan import overrides as tov

from tests.parity import assert_tables_equal
from tests.test_torch_strings import assert_same
from tests.torch_threads import one_torch_thread  # noqa: F401

_STRINGS = ["", "abc", "aabbb", "a1b2c3", "  x  ", "a.b", "0x1F",
            "aaa", "abcabc", "-a-b-", "Foo123", "tail7", "7head",
            "a" * 30, "ab" * 12, "x1x22x333", "é1é", "ab\ncd"]


def _mat(strings, w=32):
    data = np.zeros((len(strings), w), np.uint8)
    lens = np.zeros((len(strings),), np.int32)
    for i, s in enumerate(strings):
        b = s.encode()
        data[i, :len(b)] = list(b)
        lens[i] = len(b)
    return data, lens


RLIKE_PATTERNS = [
    "abc", "a+b", "a*b+c?", "[abc]+", "[^abc]", "a{2,3}", "x{2}",
    "^a", "c$", "^abc$", "(ab)+", "a|b|cc", r"\d+", r"\w+", r"\s",
    r"a\.b", "[a-c][0-9]", "(a|b)c", "a.c", ".*x", "(?:ab|cd)+",
    "[0-9]{1,3}", r"\d{2,}", "^$", "^[ab]+$", "a{0,2}b", "b.c",
]


@pytest.mark.parametrize("pat", RLIKE_PATTERNS)
def test_rlike_engine_matches_reference_and_re(pat):
    data, lens = _mat(_STRINGS)
    got = tdr.rlike(tdr.compile_pattern(pat), torch.from_numpy(data),
                    torch.from_numpy(lens)).numpy()
    ref = np.asarray(jdr.rlike(jdr.compile_pattern(pat), data, lens))
    want = np.array([re.search(pat, s) is not None for s in _STRINGS])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pat", [
    "a+b", "[abc]{2}", r"\d+", "[a-c][0-9]", "a.c", "x{2,3}", "^a+",
    r"\d+$", "a{1,4}", "(ab)+", "^[a-z]+$",
])
def test_match_ends_matches_reference(pat):
    data, lens = _mat(_STRINGS)
    got = tdr.match_ends(tdr.compile_pattern(pat), torch.from_numpy(data),
                         torch.from_numpy(lens)).numpy()
    want = np.asarray(jdr.match_ends(jdr.compile_pattern(pat), data, lens))
    np.testing.assert_array_equal(got, want)


def test_sixty_three_states_use_the_sign_bit():
    """A pattern of 63 positions puts its accepting state in bit 63, the
    int64 sign bit."""
    pat = "a" * 31 + "b{1,32}"
    cr = tdr.compile_pattern(pat)
    assert cr.n_states == 64
    strings = ["a" * 31 + "b" * k for k in (0, 1, 31, 32)] + ["x"]
    data, lens = _mat(strings, 64)
    got = tdr.rlike(cr, torch.from_numpy(data), torch.from_numpy(lens))
    assert got.tolist() == [re.search(pat, s) is not None for s in strings]
    ends = tdr.match_ends(cr, torch.from_numpy(data), torch.from_numpy(lens))
    want = np.asarray(jdr.match_ends(jdr.compile_pattern(pat), data, lens))
    np.testing.assert_array_equal(ends.numpy(), want)


@pytest.mark.parametrize("pat", [
    r"(a|b)\1", r"(?=x)a", r"a*?", r"\p{L}", "a{40}", "(?i)x",
    r"a\b", "a$b", "^a|b", "a|b$", "^a|b$",
])
def test_unsupported_patterns_raise(pat):
    with pytest.raises(tdr.Unsupported):
        tdr.compile_pattern(pat)
    with pytest.raises(jdr.Unsupported):
        jdr.compile_pattern(pat)


def test_replace_safe_gate_is_the_references():
    for pat in (r"[0-9]+", r"a{2,5}", r"ab*c", r"a{1,2}(ab)?", r"a*b?",
                r"x|yy", r"\s+", "[a-z]{2,}"):
        assert tdr.compile_pattern(pat).replace_safe == \
            jdr.compile_pattern(pat).replace_safe, pat


def _table() -> pa.Table:
    rng = np.random.default_rng(11)
    pool = list("ab1 x.é9")
    words = _STRINGS + ["".join(pool[i] for i in
                                rng.integers(0, len(pool),
                                             int(rng.integers(0, 24))))
                        for _ in range(70)]
    return pa.table({"s": pa.array([None if i % 13 == 4 else w
                                    for i, w in enumerate(words)])})


TABLE = _table()

EXPRS = {
    "rlike_digits": lambda ir: ir.RLike(ir.UnresolvedAttribute("s"),
                                        ir.Literal(r"\d+")),
    "rlike_anchored": lambda ir: ir.RLike(ir.UnresolvedAttribute("s"),
                                          ir.Literal("^[a-z]+$")),
    "rlike_alternation": lambda ir: ir.RLike(ir.UnresolvedAttribute("s"),
                                             ir.Literal("x|9")),
    "rlike_null_pattern": lambda ir: ir.RLike(
        ir.UnresolvedAttribute("s"), ir.Literal(None, ir_dt(ir).STRING)),
    "replace_literal": lambda ir: _replace(ir, "ab", "<>"),
    "replace_literal_longer": lambda ir: _replace(ir, "a", "xyz"),
    "replace_literal_delete": lambda ir: _replace(ir, "b", ""),
    "replace_multibyte": lambda ir: _replace(ir, "é", "e"),
    "replace_digits": lambda ir: _replace(ir, "[0-9]+", "#"),
    "replace_words": lambda ir: _replace(ir, "[a-z]{2,}", "<w>"),
    "replace_spaces": lambda ir: _replace(ir, r"\s+", "_"),
    "replace_anchored": lambda ir: _replace(ir, "^a+", "A"),
    "replace_end": lambda ir: _replace(ir, r"\d$", "!"),
}


def ir_dt(ir):
    return jdt if ir is jir else tdt


def _replace(ir, pat, rep):
    return ir.RegExpReplace(ir.UnresolvedAttribute("s"), ir.Literal(pat),
                            ir.Literal(rep))


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_reference(name):
    jb, tb = jfrom_arrow(TABLE), tfrom_arrow(TABLE, device="cpu")
    je = jir.bind(EXPRS[name](jir), ["s"], [jdt.STRING])
    te = tir.bind(EXPRS[name](tir), ["s"], [tdt.STRING])
    assert_same(jev.evaluate(je, jb), tev.evaluate(te, tb))


def _reasons(ov, ir, dt, e):
    e = ir.bind(e, ["s"], [dt.STRING])
    out = []

    def walk(n):
        r = ov._check_expr_node(n, (JConf if ov is jov else TConf)({}))
        if r:
            out.append(r)
        for c in n.children:
            walk(c)
    walk(e)
    return out


FALLBACKS = {
    "rlike_backreference": lambda ir: ir.RLike(
        ir.UnresolvedAttribute("s"), ir.Literal(r"(a)\1")),
    "rlike_column_pattern": lambda ir: ir.RLike(
        ir.UnresolvedAttribute("s"), ir.UnresolvedAttribute("s")),
    "replace_group_reference": lambda ir: _replace(ir, "(fo+)", "<$1>"),
    "replace_escaped_dollar": lambda ir: _replace(ir, "o", "\\$"),
    "replace_divergent": lambda ir: _replace(ir, r"a{1,2}(ab)?", "X"),
    "replace_alternation": lambda ir: _replace(ir, "x|yy", "X"),
    "replace_outside_subset": lambda ir: _replace(ir, r"(?=x)a", "X"),
    "replace_empty_pattern": lambda ir: _replace(ir, "", "X"),
}


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_planner_keeps_the_references_fallback_reason(name):
    want = _reasons(jov, jir, jdt, FALLBACKS[name](jir))
    got = _reasons(tov, tir, tdt, FALLBACKS[name](tir))
    assert want and got == want


def _str_table():
    return pa.table({"s": pa.array(
        ["foo123", "bar", None, "x9y8", "aa bb", "Zebra77",
         "", "a.b.c", "123", "mixed Case 42"])})


BASE = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True}


def _both(fn, port_conf=BASE):
    """``fn(session, col, F)`` on the reference's CPU engine and on a port
    session on the CPU; returns (the port's DataFrame, its rows)."""
    want = fn(JSession({"spark.rapids.tpu.sql.enabled": False}), jcol,
              JF).collect()
    df = fn(TSession(port_conf, device="cpu"), tcol, TF)
    got = df.collect()
    assert_tables_equal(want, got)
    return df, got


def test_rlike_query_runs_on_the_device():
    df, _ = _both(lambda s, col, F: s.create_dataframe(_str_table()).select(
        col("s").rlike(r"\d+").alias("has_digit"),
        col("s").rlike("^[a-z]+$").alias("lower_only"),
        col("s").rlike("a{2}").alias("double_a")))
    assert "TpuProjectExec" in df.explain_string("physical")


def test_rlike_filter():
    df, out = _both(lambda s, col, F: s.create_dataframe(_str_table())
                    .filter(col("s").rlike("^[a-z]+[0-9]+$")))
    assert out.column("s").to_pylist() == ["foo123"]
    assert "Cpu" not in df.explain_string("physical").replace(
        "CpuScanExec", "")


def test_regexp_replace_query_runs_on_the_device():
    _, out = _both(lambda s, col, F: s.create_dataframe(_str_table()).select(
        F.regexp_replace(col("s"), r"[0-9]+", "#").alias("r1"),
        F.regexp_replace(col("s"), r"[a-z]{2,}", "<w>").alias("r2"),
        F.regexp_replace(col("s"), r"\s+", "_").alias("r3"),
        F.regexp_replace(col("s"), "a", "").alias("r4")))
    assert out.column("r1").to_pylist()[0] == "foo#"


def test_java_template_replacements_fall_back():
    """$0 / $1 group references and an escaped dollar stay on the CPU with
    the reference's reason, and give Java's template results."""
    t = pa.table({"s": ["foo", "C:path", "foo123bar456"]})
    df, out = _both(lambda s, col, F: s.create_dataframe(t).select(
        F.regexp_replace(col("s"), "(fo+)", "[$0]").alias("whole"),
        F.regexp_replace(col("s"), "(fo+)", "<$1>").alias("g"),
        F.regexp_replace(col("s"), "o", "\\$").alias("esc")),
        dict(BASE, **{"spark.rapids.tpu.sql.test.allowedNonTpu":
                      "CpuProjectExec"}))
    assert out.column("whole").to_pylist()[0] == "[foo]"
    assert out.column("g").to_pylist()[2] == "<foo>123bar456"
    assert out.column("esc").to_pylist()[0] == "f$$"
    assert "group/backslash references" in df.explain_string("tpu")


def test_divergent_pattern_falls_back_with_java_semantics():
    t = pa.table({"s": ["aab", "ab"]})
    df, out = _both(lambda s, col, F: s.create_dataframe(t).select(
        F.regexp_replace(col("s"), r"a{1,2}(ab)?", "X").alias("r")),
        dict(BASE, **{"spark.rapids.tpu.sql.test.allowedNonTpu":
                      "CpuProjectExec"}))
    assert out.column("r").to_pylist() == ["Xb", "Xb"]
    assert "may differ from longest-match" in df.explain_string("tpu")


def test_rlike_null_pattern_yields_null():
    from spark_rapids_tpu.api.column import Column as JColumn
    from spark_rapids_tpu_torch.api.column import Column as TColumn

    def fn(s, col, F):
        ir, C, dt = (jir, JColumn, jdt) if col is jcol else \
            (tir, TColumn, tdt)
        return s.create_dataframe(_str_table()).select(
            C(ir.RLike(ir.UnresolvedAttribute("s"),
                       ir.Literal(None, dt.STRING))).alias("r"))
    _, out = _both(fn)
    assert out.column("r").null_count == out.num_rows
