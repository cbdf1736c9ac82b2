"""SQL tokenizer + recursive-descent parser + lowering to logical plans.

Ported from ``spark_rapids_tpu/sql/parser.py`` unchanged but for its
imports, which name the port's ``expr/ir``, ``plan/logical`` and
``api/functions``/``api/column``.

Grammar (subset, case-insensitive keywords):

  query     := [WITH name AS (query) [, ...]] select
  select    := SELECT [DISTINCT] proj [, ...] [FROM from] [WHERE expr]
               [GROUP BY expr [, ...]] [HAVING expr]
               [ORDER BY order [, ...]] [LIMIT n]
               [UNION [ALL] select]
  from      := relation (("," | [INNER|LEFT|RIGHT|FULL|CROSS|
               LEFT SEMI|LEFT ANTI] JOIN) relation [ON expr |
               USING (col [, ...])])*
  relation  := name [[AS] alias] | "(" query ")" [AS] alias
  proj      := "*" | name ".*" | expr [[AS] alias]
  expr      := the usual precedence chain: OR, AND, NOT, comparison
               (=, <>, !=, <, <=, >, >=, [NOT] BETWEEN, [NOT] IN,
               [NOT] LIKE, IS [NOT] NULL), additive, multiplicative,
               unary -, atoms (literal, DATE '...', TIMESTAMP '...',
               CAST(e AS type), CASE [e] WHEN .. THEN .. ELSE .. END,
               function(args), [qualifier.]column, "(" expr ")")

Lowering targets the DataFrame-layer plan builders so SQL and DataFrame
queries share one planning/override path (the reference's position: Spark
parses, the plugin only sees physical plans).
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.expr import ir
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.logical import SortOrder

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?
      |\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*|`[^`]+`)
  | (?P<param>:[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=|>=|<>|!=|\|\||[=<>+\-*/%(),.])
""", re.VERBOSE)

_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having",
    "order", "limit", "union", "all", "as", "and", "or", "not", "in",
    "between", "like", "rlike", "regexp", "is", "null", "case", "when",
    "then", "else",
    "end", "cast", "join", "inner", "left", "right", "full", "outer",
    "cross", "semi", "anti", "on", "using", "with", "asc", "desc",
    "date", "timestamp", "interval", "true", "false", "exists",
    "nulls", "first", "last",
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind: str, value: str, pos: int):
        self.kind = kind          # num | str | name | kw | op | eof
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"Token({self.kind},{self.value!r})"


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise SqlParseError(f"unexpected character {text[i]!r} at "
                                f"position {i}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        v = m.group()
        if m.lastgroup == "name":
            if v.startswith("`"):
                out.append(Token("name", v[1:-1], m.start()))
            elif v.lower() in _KEYWORDS:
                out.append(Token("kw", v.lower(), m.start()))
            else:
                out.append(Token("name", v, m.start()))
        elif m.lastgroup == "str":
            out.append(Token("str", v[1:-1].replace("''", "'"),
                             m.start()))
        else:
            out.append(Token(m.lastgroup, v, m.start()))
    out.append(Token("eof", "", len(text)))
    return out


class SqlParseError(ValueError):
    pass


class SqlParam:
    """Placeholder VALUE carried by a ``:name`` parameter's Literal in a
    prepared-statement plan template (serve/statements.py).  The
    template parses and plans once with these markers in place; each
    execution deep-copies the template and swaps the markers for the
    bound values — the Literal's declared dtype (and therefore every
    downstream type resolution) never changes, so binding is a value
    substitution, not a re-plan.  Executing a template with an unbound
    SqlParam still in it is a bug; kernels fail loudly on the marker.
    """

    def __init__(self, name_: str):
        self.name = name_

    def __repr__(self) -> str:
        return f":{self.name}"

    def __eq__(self, other) -> bool:
        return isinstance(other, SqlParam) and other.name == self.name

    def __hash__(self) -> int:
        return hash(("SqlParam", self.name))


# ---------------------------------------------------------------------------
# Parser → logical plan (parse and lower in one pass; scopes carry the
# alias → column-name mapping so qualified references resolve)
# ---------------------------------------------------------------------------

_TYPE_NAMES = {
    "boolean": "boolean", "bool": "boolean",
    "tinyint": "byte", "byte": "byte",
    "smallint": "short", "short": "short",
    "int": "int", "integer": "int",
    "bigint": "long", "long": "long",
    "float": "float", "real": "float",
    "double": "double",
    "string": "string", "varchar": "string", "char": "string",
    "date": "date", "timestamp": "timestamp",
}

_FUNCTIONS = {}  # name -> builder(args: List[ir.Expression]) -> Expression


def _fn(name):
    def deco(f):
        _FUNCTIONS[name] = f
        return f
    return deco


def _register_functions():
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import Column

    def wrap(builder, arity=None):
        def b(args):
            if arity is not None and len(args) != arity:
                raise SqlParseError(
                    f"wrong argument count for function (expected "
                    f"{arity}, got {len(args)})")
            cols = [Column(a) for a in args]
            return builder(*cols).expr
        return b

    simple = {
        "abs": F.abs, "sqrt": F.sqrt, "exp": F.exp, "ln": F.log,
        "log": F.log, "log2": F.log2, "log10": F.log10,
        "sin": F.sin, "cos": F.cos, "tan": F.tan, "asin": F.asin,
        "acos": F.acos, "atan": F.atan, "cbrt": F.cbrt,
        "degrees": F.degrees, "radians": F.radians,
        "ceil": F.ceil, "ceiling": F.ceil, "floor": F.floor,
        "signum": F.signum, "sign": F.signum,
        "upper": F.upper, "ucase": F.upper,
        "lower": F.lower, "lcase": F.lower,
        "length": F.length, "char_length": F.length,
        "trim": F.trim, "ltrim": F.ltrim, "rtrim": F.rtrim,
        "initcap": F.initcap, "reverse": F.reverse,
        "year": F.year, "month": F.month,
        "day": F.dayofmonth, "dayofmonth": F.dayofmonth,
        "dayofyear": F.dayofyear, "dayofweek": F.dayofweek,
        "weekofyear": F.weekofyear, "quarter": F.quarter,
        "hour": F.hour, "minute": F.minute, "second": F.second,
        "isnull": F.isnull, "isnan": F.isnan,
    }
    for n, f in simple.items():
        _FUNCTIONS[n] = wrap(f, 1)
    _FUNCTIONS["substring"] = _FUNCTIONS["substr"] = wrap(F.substring, 3)
    _FUNCTIONS["concat"] = wrap(F.concat)
    _FUNCTIONS["coalesce"] = wrap(F.coalesce)
    _FUNCTIONS["nanvl"] = wrap(F.nanvl, 2)
    _FUNCTIONS["pow"] = _FUNCTIONS["power"] = wrap(F.pow, 2)
    _FUNCTIONS["atan2"] = wrap(F.atan2, 2)
    _FUNCTIONS["pmod"] = wrap(F.pmod, 2)
    _FUNCTIONS["shiftleft"] = wrap(F.shiftleft, 2)
    _FUNCTIONS["shiftright"] = wrap(F.shiftright, 2)
    # these F helpers take raw python scalars for some arguments, so
    # unwrap the parsed Literal expressions instead of Column-wrapping
    def _lit(e: ir.Expression, what: str):
        if not isinstance(e, ir.Literal):
            raise SqlParseError(f"{what} must be a literal")
        return e.value

    def _locate(args):
        if len(args) not in (2, 3):
            raise SqlParseError("locate takes 2 or 3 arguments")
        pos = _lit(args[2], "locate position") if len(args) == 3 else 1
        return F.locate(_lit(args[0], "locate substring"),
                        Column(args[1]), pos).expr

    def _pad(f):
        def b(args):
            if len(args) != 3:
                raise SqlParseError("pad takes 3 arguments")
            return f(Column(args[0]), _lit(args[1], "pad length"),
                     _lit(args[2], "pad string")).expr
        return b

    def _replace(args):
        if len(args) != 3:
            raise SqlParseError("replace takes 3 arguments")
        return F.replace(Column(args[0]), _lit(args[1], "search"),
                         _lit(args[2], "replacement")).expr

    _FUNCTIONS["md5"] = wrap(F.md5, 1)
    _FUNCTIONS["from_unixtime"] = wrap(F.from_unixtime, 1)
    _FUNCTIONS["input_file_name"] = wrap(
        lambda: F.input_file_name(), 0)

    def _substring_index(args):
        if len(args) != 3:
            raise SqlParseError("substring_index takes 3 arguments")
        return F.substring_index(
            Column(args[0]), _lit(args[1], "delimiter"),
            _lit(args[2], "count")).expr

    def _regexp_replace(args):
        if len(args) != 3:
            raise SqlParseError("regexp_replace takes 3 arguments")
        return F.regexp_replace(Column(args[0]),
                                _lit(args[1], "pattern"),
                                _lit(args[2], "replacement")).expr

    def _split(args):
        if len(args) not in (2, 3):
            raise SqlParseError("split takes 2 or 3 arguments")
        limit = _lit(args[2], "limit") if len(args) == 3 else -1
        return F.split(Column(args[0]), _lit(args[1], "pattern"),
                       limit).expr

    _FUNCTIONS["substring_index"] = _substring_index
    _FUNCTIONS["regexp_replace"] = _regexp_replace
    _FUNCTIONS["split"] = _split
    _FUNCTIONS["locate"] = _locate
    _FUNCTIONS["lpad"] = _pad(F.lpad)
    _FUNCTIONS["rpad"] = _pad(F.rpad)
    _FUNCTIONS["replace"] = _replace
    _FUNCTIONS["date_add"] = wrap(F.date_add, 2)
    _FUNCTIONS["date_sub"] = wrap(F.date_sub, 2)
    _FUNCTIONS["datediff"] = wrap(F.datediff, 2)
    _FUNCTIONS["unix_timestamp"] = wrap(F.unix_timestamp, 1)
    _FUNCTIONS["hash"] = wrap(F.hash)
    _FUNCTIONS["if"] = wrap(F.if_, 3)
    # aggregates
    _FUNCTIONS["sum"] = lambda a: ir.Sum(a[0])
    _FUNCTIONS["min"] = lambda a: ir.Min(a[0])
    _FUNCTIONS["max"] = lambda a: ir.Max(a[0])
    _FUNCTIONS["avg"] = _FUNCTIONS["mean"] = lambda a: ir.Average(a[0])
    _FUNCTIONS["first"] = lambda a: ir.First(a[0])
    _FUNCTIONS["last"] = lambda a: ir.Last(a[0])


_register_functions()


class _Scope:
    """Column resolution scope: output column names + alias→names map."""

    def __init__(self, names: List[str],
                 by_alias: Optional[Dict[str, List[str]]] = None):
        self.names = list(names)
        self.by_alias = dict(by_alias or {})


class Parser:
    def __init__(self, text: str, catalog, param_types=None):
        self.toks = tokenize(text)
        self.i = 0
        self.catalog = catalog        # name -> LogicalPlan
        self.ctes: Dict[str, lp.LogicalPlan] = {}
        # prepared-statement parameter declarations: name -> DType
        # (``:name`` atoms lower to SqlParam-valued Literals of the
        # declared dtype; undeclared parameters are parse errors)
        self.param_types = dict(param_types or {})
        self.params_seen: Dict[str, object] = {}

    # -- token helpers ----------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None
               ) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            raise SqlParseError(
                f"expected {value or kind}, got {got.value!r} at "
                f"position {got.pos}")
        return t

    def kw(self, *words) -> bool:
        """Accept a keyword sequence."""
        for k, w in enumerate(words):
            t = self.peek(k)
            if not (t.kind == "kw" and t.value == w):
                return False
        for _ in words:
            self.next()
        return True

    # -- entry ------------------------------------------------------------
    def parse(self) -> lp.LogicalPlan:
        plan = self.query()
        self.expect("eof")
        return plan

    def query(self) -> lp.LogicalPlan:
        if self.kw("with"):
            while True:
                name = self.expect("name").value
                self.expect("kw", "as")
                self.expect("op", "(")
                self.ctes[name.lower()] = self.query()
                self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        return self.select_stmt()

    # -- SELECT -----------------------------------------------------------
    def select_stmt(self) -> lp.LogicalPlan:
        """UNION chain of select cores, then ORDER BY / LIMIT binding to
        the whole result (standard SQL; left-associative UNIONs)."""
        plan, out_scope = self.select_core()
        while self.kw("union"):
            all_ = bool(self.kw("all"))
            right, _ = self.select_core()
            if len(right.schema.names) != len(plan.schema.names):
                raise SqlParseError(
                    "UNION requires the same number of columns")
            if right.schema.names != plan.schema.names:
                # Spark takes the left side's column names
                right = lp.Project(right, [
                    ir.Alias(ir.UnresolvedAttribute(rn), ln)
                    for rn, ln in zip(right.schema.names,
                                      plan.schema.names)])
            plan = lp.Union([plan, right])
            if not all_:
                plan = lp.Aggregate(
                    plan, [ir.UnresolvedAttribute(n)
                           for n in plan.schema.names], [])

        if self.kw("order", "by"):
            orders = []
            while True:
                orders.append(self.order_item(out_scope, plan))
                if not self.accept("op", ","):
                    break
            # Spark resolves sort refs against the SELECT output first,
            # then against the projection's INPUT, carrying missing
            # input columns through as hidden sort columns and dropping
            # them after the sort (ResolveSortReferences)
            missing = []
            for o in orders:
                for a in ir.collect(
                        o.expr,
                        lambda n: isinstance(n, ir.UnresolvedAttribute)):
                    if a.attr_name not in plan.schema.names and \
                            a.attr_name not in missing:
                        missing.append(a.attr_name)
            visible = list(plan.schema.names)
            if missing and isinstance(plan, lp.Project) and \
                    len(set(visible)) == len(visible) and all(
                    m in plan.children[0].schema.names for m in missing):
                inner = plan.children[0]
                aug = lp.Project(
                    inner,
                    [ir.Alias(e, n) for e, n in
                     zip(plan.exprs, visible)] +
                    [ir.UnresolvedAttribute(m) for m in missing])
                srt = lp.Sort(aug, orders)
                plan = lp.Project(
                    srt, [ir.UnresolvedAttribute(n) for n in visible])
            else:
                plan = lp.Sort(plan, orders)

        if self.kw("limit"):
            n = self.expect("num").value
            plan = lp.Limit(plan, int(n))
        return plan

    def select_core(self) -> Tuple[lp.LogicalPlan, "_Scope"]:
        self.expect("kw", "select")
        distinct = bool(self.kw("distinct"))
        proj = self.select_list()

        plan: Optional[lp.LogicalPlan] = None
        scope = _Scope([])
        if self.kw("from"):
            plan, scope = self.from_clause()
        else:
            # FROM-less SELECT of literals: single-row relation
            import pyarrow as pa
            plan = lp.InMemoryScan(pa.table({"__one": [1]}))
            scope = _Scope([])

        if self.kw("where"):
            cond = self.expr(scope)
            plan = lp.Filter(plan, cond)

        group_exprs: List[ir.Expression] = []
        has_group = False
        rollup_kind = None
        if self.kw("group", "by"):
            has_group = True
            t = self.peek()
            if t.kind in ("name", "kw") and \
                    t.value.lower() in ("rollup", "cube") and \
                    self.peek(1).kind == "op" and \
                    self.peek(1).value == "(":
                rollup_kind = t.value.lower()
                self.next()
                self.expect("op", "(")
                while True:
                    group_exprs.append(self.expr(scope))
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
            else:
                while True:
                    group_exprs.append(self.expr(scope))
                    if not self.accept("op", ","):
                        break

        having = None
        if self.kw("having"):
            having = self.expr(scope)

        # aggregate vs plain projection
        proj_exprs = self.resolve_projection(proj, scope)
        # GROUP BY a select alias (GROUP BY y for year(d) AS y) resolves
        # to the aliased expression, as Spark's analyzer does
        alias_map = {e.alias: e.children[0] for e in proj_exprs
                     if isinstance(e, ir.Alias)}
        group_exprs = [
            alias_map[g.attr_name]
            if (isinstance(g, ir.UnresolvedAttribute)
                and g.attr_name not in scope.names
                and g.attr_name in alias_map) else g
            for g in group_exprs]
        is_agg = has_group or having is not None or any(
            ir.collect(e, lambda n: isinstance(n, ir.AggregateExpression))
            for e in proj_exprs)

        if rollup_kind is not None:
            # GROUP BY ROLLUP/CUBE (...): lower through the shared
            # Expand grouping-sets helper; key references anywhere in
            # the projection/HAVING resolve to the NULLED grouping-set
            # key columns, not the pass-through inputs
            import itertools
            k = len(group_exprs)
            if rollup_kind == "rollup":
                sets = [tuple(range(i)) for i in range(k, -1, -1)]
            else:
                sets = [s for n in range(k, -1, -1)
                        for s in itertools.combinations(range(k), n)]
            plan, refs, _renames = lp.expand_grouping_sets(
                plan, group_exprs, sets)
            keys = list(group_exprs)

            def _key_repl(node):
                for i, g in enumerate(keys):
                    if ir.expr_eq(node, g):
                        return ir.UnresolvedAttribute(f"__gset{i}")
                return None

            def _fix(e):
                if isinstance(e, ir.Alias):
                    return ir.Alias(
                        ir.transform(e.children[0], _key_repl), e.alias)
                return ir.Alias(ir.transform(e, _key_repl),
                                ir.output_name(e))

            proj_exprs = [_fix(e) for e in proj_exprs]
            if having is not None:
                having = ir.transform(having, _key_repl)
            group_exprs = refs
            scope = _Scope(plan.schema.names)

        plan, out_scope = self.lower_select(
            plan, scope, proj_exprs, group_exprs, having, is_agg)
        # qualified refs (p.name) in ORDER BY still resolve via the FROM
        # aliases, provided the column survived into the output
        out_scope.by_alias = {
            a: [n for n in ns if n in out_scope.names]
            for a, ns in scope.by_alias.items()}

        if distinct:
            plan = lp.Aggregate(
                plan, [ir.UnresolvedAttribute(n)
                       for n in plan.schema.names], [])
        return plan, out_scope

    def select_list(self):
        """Parse the projection as raw items; resolution happens once the
        FROM scope is known.  Items: '*', ('qualified_star', alias),
        ('expr', tokens-slice bounds, alias)."""
        items = []
        while True:
            if self.accept("op", "*"):
                items.append("*")
            elif (self.peek().kind == "name"
                  and self.peek(1).kind == "op"
                  and self.peek(1).value == "."
                  and self.peek(2).kind == "op"
                  and self.peek(2).value == "*"):
                alias = self.next().value
                self.next()
                self.next()
                items.append(("qstar", alias))
            else:
                start = self.i
                self.skip_expr()
                end = self.i
                alias = None
                if self.kw("as"):
                    alias = self.expect_name_or_kw()
                items.append(("expr", start, end, alias))
            if not self.accept("op", ","):
                break
        return items

    def expect_name_or_kw(self) -> str:
        t = self.peek()
        if t.kind in ("name", "kw"):
            self.next()
            return t.value
        raise SqlParseError(f"expected identifier, got {t.value!r}")

    def skip_expr(self) -> None:
        """Skip one expression at the token level (used to defer select-
        list parsing until the FROM scope exists): consume until a
        top-level ',' / FROM / EOF, tracking parens."""
        depth = 0
        while True:
            t = self.peek()
            if t.kind == "eof":
                return
            if t.kind == "op":
                if t.value == "(":
                    depth += 1
                elif t.value == ")":
                    if depth == 0:
                        return
                    depth -= 1
                elif t.value == "," and depth == 0:
                    return
            if depth == 0 and t.kind == "kw" and t.value in (
                    "from", "where", "group", "having", "order", "limit",
                    "union", "as"):
                return
            # a bare alias (name following a complete expression) also
            # terminates, but distinguishing it requires real parsing;
            # select_list re-parses the slice, so just stop on names that
            # directly follow a complete atom: handled by re-parse length
            self.next()

    def resolve_projection(self, items, scope: _Scope
                           ) -> List[ir.Expression]:
        out: List[ir.Expression] = []
        for it in items:
            if it == "*":
                out.extend(ir.UnresolvedAttribute(n) for n in scope.names)
            elif isinstance(it, tuple) and it[0] == "qstar":
                alias = it[1].lower()
                if alias not in scope.by_alias:
                    raise SqlParseError(f"unknown table alias '{it[1]}'")
                out.extend(ir.UnresolvedAttribute(n)
                           for n in scope.by_alias[alias])
            else:
                _, start, end, alias = it
                save = self.i
                self.i = start
                e = self.expr(scope)
                # tolerate a trailing bare alias inside the slice
                if self.i < end and self.peek().kind == "name":
                    alias = alias or self.next().value
                if self.i != end:
                    bad = self.peek()
                    raise SqlParseError(
                        f"could not parse select item near "
                        f"{bad.value!r} at position {bad.pos}")
                self.i = save
                out.append(ir.Alias(e, alias) if alias else e)
        return out

    def lower_select(self, plan, scope, proj_exprs, group_exprs, having,
                     is_agg) -> Tuple[lp.LogicalPlan, _Scope]:
        if not is_agg:
            plan = lp.Project(plan, proj_exprs)
            return plan, _Scope(plan.schema.names)

        # DISTINCT aggregates: shared double-aggregate rewrite before
        # the leaf split (lp.rewrite_distinct_aggregates); pre-alias so
        # output names survive the strip
        proj_exprs = [e if isinstance(e, ir.Alias)
                      else ir.Alias(e, ir.output_name(e))
                      for e in proj_exprs]
        rw_exprs = list(proj_exprs) + ([having] if having is not None
                                       else [])
        plan2, groupings2, exprs2 = lp.rewrite_distinct_aggregates(
            plan, group_exprs, rw_exprs)
        if plan2 is not plan:
            plan = plan2
            group_exprs = groupings2
            if having is not None:
                having = exprs2[-1]
                proj_exprs = exprs2[:-1]
            else:
                proj_exprs = exprs2

        # aggregate: groupings = GROUP BY exprs; select items that are
        # bare group refs pass through, others must be aggregates (the
        # compound/post-projection split mirrors GroupedData.agg)
        leaves: List[ir.Expression] = []

        def repl(node):
            if isinstance(node, ir.AggregateExpression):
                name = f"__agg{len(leaves)}"
                leaves.append(ir.Alias(node, name))
                return ir.UnresolvedAttribute(name)
            return None

        group_names = []
        group_keys = []
        for g in group_exprs:
            name = ir.output_name(g)
            group_names.append(name)
            group_keys.append(g)

        projected = []
        for e in proj_exprs:
            name = ir.output_name(e)
            inner = e.children[0] if isinstance(e, ir.Alias) else e
            if any(_expr_eq(inner, g) for g in group_keys):
                projected.append(ir.Alias(_group_ref(inner, group_keys,
                                                     group_names), name))
                continue
            projected.append(ir.Alias(ir.transform(inner, repl), name))

        having_expr = None
        if having is not None:
            having_expr = ir.transform(having, repl)

        agg_plan = lp.Aggregate(plan, group_keys, leaves)
        if having_expr is not None:
            agg_plan = lp.Filter(agg_plan, having_expr)
        final = lp.Project(agg_plan, projected)
        return final, _Scope(final.schema.names)

    def order_item(self, scope: _Scope, plan) -> SortOrder:
        # positional ORDER BY n
        if self.peek().kind == "num":
            t = self.next()
            idx = int(t.value) - 1
            if not (0 <= idx < len(plan.schema.names)):
                raise SqlParseError(f"ORDER BY position {t.value} out of "
                                    f"range")
            e: ir.Expression = ir.UnresolvedAttribute(
                plan.schema.names[idx])
        else:
            e = self.expr(_Scope(plan.schema.names, scope.by_alias))
        asc = True
        if self.kw("desc"):
            asc = False
        else:
            self.kw("asc")
        nulls: Optional[bool] = None   # SortOrder.nulls_first is a BOOL
        if self.kw("nulls", "first"):
            nulls = True
        elif self.kw("nulls", "last"):
            nulls = False
        return SortOrder(e, asc, nulls)

    # -- FROM -------------------------------------------------------------
    def from_clause(self) -> Tuple[lp.LogicalPlan, _Scope]:
        plan, scope = self.relation()
        while True:
            if self.accept("op", ","):
                right, rscope = self.relation()
                plan, scope = self.join_plans(plan, scope, right, rscope,
                                              "cross", None, None)
                continue
            how = None
            if self.kw("cross", "join"):
                how = "cross"
            elif self.kw("inner", "join"):
                how = "inner"
            elif self.kw("left", "semi", "join"):
                how = "semi"
            elif self.kw("left", "anti", "join"):
                how = "anti"
            elif self.kw("left", "outer", "join") or self.kw(
                    "left", "join"):
                how = "left"
            elif self.kw("right", "outer", "join") or self.kw(
                    "right", "join"):
                how = "right"
            elif self.kw("full", "outer", "join") or self.kw(
                    "full", "join"):
                how = "full"
            elif self.kw("join"):
                how = "inner"
            if how is None:
                return plan, scope
            right, rscope = self.relation()
            on = None
            using = None
            if self.kw("on"):
                joint = _Scope(scope.names + rscope.names,
                               {**scope.by_alias, **rscope.by_alias})
                on = self.expr(joint)
            elif self.kw("using"):
                self.expect("op", "(")
                using = [self.expect("name").value]
                while self.accept("op", ","):
                    using.append(self.expect("name").value)
                self.expect("op", ")")
            plan, scope = self.join_plans(plan, scope, right, rscope,
                                          how, on, using)

    def relation(self) -> Tuple[lp.LogicalPlan, _Scope]:
        if self.accept("op", "("):
            sub = self.query()
            self.expect("op", ")")
            alias = None
            if self.kw("as"):
                alias = self.expect("name").value
            elif self.peek().kind == "name":
                alias = self.next().value
            scope = _Scope(sub.schema.names)
            if alias:
                scope.by_alias[alias.lower()] = list(sub.schema.names)
            return sub, scope
        name = self.expect("name").value
        plan = self.lookup(name)
        alias = name
        if self.kw("as"):
            alias = self.expect("name").value
        elif self.peek().kind == "name":
            alias = self.next().value
        scope = _Scope(plan.schema.names,
                       {alias.lower(): list(plan.schema.names)})
        return plan, scope

    def lookup(self, name: str) -> lp.LogicalPlan:
        key = name.lower()
        if key in self.ctes:
            return self.ctes[key]
        plan = self.catalog.get(key)
        if plan is None:
            raise SqlParseError(f"table or view not found: {name}")
        return plan

    def join_plans(self, left, lscope: _Scope, right, rscope: _Scope,
                   how, on, using) -> Tuple[lp.LogicalPlan, _Scope]:
        dup = set(left.schema.names) & set(right.schema.names)
        if using:
            left_keys = right_keys = list(using)
            condition = None
        elif on is not None:
            left_keys, right_keys, condition = lp.split_join_condition(
                on, left.schema.names, right.schema.names)
        elif how == "cross":
            left_keys, right_keys, condition = [], [], None
        else:
            raise SqlParseError("JOIN requires ON or USING")
        overlap = dup - set(u for u in (using or []))
        if overlap and how != "semi" and how != "anti":
            raise SqlParseError(
                f"duplicate column names across join inputs: "
                f"{sorted(overlap)}; alias them apart (the engine keeps "
                f"flat output schemas)")
        if using:
            # drop the right copy of USING columns, Spark-style
            proj = [ir.UnresolvedAttribute(n) for n in left.schema.names]
            proj += [ir.UnresolvedAttribute(n)
                     for n in right.schema.names if n not in using]
            if how in ("semi", "anti"):
                out = lp.Join(left, right, left_keys, right_keys, how,
                              condition=condition)
            else:
                # rename right key columns before join to avoid dup names
                rename = {n: f"__r_{n}" for n in using}
                rproj = [ir.Alias(ir.UnresolvedAttribute(n), rename[n])
                         if n in rename else ir.UnresolvedAttribute(n)
                         for n in right.schema.names]
                right2 = lp.Project(right, rproj)
                joined = lp.Join(left, right2, left_keys,
                                 [rename[k] for k in right_keys], how,
                                 condition=condition)
                out = lp.Project(joined, proj)
            scope = _Scope(out.schema.names,
                           {**lscope.by_alias, **rscope.by_alias})
            return out, scope
        joined = lp.Join(left, right, left_keys, right_keys, how,
                         condition=condition)
        scope = _Scope(joined.schema.names,
                       {**lscope.by_alias, **rscope.by_alias})
        return joined, scope

    # -- expressions ------------------------------------------------------
    def expr(self, scope: _Scope) -> ir.Expression:
        return self.or_expr(scope)

    def or_expr(self, scope) -> ir.Expression:
        e = self.and_expr(scope)
        while self.kw("or"):
            e = ir.Or(e, self.and_expr(scope))
        return e

    def and_expr(self, scope) -> ir.Expression:
        e = self.not_expr(scope)
        while self.kw("and"):
            e = ir.And(e, self.not_expr(scope))
        return e

    def not_expr(self, scope) -> ir.Expression:
        if self.kw("not"):
            return ir.Not(self.not_expr(scope))
        return self.comparison(scope)

    def comparison(self, scope) -> ir.Expression:
        e = self.additive(scope)
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=",
                                              ">", ">="):
                self.next()
                rhs = self.additive(scope)
                cls = {"=": ir.EqualTo, "<": ir.LessThan,
                       "<=": ir.LessThanOrEqual, ">": ir.GreaterThan,
                       ">=": ir.GreaterThanOrEqual}.get(t.value)
                if cls:
                    e = cls(e, rhs)
                else:
                    e = ir.Not(ir.EqualTo(e, rhs))
                continue
            negate = False
            save = self.i
            if self.kw("not"):
                negate = True
            if self.kw("between"):
                lo = self.additive(scope)
                self.expect("kw", "and")
                hi = self.additive(scope)
                base = ir.And(ir.GreaterThanOrEqual(e, lo),
                              ir.LessThanOrEqual(e, hi))
                e = ir.Not(base) if negate else base
                continue
            if self.kw("in"):
                self.expect("op", "(")
                vals = [self.expr(scope)]
                while self.accept("op", ","):
                    vals.append(self.expr(scope))
                self.expect("op", ")")
                lits = []
                for v in vals:
                    if not isinstance(v, ir.Literal):
                        raise SqlParseError(
                            "IN list must be literals")
                    lits.append(v.value)
                base = ir.In(e, lits)
                e = ir.Not(base) if negate else base
                continue
            if self.kw("like"):
                pat = self.expect("str").value
                base = ir.Like(e, ir.Literal(pat))
                e = ir.Not(base) if negate else base
                continue
            if self.kw("rlike") or self.kw("regexp"):
                pat = self.expect("str").value
                base = ir.RLike(e, ir.Literal(pat))
                e = ir.Not(base) if negate else base
                continue
            if negate:
                self.i = save
            if self.kw("is"):
                if self.kw("not"):
                    self.expect("kw", "null")
                    e = ir.IsNotNull(e)
                else:
                    self.expect("kw", "null")
                    e = ir.IsNull(e)
                continue
            return e

    def additive(self, scope) -> ir.Expression:
        e = self.multiplicative(scope)
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                rhs = self.multiplicative(scope)
                e = (ir.Add if t.value == "+" else ir.Subtract)(e, rhs)
            elif t.kind == "op" and t.value == "||":
                self.next()
                rhs = self.multiplicative(scope)
                e = ir.Concat(e, rhs)
            else:
                return e

    def multiplicative(self, scope) -> ir.Expression:
        e = self.unary(scope)
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                rhs = self.unary(scope)
                cls = {"*": ir.Multiply, "/": ir.Divide,
                       "%": ir.Remainder}[t.value]
                e = cls(e, rhs)
            else:
                return e

    def unary(self, scope) -> ir.Expression:
        if self.accept("op", "-"):
            return ir.UnaryMinus(self.unary(scope))
        if self.accept("op", "+"):
            return self.unary(scope)
        return self.atom(scope)

    def atom(self, scope) -> ir.Expression:
        t = self.peek()
        if t.kind == "param":
            self.next()
            pname = t.value[1:]
            dtype = self.param_types.get(pname)
            if dtype is None:
                raise SqlParseError(
                    f"undeclared parameter :{pname} at position {t.pos}; "
                    f"declare its type when preparing the statement")
            lit = ir.Literal(SqlParam(pname), dtype)
            # a parameter may be bound to NULL; plan it nullable so the
            # template's null-handling doesn't depend on the binding
            lit.nullable = True
            self.params_seen[pname] = dtype
            return lit
        if t.kind == "num":
            self.next()
            if re.fullmatch(r"\d+", t.value):
                return ir.Literal(int(t.value))
            return ir.Literal(float(t.value))
        if t.kind == "str":
            self.next()
            return ir.Literal(t.value)
        if self.kw("true"):
            return ir.Literal(True)
        if self.kw("false"):
            return ir.Literal(False)
        if self.kw("null"):
            return ir.Literal(None)
        if t.kind == "kw" and t.value == "date" \
                and self.peek(1).kind == "str":
            self.next()
            s = self.next().value
            return ir.Literal(_dt.date.fromisoformat(s))
        if t.kind == "kw" and t.value == "timestamp" \
                and self.peek(1).kind == "str":
            self.next()
            s = self.next().value
            v = _dt.datetime.fromisoformat(s)
            if v.tzinfo is None:
                v = v.replace(tzinfo=_dt.timezone.utc)
            return ir.Literal(v)
        if self.kw("cast"):
            self.expect("op", "(")
            e = self.expr(scope)
            self.expect("kw", "as")
            ty = self.expect_name_or_kw().lower()
            self.expect("op", ")")
            if ty not in _TYPE_NAMES:
                raise SqlParseError(f"unknown type in CAST: {ty}")
            from spark_rapids_tpu_torch.api.column import _TYPE_NAMES as TN
            return ir.Cast(e, TN[_TYPE_NAMES[ty]])
        if self.kw("case"):
            return self.case_expr(scope)
        if self.accept("op", "("):
            e = self.expr(scope)
            self.expect("op", ")")
            return e
        if t.kind in ("name", "kw"):
            # function call?
            nxt = self.peek(1)
            if nxt.kind == "op" and nxt.value == "(":
                return self.func_call(scope)
            if t.kind == "name":
                return self.column_ref(scope)
        raise SqlParseError(f"unexpected token {t.value!r} at position "
                            f"{t.pos}")

    def case_expr(self, scope) -> ir.Expression:
        # CASE [operand] WHEN v THEN r ... [ELSE d] END
        operand = None
        if not (self.peek().kind == "kw" and self.peek().value == "when"):
            operand = self.expr(scope)
        branches = []
        while self.kw("when"):
            cond = self.expr(scope)
            if operand is not None:
                cond = ir.EqualTo(operand, cond)
            self.expect("kw", "then")
            val = self.expr(scope)
            branches.append((cond, val))
        default = None
        if self.kw("else"):
            default = self.expr(scope)
        self.expect("kw", "end")
        return ir.CaseWhen(branches, default)

    def func_call(self, scope) -> ir.Expression:
        name = self.expect_name_or_kw().lower()
        self.expect("op", "(")
        # count(*) / aggregate(DISTINCT x)
        if name == "count":
            if self.accept("op", "*"):
                self.expect("op", ")")
                return ir.Count(None)
            distinct = bool(self.kw("distinct"))
            arg = self.expr(scope)
            self.expect("op", ")")
            return ir.Count(arg, distinct=distinct)
        if name in ("sum", "avg", "mean") and self.kw("distinct"):
            arg = self.expr(scope)
            self.expect("op", ")")
            cls = ir.Sum if name == "sum" else ir.Average
            return cls(arg, distinct=True)
        args: List[ir.Expression] = []
        if not (self.peek().kind == "op" and self.peek().value == ")"):
            args.append(self.expr(scope))
            while self.accept("op", ","):
                args.append(self.expr(scope))
        self.expect("op", ")")
        fn = _FUNCTIONS.get(name)
        if fn is None:
            raise SqlParseError(f"unknown function: {name}")
        return fn(args)

    def column_ref(self, scope: _Scope) -> ir.Expression:
        name = self.expect("name").value
        if self.peek().kind == "op" and self.peek().value == "." \
                and self.peek(1).kind == "name":
            self.next()
            colname = self.expect("name").value
            alias = name.lower()
            if alias not in scope.by_alias:
                raise SqlParseError(f"unknown table alias '{name}'")
            if colname not in scope.by_alias[alias]:
                raise SqlParseError(
                    f"column '{colname}' not found in '{name}'")
            return ir.UnresolvedAttribute(colname)
        return ir.UnresolvedAttribute(name)


_expr_eq = ir.expr_eq


def _group_ref(e: ir.Expression, group_keys, group_names
               ) -> ir.Expression:
    for g, n in zip(group_keys, group_names):
        if _expr_eq(e, g):
            return ir.UnresolvedAttribute(n)
    return e


def parse_sql(text: str, catalog, param_types=None) -> lp.LogicalPlan:
    """Parse one SQL query against ``catalog`` (name→LogicalPlan).

    ``param_types`` (name → DType) declares ``:name`` prepared-statement
    parameters; without it a ``:name`` token is a parse error."""
    return Parser(text, catalog, param_types=param_types).parse()


def parse_prepared(text: str, catalog, param_types) -> Tuple[
        lp.LogicalPlan, Dict[str, object]]:
    """Parse a parameterized statement once; returns the plan template
    (with SqlParam-valued Literals in place) and the parameters it
    actually references (name → DType) — the serve layer's
    prepared-statement entry point."""
    p = Parser(text, catalog, param_types=param_types)
    plan = p.parse()
    return plan, dict(p.params_seen)
