"""TpchLike for the port: the TPC-H schema, a dbgen-lite generator, the
22 DataFrame queries and the SQL texts of eight of them.

Ported from ``spark_rapids_tpu/bench/tpch.py`` with the port's ``col``,
``lit`` and ``functions``.  Reference analog:
``integration_tests/.../tests/tpch/TpchLikeSpark.scala`` -- "Like"
because the data is not audited dbgen output and the results are not
comparable to official TPC-H numbers; the queries exercise the same
operator mix (multi-way hash joins, aggregates, semi/anti joins, scalar
subqueries, like-filters, top-k sorts).  Prices are float64 (no decimal)
and text columns are seeded-random words, with the substrings the
queries grep for injected at spec-plausible rates.

:func:`generate` draws from its ``numpy`` generator in the reference's
order, so ``generate(sf, seed)`` equals the reference's tables; the
string columns are built by numpy and Arrow (``take`` of the word lists,
``binary_join_element_wise``, vectorized injections) instead of per-row
Python, and a string column whose bytes would pass Arrow's 2 GiB offset
range is built in chunks.  That makes SF10 (lineitem ~60 million rows)
in about a minute.
"""

from __future__ import annotations

import datetime as dt
from typing import Dict, List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch.api.column import col, lit
from spark_rapids_tpu_torch.api import functions as F

# ---------------------------------------------------------------------------
# Schema (TPC-H spec §1.4; names kept verbatim so queries read like the spec)
# ---------------------------------------------------------------------------

TPCH_TABLES = ["region", "nation", "supplier", "part", "partsupp",
               "customer", "orders", "lineitem"]

_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# nation -> (nationkey, regionkey) per spec
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
             "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
               "5-LOW"]
_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
              "TAKE BACK RETURN"]
_CONTAINERS = [f"{a} {b}" for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
               for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                         "CAN", "DRUM"]]
_TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_TYPES = [f"{a} {b} {c}" for a in _TYPE_S1 for b in _TYPE_S2
          for c in _TYPE_S3]
_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blanched", "blue", "blush", "brown", "burlywood",
           "burnished", "chartreuse", "chiffon", "chocolate", "coral",
           "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
           "dim", "dodger", "drab", "firebrick", "floral", "forest",
           "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
           "honeydew", "hot", "hunter", "indian", "ivory", "khaki",
           "lace", "lavender", "lawn", "lemon", "light", "lime", "linen"]
_WORDS = ["packages", "deposits", "accounts", "foxes", "ideas", "theodolites",
          "dependencies", "instructions", "excuses", "platelets",
          "requests", "asymptotes", "courts", "dolphins", "multipliers",
          "sauternes", "warthogs", "frets", "dinos", "attainments"]

_EPOCH = dt.date(1970, 1, 1)
_STARTDATE = dt.date(1992, 1, 1)
_CURRENTDATE = dt.date(1995, 6, 17)
_ENDDATE = dt.date(1998, 12, 31)


def _days(d: dt.date) -> int:
    return (d - _EPOCH).days


def _date_arr(days: np.ndarray) -> pa.Array:
    return pa.array(days.astype(np.int32), type=pa.date32())


def _money(rng, lo: float, hi: float, n: int) -> np.ndarray:
    return np.round(rng.uniform(lo, hi, n), 2)


def _text(rng, n: int, inject: str = "", rate: float = 0.0
          ) -> pa.ChunkedArray:
    """Four random words per row; with ``inject``, a ``rate`` share of
    the rows get it spliced in after their 10th character.  Draws as the
    reference's ``_text``: the (n, 4) word choice, then the hit mask."""
    idx = rng.choice(len(_WORDS), size=(n, 4))
    hits = rng.random(n) < rate if inject and rate > 0 else None
    words = pa.array(_WORDS)
    chunks = []
    for lo in range(0, max(n, 1), _CHUNK_ROWS):
        hi = min(n, lo + _CHUNK_ROWS)
        part = pc.binary_join_element_wise(
            *[words.take(idx[lo:hi, k]) for k in range(4)], " ")
        if hits is not None:
            at = np.flatnonzero(hits[lo:hi])
            if at.size:
                sub = part.take(at)
                spliced = pc.binary_join_element_wise(
                    pc.utf8_slice_codeunits(sub, 0, 10), inject,
                    pc.utf8_slice_codeunits(sub, 10), "")
                mask = np.zeros(hi - lo, dtype=bool)
                mask[at] = True
                part = pc.replace_with_mask(part, pa.array(mask), spliced)
        chunks.append(part)
    return pa.chunked_array(chunks, type=pa.string())


def _pick(values: List[str], idx: np.ndarray) -> pa.ChunkedArray:
    """``values[idx]`` as a string column, built in chunks."""
    arr = pa.array(values, type=pa.string())
    return pa.chunked_array(
        [arr.take(idx[lo:lo + _CHUNK_ROWS])
         for lo in range(0, max(len(idx), 1), _CHUNK_ROWS)],
        type=pa.string())


def _ints(a: np.ndarray) -> pa.Array:
    return pc.cast(pa.array(a), pa.string())


def _numbered(prefix: str, nums: np.ndarray) -> pa.Array:
    """``f"{prefix}{i:09d}"`` for each i."""
    return pc.binary_join_element_wise(
        prefix, pc.utf8_lpad(_ints(nums), 9, "0"), "")


def _phone(keys: np.ndarray, rng) -> pa.Array:
    a = rng.integers(100, 999, keys.shape[0])
    b = rng.integers(100, 999, keys.shape[0])
    c = rng.integers(1000, 9999, keys.shape[0])
    return pc.binary_join_element_wise(
        _ints(10 + keys.astype(np.int64)), _ints(a), _ints(b), _ints(c),
        "-")


# rows per string chunk: 4 words of at most 12 bytes stay far inside a
# chunk's 2 GiB offsets
_CHUNK_ROWS = 1 << 22

def scale_counts(sf: float) -> Dict[str, int]:
    return {
        "supplier": max(10, int(10_000 * sf)),
        "part": max(40, int(200_000 * sf)),
        "customer": max(60, int(150_000 * sf)),
        "orders": max(150, int(1_500_000 * sf)),
    }


_FAVORED_NATIONS = [2, 3, 6, 7, 20]  # BRAZIL CANADA FRANCE GERMANY SAUDI
_NATION_P = np.full(25, 0.6 / 20)
_NATION_P[_FAVORED_NATIONS] = 0.08


_FAVORED_NATIONS = [2, 3, 6, 7, 20]  # BRAZIL CANADA FRANCE GERMANY SAUDI
_NATION_P = np.full(25, 0.6 / 20)
_NATION_P[_FAVORED_NATIONS] = 0.08


def generate(sf: float = 0.001, seed: int = 0) -> Dict[str, pa.Table]:
    """dbgen-lite: the 8 tables at scale factor ``sf`` as Arrow tables.

    The query-parameter nations are oversampled (so q5/q7/q8/q11/q20/q21
    select non-empty results even at tiny scale factors) and ~2% of orders
    are bulk orders whose line quantities clear q18's sum(qty) > 300."""
    rng = np.random.default_rng(seed)
    counts = scale_counts(sf)
    tables: Dict[str, pa.Table] = {}

    tables["region"] = pa.table({
        "r_regionkey": pa.array(range(5), type=pa.int32()),
        "r_name": _REGIONS,
        "r_comment": _text(rng, 5),
    })

    nk = np.arange(25, dtype=np.int32)
    tables["nation"] = pa.table({
        "n_nationkey": pa.array(nk),
        "n_name": [n for n, _ in _NATIONS],
        "n_regionkey": pa.array([r for _, r in _NATIONS],
                                type=pa.int32()),
        "n_comment": _text(rng, 25),
    })

    ns = counts["supplier"]
    s_nation = rng.choice(25, ns, p=_NATION_P).astype(np.int32)
    tables["supplier"] = pa.table({
        "s_suppkey": pa.array(np.arange(1, ns + 1, dtype=np.int64)),
        "s_name": _numbered("Supplier#", np.arange(1, ns + 1)),
        "s_address": _text(rng, ns),
        "s_nationkey": pa.array(s_nation),
        "s_phone": _phone(s_nation, rng),
        "s_acctbal": _money(rng, -999.99, 9999.99, ns),
        # q16 greps 'Customer%Complaints'; spec rate is 5 per 10k
        "s_comment": _text(rng, ns, "Customer Complaints", 0.02),
    })

    npart = counts["part"]
    color1 = rng.choice(len(_COLORS), npart)
    color2 = rng.choice(len(_COLORS), npart)
    brand_m = rng.integers(1, 6, npart)
    brand_n = rng.integers(1, 6, npart)
    tables["part"] = pa.table({
        "p_partkey": pa.array(np.arange(1, npart + 1, dtype=np.int64)),
        "p_name": pc.binary_join_element_wise(
            _pick(_COLORS, color1), _pick(_COLORS, color2), " "),
        "p_mfgr": pc.binary_join_element_wise(
            "Manufacturer#", _ints(brand_m), ""),
        "p_brand": pc.binary_join_element_wise(
            "Brand#", _ints(brand_m), _ints(brand_n), ""),
        "p_type": _pick(_TYPES, rng.choice(len(_TYPES), npart)),
        "p_size": pa.array(rng.integers(1, 51, npart).astype(np.int32)),
        "p_container": _pick(_CONTAINERS,
                             rng.choice(len(_CONTAINERS), npart)),
        "p_retailprice": np.round(
            900.0 + (np.arange(1, npart + 1) % 1000) / 10.0
            + 100.0 * (np.arange(1, npart + 1) % 10), 2),
        "p_comment": _text(rng, npart),
    })

    # partsupp: each part stocked by 4 suppliers (spec formula)
    pk = np.repeat(np.arange(1, npart + 1, dtype=np.int64), 4)
    j = np.tile(np.arange(4, dtype=np.int64), npart)
    sk = 1 + (pk - 1 + j * (ns // 4 + 1)) % ns
    nps = pk.shape[0]
    tables["partsupp"] = pa.table({
        "ps_partkey": pa.array(pk),
        "ps_suppkey": pa.array(sk),
        "ps_availqty": pa.array(
            rng.integers(1, 10_000, nps).astype(np.int32)),
        "ps_supplycost": _money(rng, 1.0, 1000.0, nps),
        "ps_comment": _text(rng, nps),
    })

    nc = counts["customer"]
    c_nation = rng.choice(25, nc, p=_NATION_P).astype(np.int32)
    tables["customer"] = pa.table({
        "c_custkey": pa.array(np.arange(1, nc + 1, dtype=np.int64)),
        "c_name": _numbered("Customer#", np.arange(1, nc + 1)),
        "c_address": _text(rng, nc),
        "c_nationkey": pa.array(c_nation),
        "c_phone": _phone(c_nation, rng),
        "c_acctbal": _money(rng, -999.99, 9999.99, nc),
        "c_mktsegment": _pick(_SEGMENTS, rng.choice(len(_SEGMENTS), nc)),
        "c_comment": _text(rng, nc),
    })

    no = counts["orders"]
    o_key = np.arange(1, no + 1, dtype=np.int64)
    # spec: only 2/3 of customers have orders
    o_cust = rng.integers(1, max(2, (nc * 2) // 3) + 1, no).astype(np.int64)
    o_days = rng.integers(_days(_STARTDATE),
                          _days(_ENDDATE) - 151, no)
    nlines = rng.integers(1, 8, no)
    is_bulk = rng.random(no) < 0.02
    nlines[is_bulk] = 7

    # lineitem built alongside orders so dates/keys are consistent
    l_order = np.repeat(o_key, nlines)
    l_odate = np.repeat(o_days, nlines)
    nl = l_order.shape[0]
    l_part = rng.integers(1, npart + 1, nl).astype(np.int64)
    l_j = rng.integers(0, 4, nl)
    l_supp = 1 + (l_part - 1 + l_j * (ns // 4 + 1)) % ns
    bulk = np.repeat(is_bulk, nlines)
    l_qty = np.where(bulk, rng.integers(45, 51, nl),
                     rng.integers(1, 51, nl)).astype(np.int32)
    retail = 900.0 + (l_part % 1000) / 10.0 + 100.0 * (l_part % 10)
    l_price = np.round(l_qty * retail / 10.0, 2)
    l_disc = np.round(rng.integers(0, 11, nl) / 100.0, 2)
    l_tax = np.round(rng.integers(0, 9, nl) / 100.0, 2)
    l_ship = l_odate + rng.integers(1, 122, nl)
    l_commit = l_odate + rng.integers(30, 91, nl)
    l_receipt = l_ship + rng.integers(1, 31, nl)
    shipped = l_receipt <= _days(_CURRENTDATE)
    # codes into ["R", "A", "N"] and ["F", "O"]
    l_rflag = np.where(shipped, np.where(rng.random(nl) < 0.5, 0, 1), 2)
    l_status = (l_ship > _days(_CURRENTDATE)).astype(np.int64)

    # order status from its lines (spec: F all-F, O all-O, else P)
    ends = np.cumsum(nlines)
    starts = ends - nlines
    n_open = np.add.reduceat(l_status, starts)
    o_status = np.where(n_open == 0, 0, np.where(n_open == nlines, 1, 2))
    tot = np.round(l_price * (1.0 + l_tax) * (1.0 - l_disc), 2)
    o_total = np.round(np.add.reduceat(tot, starts), 2)

    tables["orders"] = pa.table({
        "o_orderkey": pa.array(o_key),
        "o_custkey": pa.array(o_cust),
        "o_orderstatus": _pick(["F", "O", "P"], o_status),
        "o_totalprice": o_total,
        "o_orderdate": _date_arr(o_days),
        "o_orderpriority": _pick(_PRIORITIES,
                                 rng.choice(len(_PRIORITIES), no)),
        "o_clerk": _numbered(
            "Clerk#", rng.integers(1, max(2, int(1000 * sf)) + 1, no)),
        "o_shippriority": pa.array(np.zeros(no, dtype=np.int32)),
        # q13 greps o_comment NOT LIKE '%special%requests%'
        "o_comment": _text(rng, no, "special packages requests", 0.1),
    })

    tables["lineitem"] = pa.table({
        "l_orderkey": pa.array(l_order),
        "l_partkey": pa.array(l_part),
        "l_suppkey": pa.array(l_supp),
        "l_linenumber": pa.array(
            (np.arange(nl) - np.repeat(starts, nlines) + 1)
            .astype(np.int32)),
        "l_quantity": pa.array(l_qty.astype(np.float64)),
        "l_extendedprice": l_price,
        "l_discount": l_disc,
        "l_tax": l_tax,
        "l_returnflag": _pick(["R", "A", "N"], l_rflag),
        "l_linestatus": _pick(["F", "O"], l_status),
        "l_shipdate": _date_arr(l_ship),
        "l_commitdate": _date_arr(l_commit),
        "l_receiptdate": _date_arr(l_receipt),
        "l_shipinstruct": _pick(_INSTRUCTS, rng.choice(len(_INSTRUCTS), nl)),
        "l_shipmode": _pick(_SHIPMODES, rng.choice(len(_SHIPMODES), nl)),
        "l_comment": _text(rng, nl),
    })
    return tables


def setup(session, tables: Dict[str, pa.Table]):
    """Register generated tables; returns name -> DataFrame."""
    return {name: session.create_dataframe(t) for name, t in tables.items()}


def setup_from_dir(session, path: str):
    """Load a written TPC-H dataset (parquet dirs per table) — the
    reference's ``TpchLikeSpark.setupAllParquet`` analog."""
    return {name: session.read.parquet(f"{path}/{name}")
            for name in TPCH_TABLES}


def write_parquet(tables: Dict[str, pa.Table], path: str) -> None:
    import os
    import pyarrow.parquet as papq
    for name, t in tables.items():
        os.makedirs(f"{path}/{name}", exist_ok=True)
        papq.write_table(t, f"{path}/{name}/part-00000.parquet")


# ---------------------------------------------------------------------------
# The 22 queries (validation parameter values from TPC-H spec §2.4)
# ---------------------------------------------------------------------------

def _scalar(df, name):
    v = df.collect().column(name)[0].as_py()
    return 0.0 if v is None else v


def q1(t):
    l = t["lineitem"]
    disc = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (l.filter(col("l_shipdate") <= lit(dt.date(1998, 9, 2)))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.sum(disc).alias("sum_disc_price"),
                 F.sum(disc * (lit(1.0) + col("l_tax"))).alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("*").alias("count_order"))
            .sort("l_returnflag", "l_linestatus"))


def q2(t):
    eu = (t["partsupp"]
          .join(t["supplier"], col("ps_suppkey") == col("s_suppkey"))
          .join(t["nation"], col("s_nationkey") == col("n_nationkey"))
          .join(t["region"].filter(col("r_name") == lit("EUROPE")),
                col("n_regionkey") == col("r_regionkey")))
    min_cost = (eu.group_by("ps_partkey")
                .agg(F.min("ps_supplycost").alias("min_cost"))
                .select(col("ps_partkey").alias("mc_partkey"),
                        col("min_cost")))
    parts = t["part"].filter((col("p_size") == lit(15))
                             & col("p_type").endswith("BRASS"))
    return (eu.join(parts, col("ps_partkey") == col("p_partkey"))
            .join(min_cost, (col("ps_partkey") == col("mc_partkey"))
                  & (col("ps_supplycost") == col("min_cost")))
            .select("s_acctbal", "s_name", "n_name", "p_partkey",
                    "p_mfgr", "s_address", "s_phone", "s_comment")
            .sort(col("s_acctbal").desc(), col("n_name").asc(),
                  col("s_name").asc(), col("p_partkey").asc())
            .limit(100))


def q3(t):
    cutoff = dt.date(1995, 3, 15)
    return (t["customer"].filter(col("c_mktsegment") == lit("BUILDING"))
            .join(t["orders"].filter(col("o_orderdate") < lit(cutoff)),
                  col("c_custkey") == col("o_custkey"))
            .join(t["lineitem"].filter(col("l_shipdate") > lit(cutoff)),
                  col("o_orderkey") == col("l_orderkey"))
            .group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(col("l_extendedprice")
                       * (lit(1.0) - col("l_discount"))).alias("revenue"))
            .select("l_orderkey", "revenue", "o_orderdate",
                    "o_shippriority")
            .sort(col("revenue").desc(), col("o_orderdate").asc())
            .limit(10))


def q4(t):
    late = t["lineitem"].filter(col("l_commitdate") < col("l_receiptdate"))
    return (t["orders"]
            .filter((col("o_orderdate") >= lit(dt.date(1993, 7, 1)))
                    & (col("o_orderdate") < lit(dt.date(1993, 10, 1))))
            .join(late, col("o_orderkey") == col("l_orderkey"), "semi")
            .group_by("o_orderpriority")
            .agg(F.count("*").alias("order_count"))
            .sort("o_orderpriority"))


def q5(t):
    return (t["customer"]
            .join(t["orders"]
                  .filter((col("o_orderdate") >= lit(dt.date(1994, 1, 1)))
                          & (col("o_orderdate")
                             < lit(dt.date(1995, 1, 1)))),
                  col("c_custkey") == col("o_custkey"))
            .join(t["lineitem"], col("o_orderkey") == col("l_orderkey"))
            .join(t["supplier"],
                  (col("l_suppkey") == col("s_suppkey"))
                  & (col("c_nationkey") == col("s_nationkey")))
            .join(t["nation"], col("s_nationkey") == col("n_nationkey"))
            .join(t["region"].filter(col("r_name") == lit("ASIA")),
                  col("n_regionkey") == col("r_regionkey"))
            .group_by("n_name")
            .agg(F.sum(col("l_extendedprice")
                       * (lit(1.0) - col("l_discount"))).alias("revenue"))
            .sort(col("revenue").desc()))


def q6(t):
    return (t["lineitem"]
            .filter((col("l_shipdate") >= lit(dt.date(1994, 1, 1)))
                    & (col("l_shipdate") < lit(dt.date(1995, 1, 1)))
                    & (col("l_discount") >= lit(0.05))
                    & (col("l_discount") <= lit(0.07))
                    & (col("l_quantity") < lit(24.0)))
            .agg(F.sum(col("l_extendedprice")
                       * col("l_discount")).alias("revenue")))


def q7(t):
    n1 = t["nation"].select(col("n_nationkey").alias("n1_key"),
                            col("n_name").alias("supp_nation"))
    n2 = t["nation"].select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("cust_nation"))
    pair = ((col("supp_nation") == lit("FRANCE"))
            & (col("cust_nation") == lit("GERMANY"))) | \
           ((col("supp_nation") == lit("GERMANY"))
            & (col("cust_nation") == lit("FRANCE")))
    return (t["supplier"]
            .join(t["lineitem"]
                  .filter((col("l_shipdate") >= lit(dt.date(1995, 1, 1)))
                          & (col("l_shipdate")
                             <= lit(dt.date(1996, 12, 31)))),
                  col("s_suppkey") == col("l_suppkey"))
            .join(t["orders"], col("l_orderkey") == col("o_orderkey"))
            .join(t["customer"], col("o_custkey") == col("c_custkey"))
            .join(n1, col("s_nationkey") == col("n1_key"))
            .join(n2, col("c_nationkey") == col("n2_key"))
            .filter(pair)
            .select(col("supp_nation"), col("cust_nation"),
                    F.year(col("l_shipdate")).alias("l_year"),
                    (col("l_extendedprice")
                     * (lit(1.0) - col("l_discount"))).alias("volume"))
            .group_by("supp_nation", "cust_nation", "l_year")
            .agg(F.sum("volume").alias("revenue"))
            .sort("supp_nation", "cust_nation", "l_year"))


def q8(t):
    n1 = t["nation"].select(col("n_nationkey").alias("n1_key"),
                            col("n_regionkey").alias("n1_region"))
    n2 = t["nation"].select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("supp_nation"))
    return (t["part"].filter(
                col("p_type") == lit("ECONOMY ANODIZED STEEL"))
            .join(t["lineitem"], col("p_partkey") == col("l_partkey"))
            .join(t["supplier"], col("l_suppkey") == col("s_suppkey"))
            .join(t["orders"]
                  .filter((col("o_orderdate") >= lit(dt.date(1995, 1, 1)))
                          & (col("o_orderdate")
                             <= lit(dt.date(1996, 12, 31)))),
                  col("l_orderkey") == col("o_orderkey"))
            .join(t["customer"], col("o_custkey") == col("c_custkey"))
            .join(n1, col("c_nationkey") == col("n1_key"))
            .join(t["region"].filter(col("r_name") == lit("AMERICA")),
                  col("n1_region") == col("r_regionkey"))
            .join(n2, col("s_nationkey") == col("n2_key"))
            .select(F.year(col("o_orderdate")).alias("o_year"),
                    (col("l_extendedprice")
                     * (lit(1.0) - col("l_discount"))).alias("volume"),
                    col("supp_nation"))
            .group_by("o_year")
            .agg((F.sum(F.when(col("supp_nation") == lit("BRAZIL"),
                               col("volume")).otherwise(lit(0.0)))
                  / F.sum("volume")).alias("mkt_share"))
            .sort("o_year"))


def q9(t):
    return (t["part"].filter(col("p_name").contains("green"))
            .join(t["lineitem"], col("p_partkey") == col("l_partkey"))
            .join(t["supplier"], col("l_suppkey") == col("s_suppkey"))
            .join(t["partsupp"],
                  (col("l_suppkey") == col("ps_suppkey"))
                  & (col("l_partkey") == col("ps_partkey")))
            .join(t["orders"], col("l_orderkey") == col("o_orderkey"))
            .join(t["nation"], col("s_nationkey") == col("n_nationkey"))
            .select(col("n_name").alias("nation"),
                    F.year(col("o_orderdate")).alias("o_year"),
                    (col("l_extendedprice")
                     * (lit(1.0) - col("l_discount"))
                     - col("ps_supplycost")
                     * col("l_quantity")).alias("amount"))
            .group_by("nation", "o_year")
            .agg(F.sum("amount").alias("sum_profit"))
            .sort(col("nation").asc(), col("o_year").desc()))


def q10(t):
    return (t["customer"]
            .join(t["orders"]
                  .filter((col("o_orderdate") >= lit(dt.date(1993, 10, 1)))
                          & (col("o_orderdate")
                             < lit(dt.date(1994, 1, 1)))),
                  col("c_custkey") == col("o_custkey"))
            .join(t["lineitem"].filter(col("l_returnflag") == lit("R")),
                  col("o_orderkey") == col("l_orderkey"))
            .join(t["nation"], col("c_nationkey") == col("n_nationkey"))
            .group_by("c_custkey", "c_name", "c_acctbal", "c_phone",
                      "n_name", "c_address", "c_comment")
            .agg(F.sum(col("l_extendedprice")
                       * (lit(1.0) - col("l_discount"))).alias("revenue"))
            .select("c_custkey", "c_name", "revenue", "c_acctbal",
                    "n_name", "c_address", "c_phone", "c_comment")
            .sort(col("revenue").desc(), col("c_custkey").asc())
            .limit(20))


def q11(t):
    de = (t["partsupp"]
          .join(t["supplier"], col("ps_suppkey") == col("s_suppkey"))
          .join(t["nation"].filter(col("n_name") == lit("GERMANY")),
                col("s_nationkey") == col("n_nationkey")))
    value = col("ps_supplycost") * col("ps_availqty")
    threshold = _scalar(
        de.agg(F.sum(value).alias("total")), "total") * 0.0001
    return (de.group_by("ps_partkey")
            .agg(F.sum(value).alias("value"))
            .filter(col("value") > lit(threshold))
            .sort(col("value").desc(), col("ps_partkey").asc()))


def q12(t):
    high = col("o_orderpriority").isin("1-URGENT", "2-HIGH")
    return (t["orders"]
            .join(t["lineitem"]
                  .filter(col("l_shipmode").isin("MAIL", "SHIP")
                          & (col("l_commitdate") < col("l_receiptdate"))
                          & (col("l_shipdate") < col("l_commitdate"))
                          & (col("l_receiptdate")
                             >= lit(dt.date(1994, 1, 1)))
                          & (col("l_receiptdate")
                             < lit(dt.date(1995, 1, 1)))),
                  col("o_orderkey") == col("l_orderkey"))
            .group_by("l_shipmode")
            .agg(F.sum(F.when(high, lit(1)).otherwise(lit(0)))
                 .alias("high_line_count"),
                 F.sum(F.when(~high, lit(1)).otherwise(lit(0)))
                 .alias("low_line_count"))
            .sort("l_shipmode"))


def q13(t):
    orders = t["orders"].filter(
        ~col("o_comment").like("%special%requests%"))
    return (t["customer"]
            .join(orders, col("c_custkey") == col("o_custkey"), "left")
            .group_by("c_custkey")
            .agg(F.count(col("o_orderkey")).alias("c_count"))
            .group_by("c_count")
            .agg(F.count("*").alias("custdist"))
            .sort(col("custdist").desc(), col("c_count").desc()))


def q14(t):
    disc = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (t["lineitem"]
            .filter((col("l_shipdate") >= lit(dt.date(1995, 9, 1)))
                    & (col("l_shipdate") < lit(dt.date(1995, 10, 1))))
            .join(t["part"], col("l_partkey") == col("p_partkey"))
            .agg((F.sum(F.when(col("p_type").startswith("PROMO"), disc)
                        .otherwise(lit(0.0)))
                  * lit(100.0) / F.sum(disc)).alias("promo_revenue")))


def q15(t):
    revenue = (t["lineitem"]
               .filter((col("l_shipdate") >= lit(dt.date(1996, 1, 1)))
                       & (col("l_shipdate") < lit(dt.date(1996, 4, 1))))
               .group_by("l_suppkey")
               .agg(F.sum(col("l_extendedprice")
                          * (lit(1.0) - col("l_discount")))
                    .alias("total_revenue"))
               .select(col("l_suppkey").alias("supplier_no"),
                       col("total_revenue")))
    top = _scalar(revenue.agg(F.max("total_revenue").alias("m")), "m")
    return (t["supplier"]
            .join(revenue.filter(col("total_revenue") >= lit(top)),
                  col("s_suppkey") == col("supplier_no"))
            .select("s_suppkey", "s_name", "s_address", "s_phone",
                    "total_revenue")
            .sort("s_suppkey"))


def q16(t):
    bad_supp = t["supplier"].filter(
        col("s_comment").like("%Customer%Complaints%"))
    ps = (t["partsupp"]
          .join(bad_supp, col("ps_suppkey") == col("s_suppkey"), "anti")
          .join(t["part"]
                .filter((col("p_brand") != lit("Brand#45"))
                        & ~col("p_type").startswith("MEDIUM POLISHED")
                        & col("p_size").isin(49, 14, 23, 45, 19, 3,
                                             36, 9)),
                col("ps_partkey") == col("p_partkey")))
    return (ps.select("p_brand", "p_type", "p_size", "ps_suppkey")
            .distinct()
            .group_by("p_brand", "p_type", "p_size")
            .agg(F.count("*").alias("supplier_cnt"))
            .sort(col("supplier_cnt").desc(), col("p_brand").asc(),
                  col("p_type").asc(), col("p_size").asc()))


def q17(t):
    threshold = (t["lineitem"]
                 .group_by("l_partkey")
                 .agg((F.avg("l_quantity") * lit(0.2)).alias("avg_qty"))
                 .select(col("l_partkey").alias("t_partkey"),
                         col("avg_qty")))
    return (t["lineitem"]
            .join(t["part"]
                  .filter((col("p_brand") == lit("Brand#23"))
                          & (col("p_container") == lit("MED BOX"))),
                  col("l_partkey") == col("p_partkey"))
            .join(threshold, col("l_partkey") == col("t_partkey"))
            .filter(col("l_quantity") < col("avg_qty"))
            .agg((F.sum("l_extendedprice") / lit(7.0))
                 .alias("avg_yearly")))


def q18(t):
    big = (t["lineitem"].group_by("l_orderkey")
           .agg(F.sum("l_quantity").alias("o_sum_qty"))
           .filter(col("o_sum_qty") > lit(300.0))
           .select(col("l_orderkey").alias("big_orderkey")))
    return (t["customer"]
            .join(t["orders"], col("c_custkey") == col("o_custkey"))
            .join(big, col("o_orderkey") == col("big_orderkey"), "semi")
            .join(t["lineitem"], col("o_orderkey") == col("l_orderkey"))
            .group_by("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                      "o_totalprice")
            .agg(F.sum("l_quantity").alias("sum_qty"))
            .sort(col("o_totalprice").desc(), col("o_orderdate").asc())
            .limit(100))


def q19(t):
    qty, size = col("l_quantity"), col("p_size")
    cond = (
        ((col("p_brand") == lit("Brand#12"))
         & col("p_container").isin("SM CASE", "SM BOX", "SM PACK",
                                   "SM PKG")
         & (qty >= lit(1.0)) & (qty <= lit(11.0))
         & (size >= lit(1)) & (size <= lit(5)))
        | ((col("p_brand") == lit("Brand#23"))
           & col("p_container").isin("MED BAG", "MED BOX", "MED PKG",
                                     "MED PACK")
           & (qty >= lit(10.0)) & (qty <= lit(20.0))
           & (size >= lit(1)) & (size <= lit(10)))
        | ((col("p_brand") == lit("Brand#34"))
           & col("p_container").isin("LG CASE", "LG BOX", "LG PACK",
                                     "LG PKG")
           & (qty >= lit(20.0)) & (qty <= lit(30.0))
           & (size >= lit(1)) & (size <= lit(15))))
    return (t["lineitem"]
            .filter(col("l_shipmode").isin("AIR", "REG AIR")
                    & (col("l_shipinstruct")
                       == lit("DELIVER IN PERSON")))
            .join(t["part"], col("l_partkey") == col("p_partkey"))
            .filter(cond)
            .agg(F.sum(col("l_extendedprice")
                       * (lit(1.0) - col("l_discount")))
                 .alias("revenue")))


def q20(t):
    shipped = (t["lineitem"]
               .filter((col("l_shipdate") >= lit(dt.date(1994, 1, 1)))
                       & (col("l_shipdate") < lit(dt.date(1995, 1, 1))))
               .group_by("l_partkey", "l_suppkey")
               .agg((F.sum("l_quantity") * lit(0.5)).alias("half_qty"))
               .select(col("l_partkey").alias("sh_partkey"),
                       col("l_suppkey").alias("sh_suppkey"),
                       col("half_qty")))
    forest = t["part"].filter(col("p_name").startswith("forest"))
    excess = (t["partsupp"]
              .join(forest, col("ps_partkey") == col("p_partkey"), "semi")
              .join(shipped, (col("ps_partkey") == col("sh_partkey"))
                    & (col("ps_suppkey") == col("sh_suppkey")))
              .filter(col("ps_availqty").cast("double")
                      > col("half_qty"))
              .select(col("ps_suppkey").alias("ex_suppkey"))
              .distinct())
    return (t["supplier"]
            .join(t["nation"].filter(col("n_name") == lit("CANADA")),
                  col("s_nationkey") == col("n_nationkey"))
            .join(excess, col("s_suppkey") == col("ex_suppkey"), "semi")
            .select("s_name", "s_address")
            .sort("s_name"))


def q21(t):
    # per order: #distinct suppliers overall and #distinct late suppliers
    # (exists-other-supplier / not-exists-other-late-supplier rewrite)
    supp_cnt = (t["lineitem"].select("l_orderkey", "l_suppkey").distinct()
                .group_by("l_orderkey")
                .agg(F.count("*").alias("n_supps"))
                .select(col("l_orderkey").alias("sc_orderkey"),
                        col("n_supps")))
    late = t["lineitem"].filter(
        col("l_receiptdate") > col("l_commitdate"))
    late_cnt = (late.select("l_orderkey", "l_suppkey").distinct()
                .group_by("l_orderkey")
                .agg(F.count("*").alias("n_late_supps"))
                .select(col("l_orderkey").alias("lc_orderkey"),
                        col("n_late_supps")))
    return (t["supplier"]
            .join(late, col("s_suppkey") == col("l_suppkey"))
            .join(t["orders"].filter(col("o_orderstatus") == lit("F")),
                  col("l_orderkey") == col("o_orderkey"))
            .join(t["nation"].filter(
                col("n_name") == lit("SAUDI ARABIA")),
                col("s_nationkey") == col("n_nationkey"))
            .join(supp_cnt, col("l_orderkey") == col("sc_orderkey"))
            .join(late_cnt, col("l_orderkey") == col("lc_orderkey"))
            .filter((col("n_supps") > lit(1))
                    & (col("n_late_supps") == lit(1)))
            .group_by("s_name")
            .agg(F.count("*").alias("numwait"))
            .sort(col("numwait").desc(), col("s_name").asc())
            .limit(100))


def q22(t):
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    cust = (t["customer"]
            .with_column("cntrycode",
                         F.substring(col("c_phone"), 1, 2))
            .filter(col("cntrycode").isin(*codes)))
    avg_bal = _scalar(
        cust.filter(col("c_acctbal") > lit(0.0))
        .agg(F.avg("c_acctbal").alias("a")), "a")
    return (cust.filter(col("c_acctbal") > lit(avg_bal))
            .join(t["orders"], col("c_custkey") == col("o_custkey"),
                  "anti")
            .group_by("cntrycode")
            .agg(F.count("*").alias("numcust"),
                 F.sum("c_acctbal").alias("totacctbal"))
            .sort("cntrycode"))


QUERIES = {f"q{i}": fn for i, fn in enumerate(
    [q1, q2, q3, q4, q5, q6, q7, q8, q9, q10, q11, q12, q13, q14, q15,
     q16, q17, q18, q19, q20, q21, q22], start=1)}


# SQL texts for the queries the SQL frontend's subset covers — run through
# session.sql() against registered views (the reference feeds Spark's
# parser the spec SQL; TpchLikeSpark.scala registers temp views the same
# way).
SQL_QUERIES = {
    "q1": """
      SELECT l_returnflag, l_linestatus,
             sum(l_quantity) AS sum_qty,
             sum(l_extendedprice) AS sum_base_price,
             sum(l_extendedprice * (1.0 - l_discount)) AS sum_disc_price,
             sum(l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax))
               AS sum_charge,
             avg(l_quantity) AS avg_qty,
             avg(l_extendedprice) AS avg_price,
             avg(l_discount) AS avg_disc,
             count(*) AS count_order
      FROM lineitem
      WHERE l_shipdate <= DATE '1998-09-02'
      GROUP BY l_returnflag, l_linestatus
      ORDER BY l_returnflag, l_linestatus
    """,
    "q3": """
      SELECT l_orderkey,
             sum(l_extendedprice * (1.0 - l_discount)) AS revenue,
             o_orderdate, o_shippriority
      FROM customer c
      JOIN orders o ON c_custkey = o_custkey
      JOIN lineitem l ON o_orderkey = l_orderkey
      WHERE c_mktsegment = 'BUILDING'
        AND o_orderdate < DATE '1995-03-15'
        AND l_shipdate > DATE '1995-03-15'
      GROUP BY l_orderkey, o_orderdate, o_shippriority
      ORDER BY revenue DESC, o_orderdate
      LIMIT 10
    """,
    "q5": """
      SELECT n_name,
             sum(l_extendedprice * (1.0 - l_discount)) AS revenue
      FROM customer
      JOIN orders ON c_custkey = o_custkey
      JOIN lineitem ON o_orderkey = l_orderkey
      JOIN supplier ON l_suppkey = s_suppkey AND c_nationkey = s_nationkey
      JOIN nation ON s_nationkey = n_nationkey
      JOIN region ON n_regionkey = r_regionkey
      WHERE r_name = 'ASIA'
        AND o_orderdate >= DATE '1994-01-01'
        AND o_orderdate < DATE '1995-01-01'
      GROUP BY n_name
      ORDER BY revenue DESC
    """,
    "q6": """
      SELECT sum(l_extendedprice * l_discount) AS revenue
      FROM lineitem
      WHERE l_shipdate >= DATE '1994-01-01'
        AND l_shipdate < DATE '1995-01-01'
        AND l_discount BETWEEN 0.05 AND 0.07
        AND l_quantity < 24.0
    """,
    "q10": """
      SELECT c_custkey, c_name,
             sum(l_extendedprice * (1.0 - l_discount)) AS revenue,
             c_acctbal, n_name, c_address, c_phone, c_comment
      FROM customer
      JOIN orders ON c_custkey = o_custkey
      JOIN lineitem ON o_orderkey = l_orderkey
      JOIN nation ON c_nationkey = n_nationkey
      WHERE o_orderdate >= DATE '1993-10-01'
        AND o_orderdate < DATE '1994-01-01'
        AND l_returnflag = 'R'
      GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name,
               c_address, c_comment
      ORDER BY revenue DESC, c_custkey
      LIMIT 20
    """,
    "q12": """
      SELECT l_shipmode,
             sum(CASE WHEN o_orderpriority = '1-URGENT'
                        OR o_orderpriority = '2-HIGH'
                      THEN 1 ELSE 0 END) AS high_line_count,
             sum(CASE WHEN o_orderpriority <> '1-URGENT'
                       AND o_orderpriority <> '2-HIGH'
                      THEN 1 ELSE 0 END) AS low_line_count
      FROM orders
      JOIN lineitem ON o_orderkey = l_orderkey
      WHERE l_shipmode IN ('MAIL', 'SHIP')
        AND l_commitdate < l_receiptdate
        AND l_shipdate < l_commitdate
        AND l_receiptdate >= DATE '1994-01-01'
        AND l_receiptdate < DATE '1995-01-01'
      GROUP BY l_shipmode
      ORDER BY l_shipmode
    """,
    "q14": """
      SELECT sum(CASE WHEN p_type LIKE 'PROMO%'
                      THEN l_extendedprice * (1.0 - l_discount)
                      ELSE 0.0 END) * 100.0
             / sum(l_extendedprice * (1.0 - l_discount)) AS promo_revenue
      FROM lineitem
      JOIN part ON l_partkey = p_partkey
      WHERE l_shipdate >= DATE '1995-09-01'
        AND l_shipdate < DATE '1995-10-01'
    """,
    "q19": """
      SELECT sum(l_extendedprice * (1.0 - l_discount)) AS revenue
      FROM lineitem
      JOIN part ON p_partkey = l_partkey
      WHERE l_shipmode IN ('AIR', 'REG AIR')
        AND l_shipinstruct = 'DELIVER IN PERSON'
        AND ((p_brand = 'Brand#12'
              AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK',
                                  'SM PKG')
              AND l_quantity BETWEEN 1.0 AND 11.0
              AND p_size BETWEEN 1 AND 5)
          OR (p_brand = 'Brand#23'
              AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG',
                                  'MED PACK')
              AND l_quantity BETWEEN 10.0 AND 20.0
              AND p_size BETWEEN 1 AND 10)
          OR (p_brand = 'Brand#34'
              AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK',
                                  'LG PKG')
              AND l_quantity BETWEEN 20.0 AND 30.0
              AND p_size BETWEEN 1 AND 15))
    """,
}


def setup_views(session, tables: Dict[str, pa.Table]) -> None:
    """Register the 8 tables as temp views for SQL_QUERIES."""
    for name, tbl in tables.items():
        session.create_dataframe(tbl).create_or_replace_temp_view(name)

