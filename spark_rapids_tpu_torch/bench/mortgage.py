"""MortgageLike for the port: the mortgage-ETL benchmark (fannie-mae-style
data).

Ported from ``spark_rapids_tpu/bench/mortgage.py`` with the port's
``col``, ``lit`` and ``functions``.  Reference analog:
integration_tests/.../tests/mortgage/MortgageSpark.scala: performance and
acquisition tables, per-loan delinquency aggregation, a 12-month
explode/re-aggregate, seller-name normalization join, and the final
acquisition/performance feature join; plus the simple-aggregate
benchmark queries.  An original DataFrame re-expression over dbgen-lite
data (the reference reads real CSV dumps; data shape, not data, is the
point here).

:func:`generate` draws from its ``numpy`` generator in the reference's
order, so ``generate(sf, seed)`` equals the reference's table for table;
the columns that draw nothing (quarters, reporting dates, the string
columns' values) are built by numpy and Arrow instead of per-row Python,
which makes the 9,000,000 performance rows of SF 1 in seconds.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict

import numpy as np
import pyarrow as pa

import pyarrow.compute as pc

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.column import col, lit


_SELLERS = ["WITMER LLC", "witmer llc", "Witmer Financial",
            "ACME BANK", "Acme Bank NA", "acme",
            "FIRST UNITED", "First United Corp"]
_CANON = {"WITMER LLC": "Witmer", "witmer llc": "Witmer",
          "Witmer Financial": "Witmer", "ACME BANK": "Acme",
          "Acme Bank NA": "Acme", "acme": "Acme",
          "FIRST UNITED": "FirstUnited",
          "First United Corp": "FirstUnited"}


def _strings(pool, idx: np.ndarray) -> pa.Array:
    """``[pool[i] for i in idx]`` as an Arrow string array."""
    return pc.take(pa.array(pool, type=pa.string()), pa.array(idx))


def _choice(rng, pool, n: int) -> pa.Array:
    """``rng.choice(pool, n)`` as Arrow strings: the same draw (choice
    over a population draws indices whatever the values)."""
    return _strings(pool, rng.choice(np.arange(len(pool)), n))


def generate(sf: float = 0.001, seed: int = 0) -> Dict[str, pa.Table]:
    rng = np.random.default_rng(seed)
    n_loans = max(200, int(500_000 * sf))
    quarters = [f"{y}Q{q}" for y in (2000, 2001) for q in range(1, 5)]

    loan_q = rng.integers(0, len(quarters), n_loans)
    acq = pa.table({
        "loan_id": pa.array(np.arange(1, n_loans + 1, dtype=np.int64)),
        "quarter": _strings(quarters, loan_q),
        "seller_name": _choice(rng, _SELLERS, n_loans),
        "orig_channel": _choice(rng, ["R", "B", "C"], n_loans),
        "orig_interest_rate": np.round(rng.uniform(2.0, 9.0, n_loans), 3),
        "orig_upb": pa.array(
            (rng.integers(30, 800, n_loans) * 1000).astype(np.int64)),
        "orig_loan_term": pa.array(
            rng.choice([180, 240, 360], n_loans).astype(np.int32)),
        "dti": pa.array(rng.uniform(5, 60, n_loans),
                        mask=rng.random(n_loans) < 0.05),
        "borrower_credit_score": pa.array(
            rng.integers(450, 850, n_loans).astype(np.int32),
            mask=rng.random(n_loans) < 0.03),
        "first_home_buyer": _choice(rng, ["Y", "N", "U"], n_loans),
    })

    # performance: ~18 monthly rows per loan with a random delinquency
    # walk; upb amortizes toward zero
    rows_per = 18
    n_perf = n_loans * rows_per
    loan_ids = np.repeat(np.arange(1, n_loans + 1, dtype=np.int64),
                         rows_per)
    month_idx = np.tile(np.arange(rows_per), n_loans)
    # base + timedelta(days=int(30.4 * m)), as days since the epoch
    base = (_dt.date(2000, 1, 1) - _dt.date(1970, 1, 1)).days
    dates = base + (30.4 * month_idx).astype(np.int64)
    status = np.maximum(
        0, rng.integers(-6, 4, n_perf) + (month_idx // 6)).astype(
        np.int32)
    upb0 = np.repeat(
        (rng.integers(30, 800, n_loans) * 1000).astype(np.float64),
        rows_per)
    upb = np.round(upb0 * (1 - month_idx / (rows_per * 2.0)), 2)
    upb = np.where(rng.random(n_perf) < 0.02, 0.0, upb)
    perf = pa.table({
        "loan_id": pa.array(loan_ids),
        "quarter": _strings(quarters, loan_q[loan_ids - 1]),
        "monthly_reporting_period": pa.array(dates.astype(np.int32),
                                             type=pa.date32()),
        "current_actual_upb": upb,
        "current_loan_delinquency_status": pa.array(status),
        "servicer": _choice(rng, _SELLERS, n_perf),
        "interest_rate": np.round(rng.uniform(2.0, 9.0, n_perf), 3),
        "loan_age": pa.array(month_idx.astype(np.int32)),
    })
    return {"perf": perf, "acq": acq}


def setup(session, tables: Dict[str, pa.Table]):
    return {k: session.create_dataframe(v, num_partitions=4)
            for k, v in tables.items()}


def name_mapping(session):
    """Seller-name normalization lookup (NameMapping analog)."""
    return session.create_dataframe(pa.table({
        "from_seller_name": list(_CANON.keys()),
        "to_seller_name": list(_CANON.values()),
    }))


def performance_delinquency(t):
    """Per-(quarter, loan) delinquency features + the 12-month window
    re-aggregation (CreatePerformanceDelinquency analog: conditional
    when-aggregates, explode over 12 month offsets, floor/pmod month
    bucketing, left join back)."""
    df = (t["perf"]
          .with_column("period_month",
                       F.month(col("monthly_reporting_period")))
          .with_column("period_year",
                       F.year(col("monthly_reporting_period"))))
    agg = (df.select(
        col("quarter"), col("loan_id"),
        col("current_loan_delinquency_status").alias("status"),
        F.when(col("current_loan_delinquency_status") >= lit(1),
               col("monthly_reporting_period")).otherwise(lit(None))
        .alias("d30"),
        F.when(col("current_loan_delinquency_status") >= lit(3),
               col("monthly_reporting_period")).otherwise(lit(None))
        .alias("d90"),
        F.when(col("current_loan_delinquency_status") >= lit(6),
               col("monthly_reporting_period")).otherwise(lit(None))
        .alias("d180"))
        .group_by("quarter", "loan_id")
        .agg(F.max("status").alias("delinquency_12"),
             F.min("d30").alias("delinquency_30"),
             F.min("d90").alias("delinquency_90"),
             F.min("d180").alias("delinquency_180"))
        .select(col("quarter").alias("a_quarter"),
                col("loan_id").alias("a_loan_id"),
                (col("delinquency_12") >= lit(1)).alias("ever_30"),
                (col("delinquency_12") >= lit(3)).alias("ever_90"),
                (col("delinquency_12") >= lit(6)).alias("ever_180"),
                col("delinquency_30"), col("delinquency_90"),
                col("delinquency_180")))

    joined = (df.select(col("quarter"), col("loan_id"),
                        col("current_loan_delinquency_status")
                        .alias("delinquency_12"),
                        col("current_actual_upb").alias("upb_12"),
                        col("period_month").alias("timestamp_month"),
                        col("period_year").alias("timestamp_year"))
              .join(agg, (col("loan_id") == col("a_loan_id"))
                    & (col("quarter") == col("a_quarter")), how="left"))

    months = 12
    month_y = F.explode(F.array(*[lit(i) for i in range(months)]))
    exploded = joined.with_column("month_y", month_y)
    mody = ((col("timestamp_year") * lit(12) + col("timestamp_month"))
            - lit(24000) - col("month_y"))
    bucketed = (exploded
                .with_column("josh_mody_n",
                             F.floor(mody.cast("double")
                                     / lit(float(months))))
                .group_by("quarter", "loan_id", "josh_mody_n",
                          "ever_30", "ever_90", "ever_180", "month_y")
                .agg(F.max("delinquency_12").alias("max_d12"),
                     F.min("upb_12").alias("min_upb_12")))
    ts_base = (lit(24000)
               + (col("josh_mody_n") * lit(months)).cast("bigint")
               + col("month_y"))
    return (bucketed
            .with_column("timestamp_year",
                         F.floor((ts_base - lit(1)).cast("double")
                                 / lit(12.0)).cast("bigint"))
            .with_column("timestamp_month_tmp",
                         F.pmod(ts_base, lit(12)))
            .with_column("timestamp_month",
                         F.when(col("timestamp_month_tmp") == lit(0),
                                lit(12))
                         .otherwise(col("timestamp_month_tmp")))
            .with_column("delinquency_12",
                         (col("max_d12") > lit(3)).cast("int")
                         + (col("min_upb_12") == lit(0.0)).cast("int"))
            .select("quarter", "loan_id", "timestamp_year",
                    "timestamp_month", "delinquency_12", "ever_30",
                    "ever_90", "ever_180"))


def acquisition(t, session):
    """Acquisition cleanup + seller-name normalization join."""
    return (t["acq"]
            .join(name_mapping(session),
                  col("seller_name") == col("from_seller_name"),
                  how="left")
            .select(col("loan_id").alias("q_loan_id"),
                    col("quarter").alias("q_quarter"),
                    F.coalesce(col("to_seller_name"),
                               col("seller_name")).alias("seller"),
                    col("orig_channel"), col("orig_interest_rate"),
                    col("orig_upb"), col("orig_loan_term"), col("dti"),
                    col("borrower_credit_score"),
                    col("first_home_buyer")))


def run(t, session):
    """The full mortgage ETL: delinquency features joined to cleaned
    acquisition records (CleanAcquisitionPrime analog)."""
    perf = performance_delinquency(t)
    acq = acquisition(t, session)
    return (perf.join(acq, (col("loan_id") == col("q_loan_id"))
                      & (col("quarter") == col("q_quarter")))
            .select("loan_id", "quarter", "timestamp_year",
                    "timestamp_month", "delinquency_12", "ever_30",
                    "ever_90", "ever_180", "seller", "orig_channel",
                    "orig_interest_rate", "orig_upb", "dti",
                    "borrower_credit_score", "first_home_buyer"))


def simple_aggregates(t):
    """Per-quarter portfolio stats (Benchmarks SimpleAggregates
    analog)."""
    loans = (t["perf"].select("quarter", "loan_id").distinct()
             .group_by("quarter").agg(F.count("*").alias("loans"))
             .select(col("quarter").alias("l_quarter"), col("loans")))
    stats = (t["perf"]
             .group_by("quarter")
             .agg(F.avg("interest_rate").alias("avg_rate"),
                  F.sum("current_actual_upb").alias("total_upb"),
                  F.max("current_loan_delinquency_status")
                  .alias("worst_status")))
    return (stats.join(loans, col("quarter") == col("l_quarter"))
            .select("quarter", "loans", "avg_rate", "total_upb",
                    "worst_status")
            .sort("quarter"))


def delinquency_rate(t):
    """Share of ever-90-delinquent loans per quarter."""
    per_loan = (t["perf"]
                .group_by("quarter", "loan_id")
                .agg(F.max("current_loan_delinquency_status")
                     .alias("worst")))
    return (per_loan.group_by("quarter")
            .agg(F.count("*").alias("loans"),
                 F.sum(F.when(col("worst") >= lit(3), lit(1))
                       .otherwise(lit(0))).alias("ever_90"))
            .select(col("quarter"), col("loans"), col("ever_90"),
                    (col("ever_90").cast("double")
                     / col("loans").cast("double")).alias("rate"))
            .sort("quarter"))
