"""TpcdsLike queries q1-q33 (DataFrame form).

Ported whole from ``spark_rapids_tpu/bench/tpcds_queries_a.py`` with its
imports retargeted at the port's ``col``, ``functions`` and ``Window``.

Reference analog: integration_tests/.../tests/tpcds/TpcdsLikeSpark.scala
(the 99-query "Like" suite).  Queries are original DataFrame-API
re-expressions of the spec's intent over the dbgen-lite schema; SQL
subquery forms are rewritten with the standard planner rewrites:

  IN/EXISTS (subquery)   -> leftsemi join
  NOT IN / NOT EXISTS    -> leftanti join
  scalar subquery        -> crossJoin of a 1-row aggregate
  INTERSECT / EXCEPT     -> distinct + leftsemi / leftanti
  ROLLUP / GROUPING SETS -> UNION of per-level aggregates

q3/q7/q19/q42/q52/q55/q68/q73/q96/q98 live in tpcds.py.
"""

from __future__ import annotations

import datetime as _dt

from spark_rapids_tpu_torch.api.column import col, lit
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window


def _d(y, m, d):
    return lit(_dt.date(y, m, d))


def q1(t):
    """Customers returning more than 1.2x the store-average return."""
    ctr = (t["store_returns"]
           .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                 col("sr_returned_date_sk") == col("d_date_sk"))
           .group_by("sr_customer_sk", "sr_store_sk")
           .agg(F.sum("sr_return_amt").alias("ctr_total_return")))
    avg_ctr = (ctr.group_by("sr_store_sk")
               .agg((F.avg("ctr_total_return") * lit(1.2)).alias("thr"))
               .select(col("sr_store_sk").alias("avg_store_sk"),
                       col("thr")))
    return (ctr
            .join(avg_ctr, col("sr_store_sk") == col("avg_store_sk"))
            .filter(col("ctr_total_return") > col("thr"))
            .join(t["store"].filter(col("s_state").isin(
                "TN", "CA", "TX", "NY", "WA", "GA")),
                col("sr_store_sk") == col("s_store_sk"))
            .join(t["customer"],
                  col("sr_customer_sk") == col("c_customer_sk"))
            .select("c_customer_id")
            .sort("c_customer_id")
            .limit(100))


def q2(t):
    """Web+catalog weekly sales; year-over-year per-day ratios."""
    wscs = (t["web_sales"]
            .select(col("ws_sold_date_sk").alias("sold_date_sk"),
                    col("ws_ext_sales_price").alias("sales_price"))
            .union(t["catalog_sales"]
                   .select(col("cs_sold_date_sk").alias("sold_date_sk"),
                           col("cs_ext_sales_price")
                           .alias("sales_price"))))

    def day(nm):
        return F.sum(F.when(col("d_day_name") == lit(nm),
                            col("sales_price")).otherwise(lit(None)))

    wk = (wscs.join(t["date_dim"],
                    col("sold_date_sk") == col("d_date_sk"))
          .group_by("d_week_seq")
          .agg(day("Sunday").alias("sun_sales"),
               day("Monday").alias("mon_sales"),
               day("Tuesday").alias("tue_sales"),
               day("Wednesday").alias("wed_sales"),
               day("Thursday").alias("thu_sales"),
               day("Friday").alias("fri_sales"),
               day("Saturday").alias("sat_sales")))
    years = (t["date_dim"].select("d_week_seq", "d_year").distinct())
    y1 = (wk.join(years.filter(col("d_year") == lit(2001)),
                  on="d_week_seq")
          .select(col("d_week_seq").alias("w1"),
                  *[col(c).alias(c + "1")
                    for c in ["sun_sales", "mon_sales", "tue_sales",
                              "wed_sales", "thu_sales", "fri_sales",
                              "sat_sales"]]))
    y2 = (wk.join(years.filter(col("d_year") == lit(2002)),
                  on="d_week_seq")
          .select((col("d_week_seq") - lit(53)).alias("w2"),
                  *[col(c).alias(c + "2")
                    for c in ["sun_sales", "mon_sales", "tue_sales",
                              "wed_sales", "thu_sales", "fri_sales",
                              "sat_sales"]]))
    out = y1.join(y2, col("w1") == col("w2"))
    ratios = [(col(c + "1") / col(c + "2")).alias("r_" + c[:3])
              for c in ["sun_sales", "mon_sales", "tue_sales",
                        "wed_sales", "thu_sales", "fri_sales",
                        "sat_sales"]]
    return out.select(col("w1"), *ratios).sort("w1")


def _year_total(t, channel, first: bool):
    """q4/q11/q74 helper: per-customer period revenue for one channel.

    Like-delta: the spec compares two single years; dbgen-lite data is
    too sparse for a per-customer 6-way single-year chain, so period 1 =
    1998-2000 and period 2 = 2001-2002 keep the identical plan shape.
    """
    if channel == "s":
        sales, date_k, cust_k = "store_sales", "ss_sold_date_sk", \
            "ss_customer_sk"
        val = (col("ss_ext_list_price") - col("ss_ext_discount_amt"))
    elif channel == "c":
        sales, date_k, cust_k = "catalog_sales", "cs_sold_date_sk", \
            "cs_bill_customer_sk"
        val = (col("cs_ext_list_price") - col("cs_ext_discount_amt"))
    else:
        sales, date_k, cust_k = "web_sales", "ws_sold_date_sk", \
            "ws_bill_customer_sk"
        val = (col("ws_ext_list_price") - col("ws_ext_discount_amt"))
    dd = t["date_dim"].filter(col("d_year") <= lit(2000) if first
                              else col("d_year") > lit(2000))
    return (t[sales]
            .join(dd, col(date_k) == col("d_date_sk"))
            .join(t["customer"], col(cust_k) == col("c_customer_sk"))
            .group_by("c_customer_id")
            .agg(F.sum(val).alias("year_total"))
            .filter(col("year_total") > lit(0.0)))


def q4(t):
    """Customers whose catalog AND web growth outpaces store growth."""
    s1 = _year_total(t, "s", True).select(
        col("c_customer_id").alias("id_s1"),
        col("year_total").alias("t_s1"))
    s2 = _year_total(t, "s", False).select(
        col("c_customer_id").alias("id_s2"),
        col("year_total").alias("t_s2"))
    c1 = _year_total(t, "c", True).select(
        col("c_customer_id").alias("id_c1"),
        col("year_total").alias("t_c1"))
    c2 = _year_total(t, "c", False).select(
        col("c_customer_id").alias("id_c2"),
        col("year_total").alias("t_c2"))
    w1 = _year_total(t, "w", True).select(
        col("c_customer_id").alias("id_w1"),
        col("year_total").alias("t_w1"))
    w2 = _year_total(t, "w", False).select(
        col("c_customer_id").alias("id_w2"),
        col("year_total").alias("t_w2"))
    j = (s1.join(s2, col("id_s1") == col("id_s2"))
         .join(c1, col("id_s1") == col("id_c1"))
         .join(c2, col("id_s1") == col("id_c2"))
         .join(w1, col("id_s1") == col("id_w1"))
         .join(w2, col("id_s1") == col("id_w2")))
    return (j.filter((col("t_c2") / col("t_c1")
                      > col("t_s2") / col("t_s1"))
                     & (col("t_c2") / col("t_c1")
                        > col("t_w2") / col("t_w1")))
            .select(col("id_s1").alias("customer_id"))
            .sort("customer_id")
            .limit(100))


def q5(t):
    """Channel profit/loss rollup over sales + returns."""
    ss = (t["store_sales"]
          .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
          .group_by("s_store_id")
          .agg(F.sum("ss_ext_sales_price").alias("sales"),
               F.sum("ss_net_profit").alias("profit"))
          .select(lit("store channel").alias("channel"),
                  col("s_store_id").alias("id"), col("sales"),
                  col("profit")))
    cs = (t["catalog_sales"]
          .join(t["catalog_page"],
                col("cs_catalog_page_sk") == col("cp_catalog_page_sk"))
          .group_by("cp_catalog_page_id")
          .agg(F.sum("cs_ext_sales_price").alias("sales"),
               F.sum("cs_net_profit").alias("profit"))
          .select(lit("catalog channel").alias("channel"),
                  col("cp_catalog_page_id").alias("id"), col("sales"),
                  col("profit")))
    ws = (t["web_sales"]
          .join(t["web_site"],
                col("ws_web_site_sk") == col("web_site_sk"))
          .group_by("web_site_id")
          .agg(F.sum("ws_ext_sales_price").alias("sales"),
               F.sum("ws_net_profit").alias("profit"))
          .select(lit("web channel").alias("channel"),
                  col("web_site_id").alias("id"), col("sales"),
                  col("profit")))
    detail = ss.union(cs).union(ws)
    per_channel = (detail.group_by("channel")
                   .agg(F.sum("sales").alias("sales"),
                        F.sum("profit").alias("profit"))
                   .select(col("channel"), lit(None).cast("string")
                           .alias("id"), col("sales"), col("profit")))
    total = (detail.agg(F.sum("sales").alias("sales"),
                        F.sum("profit").alias("profit"))
             .select(lit(None).cast("string").alias("channel"),
                     lit(None).cast("string").alias("id"),
                     col("sales"), col("profit")))
    return (detail.union(per_channel).union(total)
            .sort(col("channel").asc_nulls_last(),
                  col("id").asc_nulls_last(), col("sales").desc())
            .limit(100))


def q6(t):
    """States with 10+ customers buying items priced >= 1.2x their
    category average in one month."""
    cat_avg = (t["item"].group_by("i_category")
               .agg((F.avg("i_current_price") * lit(1.2)).alias("thr"))
               .select(col("i_category").alias("avg_cat"), col("thr")))
    items = (t["item"]
             .join(cat_avg, col("i_category") == col("avg_cat"))
             .filter(col("i_current_price") > col("thr")))
    return (t["store_sales"]
            .join(t["date_dim"].filter((col("d_year") == lit(2000))
                                       & (col("d_moy") == lit(1))),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(items, col("ss_item_sk") == col("i_item_sk"))
            .join(t["customer"],
                  col("ss_customer_sk") == col("c_customer_sk"))
            .join(t["customer_address"],
                  col("c_current_addr_sk") == col("ca_address_sk"))
            .group_by("ca_state")
            .agg(F.count("*").alias("cnt"))
            .filter(col("cnt") >= lit(10))
            .sort(col("cnt").asc(), col("ca_state").asc())
            .limit(100))


def q8(t):
    """Store net profit for stores in preferred-customer zip codes.

    The spec INTERSECTs a literal 400-zip list with zips that have >1
    preferred customers; Like version keeps the data-driven side (the
    INTERSECT-as-semi-join shape) since random zips rarely hit literals.
    """
    pref = (t["customer"].filter(col("c_preferred_cust_flag") == lit("Y"))
            .join(t["customer_address"],
                  col("c_current_addr_sk") == col("ca_address_sk"))
            .group_by("ca_zip")
            .agg(F.count("*").alias("cnt"))
            .filter(col("cnt") > lit(1))
            .select(F.substring(col("ca_zip"), 1, 2).alias("zip2"))
            .distinct())
    return (t["store_sales"]
            .join(t["date_dim"].filter((col("d_qoy") == lit(2))
                                       & (col("d_year") == lit(1998))),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .with_column("s_zip2", F.substring(col("s_zip"), 1, 2))
            .join(pref, col("s_zip2") == col("zip2"), how="leftsemi")
            .group_by("s_store_name")
            .agg(F.sum("ss_net_profit").alias("profit"))
            .sort("s_store_name")
            .limit(100))


def q9(t):
    """Bucketed quantity statistics pivoted into one row."""
    buckets = [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)]
    aggs = []
    for i, (lo, hi) in enumerate(buckets, 1):
        in_b = (col("ss_quantity") >= lit(lo)) & \
            (col("ss_quantity") <= lit(hi))
        aggs.append(F.sum(F.when(in_b, lit(1)).otherwise(lit(0)))
                    .alias(f"cnt{i}"))
        aggs.append(F.avg(F.when(in_b, col("ss_ext_discount_amt"))
                          .otherwise(lit(None))).alias(f"avg_disc{i}"))
        aggs.append(F.avg(F.when(in_b, col("ss_net_paid"))
                          .otherwise(lit(None))).alias(f"avg_paid{i}"))
    stats = t["store_sales"].agg(*aggs)
    picks = []
    for i in range(1, 6):
        picks.append(F.when(col(f"cnt{i}") > lit(100),
                            col(f"avg_disc{i}"))
                     .otherwise(col(f"avg_paid{i}")).alias(f"bucket{i}"))
    return (t["reason"].filter(col("r_reason_sk") == lit(1))
            .crossJoin(stats)
            .select(*picks))


def q10(t):
    """Demographic counts for county customers active in any channel."""
    c = (t["customer"]
         .join(t["customer_address"].filter(
             col("ca_county").isin("Williamson County", "Ziebach County",
                                   "Walker County")),
             col("c_current_addr_sk") == col("ca_address_sk")))
    dd = t["date_dim"].filter((col("d_year") == lit(2000))
                              & (col("d_moy") >= lit(1))
                              & (col("d_moy") <= lit(4)))
    ss_c = (t["store_sales"]
            .join(dd.select("d_date_sk"),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .select(col("ss_customer_sk").alias("act_sk")))
    ws_c = (t["web_sales"]
            .join(dd.select(col("d_date_sk").alias("wd_sk")),
                  col("ws_sold_date_sk") == col("wd_sk"))
            .select(col("ws_bill_customer_sk").alias("act_sk")))
    cs_c = (t["catalog_sales"]
            .join(dd.select(col("d_date_sk").alias("cd_sk")),
                  col("cs_sold_date_sk") == col("cd_sk"))
            .select(col("cs_bill_customer_sk").alias("act_sk")))
    c = c.join(ss_c, col("c_customer_sk") == col("act_sk"),
               how="leftsemi")
    c = c.join(ws_c.union(cs_c), col("c_customer_sk") == col("act_sk"),
               how="leftsemi")
    return (c.join(t["customer_demographics"],
                   col("c_current_cdemo_sk") == col("cd_demo_sk"))
            .group_by("cd_gender", "cd_marital_status",
                      "cd_education_status", "cd_purchase_estimate",
                      "cd_credit_rating")
            .agg(F.count("*").alias("cnt"))
            .sort("cd_gender", "cd_marital_status",
                  "cd_education_status", "cd_purchase_estimate",
                  "cd_credit_rating")
            .limit(100))


def q11(t):
    """Customers whose web growth outpaces store growth (2-channel q4)."""
    s1 = _year_total(t, "s", True).select(
        col("c_customer_id").alias("id_s1"),
        col("year_total").alias("t_s1"))
    s2 = _year_total(t, "s", False).select(
        col("c_customer_id").alias("id_s2"),
        col("year_total").alias("t_s2"))
    w1 = _year_total(t, "w", True).select(
        col("c_customer_id").alias("id_w1"),
        col("year_total").alias("t_w1"))
    w2 = _year_total(t, "w", False).select(
        col("c_customer_id").alias("id_w2"),
        col("year_total").alias("t_w2"))
    return (s1.join(s2, col("id_s1") == col("id_s2"))
            .join(w1, col("id_s1") == col("id_w1"))
            .join(w2, col("id_s1") == col("id_w2"))
            .filter(col("t_w2") / col("t_w1")
                    > col("t_s2") / col("t_s1"))
            .select(col("id_s1").alias("customer_id"))
            .sort("customer_id")
            .limit(100))


def q12(t):
    """Web item revenue + share of class revenue (q98 web version)."""
    base = (t["web_sales"]
            .join(t["item"].filter(
                col("i_category").isin("Sports", "Books", "Home")),
                col("ws_item_sk") == col("i_item_sk"))
            .join(t["date_dim"].filter(
                (col("d_date") >= _d(1999, 2, 22))
                & (col("d_date") <= _d(1999, 3, 24))),
                col("ws_sold_date_sk") == col("d_date_sk"))
            .group_by("i_item_id", "i_item_desc", "i_category",
                      "i_class", "i_current_price")
            .agg(F.sum("ws_ext_sales_price").alias("itemrevenue")))
    return (base.select(
        col("i_item_id"), col("i_item_desc"), col("i_category"),
        col("i_class"), col("i_current_price"), col("itemrevenue"),
        (col("itemrevenue") * lit(100.0)
         / F.sum(col("itemrevenue")).over(
             Window.partition_by("i_class"))).alias("revenueratio"))
        .sort("i_category", "i_class", "i_item_id", "i_item_desc",
              "revenueratio")
        .limit(100))


def q13(t):
    """Averages under OR'd demographic x address conditions."""
    cd_ok = ((col("cd_marital_status") == lit("M"))
             & (col("cd_education_status") == lit("College"))
             & (col("ss_sales_price") >= lit(100.0))) | \
            ((col("cd_marital_status") == lit("S"))
             & (col("cd_education_status") == lit("Primary"))
             & (col("ss_sales_price") >= lit(50.0))) | \
            ((col("cd_marital_status") == lit("W"))
             & (col("cd_education_status") == lit("2 yr Degree")))
    ca_ok = (col("ca_state").isin("TX", "OH", "CA")
             | col("ca_state").isin("WA", "NY", "GA"))
    return (t["store_sales"]
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .join(t["customer_demographics"],
                  col("ss_cdemo_sk") == col("cd_demo_sk"))
            .join(t["household_demographics"],
                  col("ss_hdemo_sk") == col("hd_demo_sk"))
            .join(t["customer_address"],
                  col("ss_addr_sk") == col("ca_address_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(2001)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .filter(cd_ok & ca_ok)
            .agg(F.avg("ss_quantity").alias("avg_qty"),
                 F.avg("ss_ext_sales_price").alias("avg_esp"),
                 F.avg("ss_ext_wholesale_cost").alias("avg_ewc"),
                 F.sum("ss_ext_wholesale_cost").alias("sum_ewc")))


def q14(t):
    """Cross-channel items: brands sold in all three channels, per-channel
    sales above the all-channel average (iceberg lite)."""
    ss_b = (t["store_sales"]
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .select(col("i_brand_id").alias("b1")).distinct())
    cs_b = (t["catalog_sales"]
            .join(t["item"].select(col("i_item_sk").alias("ci_sk"),
                                   col("i_brand_id").alias("b2")),
                  col("cs_item_sk") == col("ci_sk"))
            .select("b2").distinct())
    ws_b = (t["web_sales"]
            .join(t["item"].select(col("i_item_sk").alias("wi_sk"),
                                   col("i_brand_id").alias("b3")),
                  col("ws_item_sk") == col("wi_sk"))
            .select("b3").distinct())
    cross = (ss_b.join(cs_b, col("b1") == col("b2"), how="leftsemi")
             .join(ws_b, col("b1") == col("b3"), how="leftsemi"))
    avg_sales = (t["store_sales"]
                 .select((col("ss_quantity") * col("ss_list_price"))
                         .alias("v"))
                 .union(t["catalog_sales"].select(
                     (col("cs_quantity") * col("cs_list_price"))
                     .alias("v")))
                 .union(t["web_sales"].select(
                     (col("ws_quantity") * col("ws_list_price"))
                     .alias("v")))
                 .agg(F.avg("v").alias("average_sales")))
    return (t["store_sales"]
            .join(t["date_dim"].filter((col("d_year") == lit(2001))
                                       & (col("d_moy") == lit(11))),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .join(cross, col("i_brand_id") == col("b1"),
                  how="leftsemi")
            .group_by("i_brand_id", "i_class_id", "i_category_id")
            .agg(F.sum(col("ss_quantity") * col("ss_list_price"))
                 .alias("sales"), F.count("*").alias("number_sales"))
            .crossJoin(avg_sales)
            .filter(col("sales") > col("average_sales"))
            .select(lit("store").alias("channel"), col("i_brand_id"),
                    col("i_class_id"), col("i_category_id"),
                    col("sales"), col("number_sales"))
            .sort("i_brand_id", "i_class_id", "i_category_id")
            .limit(100))


def q15(t):
    """Catalog sales by customer zip for qualifying geographies."""
    return (t["catalog_sales"]
            .join(t["customer"],
                  col("cs_bill_customer_sk") == col("c_customer_sk"))
            .join(t["customer_address"],
                  col("c_current_addr_sk") == col("ca_address_sk"))
            .join(t["date_dim"].filter((col("d_qoy") == lit(2))
                                       & (col("d_year") == lit(2001))),
                  col("cs_sold_date_sk") == col("d_date_sk"))
            .filter(F.substring(col("ca_zip"), 1, 2)
                    .isin("85", "86", "88", "89", "80", "81", "30", "31")
                    | col("ca_state").isin("CA", "WA", "GA")
                    | (col("cs_sales_price") > lit(500.0)))
            .group_by("ca_zip")
            .agg(F.sum("cs_sales_price").alias("total"))
            .sort("ca_zip")
            .limit(100))


def q16(t):
    """Catalog orders shipped from one state: multi-warehouse orders
    without returns (EXISTS/NOT EXISTS via semi/anti joins)."""
    cs1 = (t["catalog_sales"]
           .join(t["date_dim"].filter(
               (col("d_date") >= _d(2002, 2, 1))
               & (col("d_date") <= _d(2002, 4, 2))),
               col("cs_ship_date_sk") == col("d_date_sk"))
           .join(t["customer_address"].filter(
               col("ca_state") == lit("GA")),
               col("cs_ship_addr_sk") == col("ca_address_sk"))
           .join(t["call_center"],
                 col("cs_call_center_sk") == col("cc_call_center_sk")))
    # EXISTS (same order, different warehouse) -> orders spanning >1
    # distinct warehouse, then a plain semi join on the order number
    multi_wh = (t["catalog_sales"]
                .group_by("cs_order_number")
                .agg(F.count_distinct(col("cs_warehouse_sk"))
                     .alias("n_wh"))
                .filter(col("n_wh") > lit(1))
                .select(col("cs_order_number").alias("o2")))
    returned = t["catalog_returns"].select(
        col("cr_order_number").alias("ro"))
    base = (cs1
            .join(multi_wh, col("cs_order_number") == col("o2"),
                  how="leftsemi")
            .join(returned, col("cs_order_number") == col("ro"),
                  how="leftanti"))
    dist = (base.select("cs_order_number").distinct()
            .agg(F.count("*").alias("order_count")))
    return (base.agg(F.sum("cs_ext_ship_cost")
                     .alias("total_shipping_cost"),
                     F.sum("cs_net_profit").alias("total_net_profit"))
            .crossJoin(dist)
            .select("order_count", "total_shipping_cost",
                    "total_net_profit"))


def _stddev(sum_sq, sum_, cnt):
    """Sample stddev from (sum of squares, sum, count) aggregates."""
    n = cnt.cast("double")
    var = (sum_sq - sum_ * sum_ / n) / (n - lit(1.0))
    return F.sqrt(F.when(n > lit(1.0), var).otherwise(lit(None)))


def q17(t):
    """Store purchase/return/catalog-repurchase quantity stats."""
    d1 = (t["date_dim"].filter(col("d_quarter_name") == lit("2001Q1"))
          .select(col("d_date_sk").alias("d1_sk")))
    d2 = (t["date_dim"].filter(
        col("d_quarter_name").isin("2001Q1", "2001Q2", "2001Q3"))
        .select(col("d_date_sk").alias("d2_sk")))
    d3 = (t["date_dim"].filter(
        col("d_quarter_name").isin("2001Q1", "2001Q2", "2001Q3"))
        .select(col("d_date_sk").alias("d3_sk")))
    j = (t["store_sales"]
         .join(d1, col("ss_sold_date_sk") == col("d1_sk"))
         .join(t["store_returns"],
               (col("ss_ticket_number") == col("sr_ticket_number"))
               & (col("ss_item_sk") == col("sr_item_sk")))
         .join(d2, col("sr_returned_date_sk") == col("d2_sk"))
         .join(t["catalog_sales"],
               (col("sr_customer_sk") == col("cs_bill_customer_sk"))
               & (col("sr_item_sk") == col("cs_item_sk")))
         .join(d3, col("cs_sold_date_sk") == col("d3_sk"))
         .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
         .join(t["store"], col("ss_store_sk") == col("s_store_sk")))
    q = col("ss_quantity").cast("double")
    return (j.group_by("i_item_id", "i_item_desc", "s_state")
            .agg(F.count("*").alias("store_sales_quantitycount"),
                 F.avg("ss_quantity").alias("store_sales_quantityave"),
                 F.sum(q * q).alias("ssq2"),
                 F.sum(q).alias("ssq1"))
            .select(col("i_item_id"), col("i_item_desc"), col("s_state"),
                    col("store_sales_quantitycount"),
                    col("store_sales_quantityave"),
                    _stddev(col("ssq2"), col("ssq1"),
                            col("store_sales_quantitycount"))
                    .alias("store_sales_quantitystdev"))
            .sort("i_item_id", "i_item_desc", "s_state")
            .limit(100))


def q18(t):
    """Catalog averages by customer geography rollup."""
    base = (t["catalog_sales"]
            .join(t["customer_demographics"].filter(
                (col("cd_gender") == lit("F"))
                & (col("cd_education_status") == lit("Unknown"))),
                col("cs_bill_cdemo_sk") == col("cd_demo_sk"))
            .join(t["customer"].filter(col("c_birth_month").isin(
                1, 6, 8, 9, 12, 2)),
                col("cs_bill_customer_sk") == col("c_customer_sk"))
            .join(t["customer_address"].filter(
                col("ca_state").isin("CA", "NY", "TX", "OH", "WA")),
                col("c_current_addr_sk") == col("ca_address_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(1998)),
                  col("cs_sold_date_sk") == col("d_date_sk")))

    def level(keys, names):
        sel = [col(k).alias(n) for k, n in zip(keys, names)]
        sel += [lit(None).cast("string").alias(n)
                for n in ["ca_country", "ca_state", "ca_county"]
                [len(keys):]]
        return (base.group_by(*keys).agg(
            F.avg(col("cs_quantity").cast("double")).alias("agg1"),
            F.avg(col("cs_list_price").cast("double")).alias("agg2"),
            F.avg(col("cs_coupon_amt").cast("double")).alias("agg3"),
            F.avg(col("cs_sales_price").cast("double")).alias("agg4"))
            .select(*sel, col("agg1"), col("agg2"), col("agg3"),
                    col("agg4"))) if keys else \
            (base.agg(
                F.avg(col("cs_quantity").cast("double")).alias("agg1"),
                F.avg(col("cs_list_price").cast("double")).alias("agg2"),
                F.avg(col("cs_coupon_amt").cast("double")).alias("agg3"),
                F.avg(col("cs_sales_price").cast("double"))
                .alias("agg4"))
             .select(lit(None).cast("string").alias("ca_country"),
                     lit(None).cast("string").alias("ca_state"),
                     lit(None).cast("string").alias("ca_county"),
                     col("agg1"), col("agg2"), col("agg3"),
                     col("agg4")))

    lvl3 = level(["ca_country", "ca_state", "ca_county"],
                 ["ca_country", "ca_state", "ca_county"])
    lvl2 = level(["ca_country", "ca_state"], ["ca_country", "ca_state"])
    lvl1 = level(["ca_country"], ["ca_country"])
    lvl0 = level([], [])
    return (lvl3.union(lvl2).union(lvl1).union(lvl0)
            .sort(col("ca_country").asc_nulls_last(),
                  col("ca_state").asc_nulls_last(),
                  col("ca_county").asc_nulls_last())
            .limit(100))


def q20(t):
    """Catalog item revenue + class share (q98 catalog version)."""
    base = (t["catalog_sales"]
            .join(t["item"].filter(
                col("i_category").isin("Sports", "Books", "Home")),
                col("cs_item_sk") == col("i_item_sk"))
            .join(t["date_dim"].filter(
                (col("d_date") >= _d(1999, 2, 22))
                & (col("d_date") <= _d(1999, 3, 24))),
                col("cs_sold_date_sk") == col("d_date_sk"))
            .group_by("i_item_id", "i_item_desc", "i_category",
                      "i_class", "i_current_price")
            .agg(F.sum("cs_ext_sales_price").alias("itemrevenue")))
    return (base.select(
        col("i_item_id"), col("i_item_desc"), col("i_category"),
        col("i_class"), col("i_current_price"), col("itemrevenue"),
        (col("itemrevenue") * lit(100.0)
         / F.sum(col("itemrevenue")).over(
             Window.partition_by("i_class"))).alias("revenueratio"))
        .sort("i_category", "i_class", "i_item_id", "i_item_desc",
              "revenueratio")
        .limit(100))


def q21(t):
    """Inventory level change around a date per warehouse/item."""
    pivot = _d(2000, 3, 11)
    j = (t["inventory"]
         .join(t["warehouse"],
               col("inv_warehouse_sk") == col("w_warehouse_sk"))
         .join(t["item"], col("inv_item_sk") == col("i_item_sk"))
         .join(t["date_dim"].filter(
             (col("d_date") >= _d(2000, 2, 10))
             & (col("d_date") <= _d(2000, 4, 10))),
             col("inv_date_sk") == col("d_date_sk")))
    g = (j.group_by("w_warehouse_name", "i_item_id")
         .agg(F.sum(F.when(col("d_date") < pivot,
                           col("inv_quantity_on_hand"))
                    .otherwise(lit(0))).alias("inv_before"),
              F.sum(F.when(col("d_date") >= pivot,
                           col("inv_quantity_on_hand"))
                    .otherwise(lit(0))).alias("inv_after")))
    ratio = col("inv_after").cast("double") / \
        col("inv_before").cast("double")
    return (g.filter((col("inv_before") > lit(0))
                     & (ratio >= lit(2.0 / 3.0))
                     & (ratio <= lit(3.0 / 2.0)))
            .sort("w_warehouse_name", "i_item_id")
            .limit(100))


def q22(t):
    """Average inventory quantity rollup over the item hierarchy."""
    base = (t["inventory"]
            .join(t["date_dim"].filter(
                (col("d_month_seq") >= lit(120))
                & (col("d_month_seq") <= lit(131))),
                col("inv_date_sk") == col("d_date_sk"))
            .join(t["item"], col("inv_item_sk") == col("i_item_sk")))

    def level(keys):
        names = ["i_product_name", "i_brand", "i_class", "i_category"]
        sel = [col(k) for k in keys] + \
            [lit(None).cast("string").alias(n) for n in names[len(keys):]]
        if keys:
            return (base.group_by(*keys)
                    .agg(F.avg("inv_quantity_on_hand").alias("qoh"))
                    .select(*sel, col("qoh")))
        return (base.agg(F.avg("inv_quantity_on_hand").alias("qoh"))
                .select(*sel, col("qoh")))

    return (level(["i_product_name", "i_brand", "i_class", "i_category"])
            .union(level(["i_product_name", "i_brand", "i_class"]))
            .union(level(["i_product_name", "i_brand"]))
            .union(level(["i_product_name"]))
            .union(level([]))
            .sort(col("qoh").asc(),
                  col("i_product_name").asc_nulls_last(),
                  col("i_brand").asc_nulls_last(),
                  col("i_class").asc_nulls_last(),
                  col("i_category").asc_nulls_last())
            .limit(100))


def q23(t):
    """Best customers buying frequent items (iceberg lite)."""
    frequent = (t["store_sales"]
                .join(t["date_dim"].filter(
                    col("d_year").isin(2000, 2001)),
                    col("ss_sold_date_sk") == col("d_date_sk"))
                .group_by("ss_item_sk")
                .agg(F.count("*").alias("cnt"))
                .filter(col("cnt") > lit(4))
                .select(col("ss_item_sk").alias("freq_sk")))
    spenders = (t["store_sales"]
                .group_by("ss_customer_sk")
                .agg(F.sum(col("ss_quantity").cast("double")
                           * col("ss_sales_price")).alias("csales")))
    max_sales = (spenders.agg((F.max("csales") * lit(0.5))
                              .alias("tpcds_cmax")))
    best = (spenders.crossJoin(max_sales)
            .filter(col("csales") > col("tpcds_cmax"))
            .select(col("ss_customer_sk").alias("best_sk")))
    cs = (t["catalog_sales"]
          .join(t["date_dim"].filter((col("d_year") == lit(2000))
                                     & (col("d_moy") == lit(3))),
                col("cs_sold_date_sk") == col("d_date_sk"))
          .join(frequent, col("cs_item_sk") == col("freq_sk"),
                how="leftsemi")
          .join(best, col("cs_bill_customer_sk") == col("best_sk"),
                how="leftsemi")
          .select((col("cs_quantity").cast("double")
                   * col("cs_list_price")).alias("sales")))
    ws = (t["web_sales"]
          .join(t["date_dim"].filter((col("d_year") == lit(2000))
                                     & (col("d_moy") == lit(3)))
                .select(col("d_date_sk").alias("wd_sk")),
                col("ws_sold_date_sk") == col("wd_sk"))
          .join(frequent, col("ws_item_sk") == col("freq_sk"),
                how="leftsemi")
          .join(best, col("ws_bill_customer_sk") == col("best_sk"),
                how="leftsemi")
          .select((col("ws_quantity").cast("double")
                   * col("ws_list_price")).alias("sales")))
    return cs.union(ws).agg(F.sum("sales").alias("total"))


def q24(t):
    """Customer net paid per color for same-state store customers."""
    ssales = (t["store_sales"]
              .join(t["store_returns"],
                    (col("ss_ticket_number") == col("sr_ticket_number"))
                    & (col("ss_item_sk") == col("sr_item_sk")))
              .join(t["store"].filter(col("s_market_id") <= lit(5)),
                    col("ss_store_sk") == col("s_store_sk"))
              .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
              .join(t["customer"],
                    col("ss_customer_sk") == col("c_customer_sk"))
              .filter(col("c_birth_country") != lit("Mexico"))
              .group_by("c_last_name", "c_first_name", "s_store_name",
                        "i_color")
              .agg(F.sum("ss_net_paid").alias("netpaid")))
    avg_paid = ssales.agg((F.avg("netpaid") * lit(0.05)).alias("thr"))
    return (ssales.crossJoin(avg_paid)
            .filter(col("netpaid") > col("thr"))
            .select("c_last_name", "c_first_name", "s_store_name",
                    "i_color", "netpaid")
            .sort("c_last_name", "c_first_name", "s_store_name",
                  "i_color")
            .limit(100))


def q25(t):
    """Store purchase -> return -> catalog repurchase profit chain.
    (Like-delta: wider month windows than the spec's 4..10 single year —
    dbgen-lite chains are sparse.)"""
    d1 = (t["date_dim"].filter((col("d_moy") <= lit(6))
                               & (col("d_year") == lit(2001)))
          .select(col("d_date_sk").alias("d1_sk")))
    d2 = (t["date_dim"].filter(col("d_year").isin(2001, 2002))
          .select(col("d_date_sk").alias("d2_sk")))
    d3 = (t["date_dim"].filter(col("d_year").isin(2001, 2002))
          .select(col("d_date_sk").alias("d3_sk")))
    return (t["store_sales"]
            .join(d1, col("ss_sold_date_sk") == col("d1_sk"))
            .join(t["store_returns"],
                  (col("ss_ticket_number") == col("sr_ticket_number"))
                  & (col("ss_item_sk") == col("sr_item_sk")))
            .join(d2, col("sr_returned_date_sk") == col("d2_sk"))
            .join(t["catalog_sales"],
                  (col("sr_customer_sk") == col("cs_bill_customer_sk"))
                  & (col("sr_item_sk") == col("cs_item_sk")))
            .join(d3, col("cs_sold_date_sk") == col("d3_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .group_by("i_item_id", "i_item_desc", "s_store_id",
                      "s_store_name")
            .agg(F.sum("ss_net_profit").alias("store_sales_profit"),
                 F.sum("sr_net_loss").alias("store_returns_loss"),
                 F.sum("cs_net_profit").alias("catalog_sales_profit"))
            .sort("i_item_id", "i_item_desc", "s_store_id",
                  "s_store_name")
            .limit(100))


def q26(t):
    """Catalog demographic/promo item averages (q7 catalog version)."""
    cd = t["customer_demographics"].filter(
        (col("cd_gender") == lit("M"))
        & (col("cd_marital_status") == lit("S"))
        & (col("cd_education_status") == lit("College")))
    promo = t["promotion"].filter(
        (col("p_channel_email") == lit("N"))
        | (col("p_channel_event") == lit("N")))
    return (t["catalog_sales"]
            .join(cd, col("cs_bill_cdemo_sk") == col("cd_demo_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                  col("cs_sold_date_sk") == col("d_date_sk"))
            .join(promo, col("cs_promo_sk") == col("p_promo_sk"))
            .join(t["item"], col("cs_item_sk") == col("i_item_sk"))
            .group_by("i_item_id")
            .agg(F.avg("cs_quantity").alias("agg1"),
                 F.avg("cs_list_price").alias("agg2"),
                 F.avg("cs_coupon_amt").alias("agg3"),
                 F.avg("cs_sales_price").alias("agg4"))
            .sort("i_item_id")
            .limit(100))


def q27(t):
    """Store demographic item/state averages with rollup."""
    base = (t["store_sales"]
            .join(t["customer_demographics"].filter(
                (col("cd_gender") == lit("M"))
                & (col("cd_marital_status") == lit("S"))
                & (col("cd_education_status") == lit("College"))),
                col("ss_cdemo_sk") == col("cd_demo_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"].filter(col("s_state").isin("TN", "CA")),
                  col("ss_store_sk") == col("s_store_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk")))

    def agg4(df):
        return df.agg(F.avg("ss_quantity").alias("agg1"),
                      F.avg("ss_list_price").alias("agg2"),
                      F.avg("ss_coupon_amt").alias("agg3"),
                      F.avg("ss_sales_price").alias("agg4"))

    lvl2 = (agg4(base.group_by("i_item_id", "s_state"))
            .select(col("i_item_id"), col("s_state"),
                    lit(0).alias("g_state"), col("agg1"), col("agg2"),
                    col("agg3"), col("agg4")))
    lvl1 = (agg4(base.group_by("i_item_id"))
            .select(col("i_item_id"),
                    lit(None).cast("string").alias("s_state"),
                    lit(1).alias("g_state"), col("agg1"), col("agg2"),
                    col("agg3"), col("agg4")))
    lvl0 = (agg4(base)
            .select(lit(None).cast("string").alias("i_item_id"),
                    lit(None).cast("string").alias("s_state"),
                    lit(1).alias("g_state"), col("agg1"), col("agg2"),
                    col("agg3"), col("agg4")))
    return (lvl2.union(lvl1).union(lvl0)
            .sort(col("i_item_id").asc_nulls_last(),
                  col("s_state").asc_nulls_last())
            .limit(100))


def q28(t):
    """Six price-bucket averages/distinct counts cross-joined."""
    buckets = [(0, 5, 11, 460, 14, 194), (6, 10, 91, 1430, 30, 864),
               (11, 15, 66, 1546, 28, 724), (16, 20, 142, 3636, 60, 932),
               (21, 25, 135, 3619, 53, 1136),
               (26, 30, 28, 2513, 45, 1006)]
    out = None
    for i, (qlo, qhi, lp_lo, _lp, cp_lo, wc_lo) in enumerate(buckets, 1):
        f = (t["store_sales"]
             .filter((col("ss_quantity") >= lit(qlo))
                     & (col("ss_quantity") <= lit(qhi))
                     & ((col("ss_list_price") >= lit(float(lp_lo)))
                        | (col("ss_coupon_amt") >= lit(float(cp_lo)))
                        | (col("ss_wholesale_cost")
                           >= lit(float(wc_lo))))))
        b = f.agg(F.avg("ss_list_price").alias(f"b{i}_lp"),
                  F.count("ss_list_price").alias(f"b{i}_cnt"))
        bd = (f.select("ss_list_price").distinct()
              .agg(F.count("*").alias(f"b{i}_cntd")))
        b = b.crossJoin(bd)
        out = b if out is None else out.crossJoin(b)
    return out


def q29(t):
    """q25 chain with quantity aggregates."""
    d1 = (t["date_dim"].filter((col("d_moy") == lit(4))
                               & (col("d_year") == lit(1999)))
          .select(col("d_date_sk").alias("d1_sk")))
    d2 = (t["date_dim"].filter((col("d_moy") >= lit(4))
                               & (col("d_moy") <= lit(7))
                               & (col("d_year") == lit(1999)))
          .select(col("d_date_sk").alias("d2_sk")))
    d3 = (t["date_dim"].filter(col("d_year").isin(1999, 2000, 2001))
          .select(col("d_date_sk").alias("d3_sk")))
    return (t["store_sales"]
            .join(d1, col("ss_sold_date_sk") == col("d1_sk"))
            .join(t["store_returns"],
                  (col("ss_ticket_number") == col("sr_ticket_number"))
                  & (col("ss_item_sk") == col("sr_item_sk")))
            .join(d2, col("sr_returned_date_sk") == col("d2_sk"))
            .join(t["catalog_sales"],
                  (col("sr_customer_sk") == col("cs_bill_customer_sk"))
                  & (col("sr_item_sk") == col("cs_item_sk")))
            .join(d3, col("cs_sold_date_sk") == col("d3_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .group_by("i_item_id", "i_item_desc", "s_store_id",
                      "s_store_name")
            .agg(F.sum("ss_quantity").alias("store_sales_quantity"),
                 F.sum("sr_return_quantity")
                 .alias("store_returns_quantity"),
                 F.sum("cs_quantity").alias("catalog_sales_quantity"))
            .sort("i_item_id", "i_item_desc", "s_store_id",
                  "s_store_name")
            .limit(100))


def q30(t):
    """Web customers returning >1.2x state average (q1 web version)."""
    ctr = (t["web_returns"]
           .join(t["date_dim"].filter(col("d_year") == lit(2002)),
                 col("wr_returned_date_sk") == col("d_date_sk"))
           .join(t["customer_address"],
                 col("wr_refunded_addr_sk") == col("ca_address_sk"))
           .group_by("wr_returning_customer_sk", "ca_state")
           .agg(F.sum("wr_return_amt").alias("ctr_total_return")))
    avg_ctr = (ctr.group_by("ca_state")
               .agg((F.avg("ctr_total_return") * lit(1.2)).alias("thr"))
               .select(col("ca_state").alias("avg_state"), col("thr")))
    return (ctr
            .join(avg_ctr, col("ca_state") == col("avg_state"))
            .filter(col("ctr_total_return") > col("thr"))
            .join(t["customer"],
                  col("wr_returning_customer_sk")
                  == col("c_customer_sk"))
            .select("c_customer_id", "c_salutation", "c_first_name",
                    "c_last_name", "c_preferred_cust_flag",
                    "c_birth_day", "c_birth_month", "c_birth_year",
                    "c_birth_country", "ctr_total_return")
            .sort("c_customer_id", "ctr_total_return")
            .limit(100))


def q31(t):
    """Counties where web growth outpaces store growth across quarters."""
    ss = (t["store_sales"]
          .join(t["customer_address"],
                col("ss_addr_sk") == col("ca_address_sk"))
          .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                col("ss_sold_date_sk") == col("d_date_sk"))
          .group_by("ca_county", "d_qoy")
          .agg(F.sum("ss_ext_sales_price").alias("store_sales")))
    ws = (t["web_sales"]
          .join(t["customer_address"].select(
              col("ca_address_sk").alias("wca_sk"),
              col("ca_county").alias("w_county")),
              col("ws_bill_addr_sk") == col("wca_sk"))
          .join(t["date_dim"].filter(col("d_year") == lit(2000))
                .select(col("d_date_sk").alias("wd_sk"),
                        col("d_qoy").alias("w_qoy")),
                col("ws_sold_date_sk") == col("wd_sk"))
          .group_by("w_county", "w_qoy")
          .agg(F.sum("ws_ext_sales_price").alias("web_sales")))

    def pick(df, q, kc, vc, ka, va):
        return (df.filter(col(q[0]) == lit(q[1]))
                .select(col(kc).alias(ka), col(vc).alias(va)))

    ss1 = pick(ss, ("d_qoy", 1), "ca_county", "store_sales",
               "county_s1", "ss1")
    ss2 = pick(ss, ("d_qoy", 2), "ca_county", "store_sales",
               "county_s2", "ss2")
    ws1 = pick(ws, ("w_qoy", 1), "w_county", "web_sales",
               "county_w1", "ws1")
    ws2 = pick(ws, ("w_qoy", 2), "w_county", "web_sales",
               "county_w2", "ws2")
    return (ss1.join(ss2, col("county_s1") == col("county_s2"))
            .join(ws1, col("county_s1") == col("county_w1"))
            .join(ws2, col("county_s1") == col("county_w2"))
            .filter((col("ss1") > lit(0.0)) & (col("ws1") > lit(0.0))
                    & (col("ws2") / col("ws1")
                       > col("ss2") / col("ss1")))
            .select(col("county_s1").alias("ca_county"),
                    (col("ws2") / col("ws1")).alias("web_q1_q2_increase"),
                    (col("ss2") / col("ss1"))
                    .alias("store_q1_q2_increase"))
            .sort("ca_county"))


def q32(t):
    """Catalog excess discount: discount > 1.3x item 90-day average."""
    dd = t["date_dim"].filter((col("d_date") >= _d(2000, 1, 27))
                              & (col("d_date") <= _d(2000, 4, 26)))
    per_item = (t["catalog_sales"]
                .join(dd.select(col("d_date_sk").alias("ad_sk")),
                      col("cs_sold_date_sk") == col("ad_sk"))
                .group_by("cs_item_sk")
                .agg((F.avg("cs_ext_discount_amt") * lit(1.3))
                     .alias("thr"))
                .select(col("cs_item_sk").alias("avg_item_sk"),
                        col("thr")))
    return (t["catalog_sales"]
            .join(dd.select("d_date_sk"),
                  col("cs_sold_date_sk") == col("d_date_sk"))
            .join(t["item"].filter(col("i_manufact_id") == lit(77)),
                  col("cs_item_sk") == col("i_item_sk"))
            .join(per_item, col("cs_item_sk") == col("avg_item_sk"))
            .filter(col("cs_ext_discount_amt") > col("thr"))
            .agg(F.sum("cs_ext_discount_amt")
                 .alias("excess_discount_amount")))


def _by_manufact(t, sales, item_filter):
    """q33/q56/q60 helper: per-channel revenue for filtered items."""
    fact, date_k, item_k, addr_k, price = sales
    wanted = (t["item"].filter(item_filter)
              .select(col("i_manufact_id").alias("want_mid")).distinct())
    return (t[fact]
            .join(t["date_dim"].filter((col("d_year") == lit(1998))
                                       & (col("d_moy") == lit(5)))
                  .select(col("d_date_sk").alias(fact + "_d_sk")),
                  col(date_k) == col(fact + "_d_sk"))
            .join(t["customer_address"].filter(
                col("ca_gmt_offset") == lit(-5.0))
                .select(col("ca_address_sk").alias(fact + "_ca_sk")),
                col(addr_k) == col(fact + "_ca_sk"))
            .join(t["item"], col(item_k) == col("i_item_sk"))
            .join(wanted, col("i_manufact_id") == col("want_mid"),
                  how="leftsemi")
            .group_by("i_manufact_id")
            .agg(F.sum(price).alias("total_sales")))


def q33(t):
    """Manufacturer revenue across all three channels (category)."""
    filt = col("i_category") == lit("Electronics")
    ss = _by_manufact(t, ("store_sales", "ss_sold_date_sk",
                          "ss_item_sk", "ss_addr_sk",
                          "ss_ext_sales_price"), filt)
    cs = _by_manufact(t, ("catalog_sales", "cs_sold_date_sk",
                          "cs_item_sk", "cs_bill_addr_sk",
                          "cs_ext_sales_price"), filt)
    ws = _by_manufact(t, ("web_sales", "ws_sold_date_sk",
                          "ws_item_sk", "ws_bill_addr_sk",
                          "ws_ext_sales_price"), filt)
    return (ss.union(cs).union(ws)
            .group_by("i_manufact_id")
            .agg(F.sum("total_sales").alias("total_sales"))
            .sort(col("total_sales").asc(), col("i_manufact_id").asc())
            .limit(100))
