"""TpcdsLike queries q34-q66 (DataFrame form).

Ported whole from ``spark_rapids_tpu/bench/tpcds_queries_b.py`` with its
imports retargeted at the port's ``col``, ``functions`` and ``Window``.

Reference analog: integration_tests/.../tests/tpcds/TpcdsLikeSpark.scala.
Same rewrite conventions as tpcds_queries_a.py.
"""

from __future__ import annotations

import datetime as _dt

from spark_rapids_tpu_torch.api.column import col, lit
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window

from spark_rapids_tpu_torch.bench.tpcds_queries_a import _d, _stddev, \
    _year_total


def q34(t):
    """Households with 15-20 item tickets (q73 with wider dom windows)."""
    hd = t["household_demographics"].filter(
        col("hd_buy_potential").isin(">10000", "Unknown")
        & (col("hd_vehicle_count") > lit(0)))
    counts = (t["store_sales"]
              .join(t["date_dim"].filter(
                  (((col("d_dom") >= lit(1)) & (col("d_dom") <= lit(3)))
                   | ((col("d_dom") >= lit(25))
                      & (col("d_dom") <= lit(28))))
                  & col("d_year").isin(1999, 2000, 2001)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
              .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
              .join(hd, col("ss_hdemo_sk") == col("hd_demo_sk"))
              .group_by("ss_ticket_number", "ss_customer_sk")
              .agg(F.count("*").alias("cnt"))
              .filter((col("cnt") >= lit(1)) & (col("cnt") <= lit(20))))
    return (counts
            .join(t["customer"],
                  col("ss_customer_sk") == col("c_customer_sk"))
            .select("c_last_name", "c_first_name", "c_salutation",
                    "c_preferred_cust_flag", "ss_ticket_number", "cnt")
            .sort(col("c_last_name").asc_nulls_last(),
                  col("c_first_name").asc_nulls_last(),
                  col("c_salutation").asc_nulls_last(),
                  col("c_preferred_cust_flag").desc_nulls_first(),
                  col("ss_ticket_number").asc())
            .limit(100))


def q35(t):
    """q10 variant with per-demographic dependent-count statistics."""
    dd = t["date_dim"].filter((col("d_year") == lit(2002))
                              & (col("d_qoy") < lit(4)))
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
    c = (t["customer"]
         .join(ss_c, col("c_customer_sk") == col("act_sk"),
               how="leftsemi")
         .join(ws_c.union(cs_c), col("c_customer_sk") == col("act_sk"),
               how="leftsemi")
         .join(t["customer_address"],
               col("c_current_addr_sk") == col("ca_address_sk"))
         .join(t["customer_demographics"],
               col("c_current_cdemo_sk") == col("cd_demo_sk")))
    return (c.group_by("ca_state", "cd_gender", "cd_marital_status",
                       "cd_dep_count")
            .agg(F.count("*").alias("cnt1"),
                 F.min("cd_dep_count").alias("min_dep"),
                 F.max("cd_dep_count").alias("max_dep"),
                 F.avg("cd_dep_count").alias("avg_dep"))
            .sort(col("ca_state").asc_nulls_last(), col("cd_gender"),
                  col("cd_marital_status"), col("cd_dep_count"))
            .limit(100))


def q36(t):
    """Gross-margin ratio rollup over category/class with rank."""
    base = (t["store_sales"]
            .join(t["date_dim"].filter(col("d_year") == lit(2001)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .join(t["store"].filter(col("s_state").isin("TN", "CA",
                                                        "TX", "NY")),
                  col("ss_store_sk") == col("s_store_sk")))

    def level(keys, lochierarchy):
        g = (base.group_by(*keys) if keys else base)
        a = g.agg(F.sum("ss_net_profit").alias("np"),
                  F.sum("ss_ext_sales_price").alias("esp"))
        sel = [col(k) for k in keys]
        sel += [lit(None).cast("string").alias(n)
                for n in ["i_category", "i_class"][len(keys):]]
        return a.select(
            (col("np") / col("esp")).alias("gross_margin"), *sel,
            lit(lochierarchy).alias("lochierarchy"))

    u = (level(["i_category", "i_class"], 0)
         .union(level(["i_category"], 1))
         .union(level([], 2)))
    rk = F.rank().over(
        Window.partition_by("lochierarchy")
        .order_by(col("gross_margin").asc()))
    return (u.select("gross_margin", "i_category", "i_class",
                     "lochierarchy", rk.alias("rank_within_parent"))
            .sort(col("lochierarchy").desc(),
                  col("i_category").asc_nulls_last(),
                  col("rank_within_parent").asc())
            .limit(100))


def q37(t):
    """Items with healthy inventory also sold by catalog in window."""
    inv = (t["inventory"]
           .join(t["date_dim"].filter(
               (col("d_date") >= _d(2000, 2, 1))
               & (col("d_date") <= _d(2000, 4, 1))),
               col("inv_date_sk") == col("d_date_sk"))
           .filter((col("inv_quantity_on_hand") >= lit(100))
                   & (col("inv_quantity_on_hand") <= lit(500)))
           .select(col("inv_item_sk").alias("inv_sk")))
    sold = t["catalog_sales"].select(col("cs_item_sk").alias("sold_sk"))
    return (t["item"]
            .filter((col("i_current_price") >= lit(10.0))
                    & (col("i_current_price") <= lit(60.0))
                    & col("i_manufact_id").isin(
                        *range(1, 200)))
            .join(inv, col("i_item_sk") == col("inv_sk"),
                  how="leftsemi")
            .join(sold, col("i_item_sk") == col("sold_sk"),
                  how="leftsemi")
            .group_by("i_item_id", "i_item_desc", "i_current_price")
            .agg(F.count("*").alias("_cnt"))
            .select("i_item_id", "i_item_desc", "i_current_price")
            .sort("i_item_id")
            .limit(100))


def q38(t):
    """Customers active in ALL three channels (INTERSECT chain)."""
    dd = t["date_dim"].filter((col("d_month_seq") >= lit(120))
                              & (col("d_month_seq") <= lit(131)))
    ss = (t["store_sales"]
          .join(dd.select("d_date_sk"),
                col("ss_sold_date_sk") == col("d_date_sk"))
          .select(col("ss_customer_sk").alias("sk")).distinct())
    cs = (t["catalog_sales"]
          .join(dd.select(col("d_date_sk").alias("cd_sk")),
                col("cs_sold_date_sk") == col("cd_sk"))
          .select(col("cs_bill_customer_sk").alias("csk")).distinct())
    ws = (t["web_sales"]
          .join(dd.select(col("d_date_sk").alias("wd_sk")),
                col("ws_sold_date_sk") == col("wd_sk"))
          .select(col("ws_bill_customer_sk").alias("wsk")).distinct())
    return (ss.join(cs, col("sk") == col("csk"), how="leftsemi")
            .join(ws, col("sk") == col("wsk"), how="leftsemi")
            .agg(F.count("*").alias("cnt")))


def q39(t):
    """Inventory coefficient-of-variation pairs across months."""
    base = (t["inventory"]
            .join(t["item"], col("inv_item_sk") == col("i_item_sk"))
            .join(t["warehouse"],
                  col("inv_warehouse_sk") == col("w_warehouse_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(2001)),
                  col("inv_date_sk") == col("d_date_sk")))
    q = col("inv_quantity_on_hand").cast("double")
    g = (base.group_by("w_warehouse_name", "w_warehouse_sk",
                       "i_item_sk", "d_moy")
         .agg(F.count("*").alias("n"), F.sum(q).alias("s1"),
              F.sum(q * q).alias("s2"),
              F.avg("inv_quantity_on_hand").alias("mean")))
    g = (g.filter(col("mean") > lit(0.0))
         .select(col("w_warehouse_sk"), col("w_warehouse_name"),
                 col("i_item_sk"), col("d_moy"), col("mean"),
                 (_stddev(col("s2"), col("s1"), col("n"))
                  / col("mean")).alias("cov"))
         .filter(col("cov") > lit(0.5)))
    m1 = g.select(col("w_warehouse_sk").alias("wsk1"),
                  col("i_item_sk").alias("isk1"),
                  col("d_moy").alias("moy1"),
                  col("mean").alias("mean1"), col("cov").alias("cov1"))
    m2 = g.select(col("w_warehouse_sk").alias("wsk2"),
                  col("i_item_sk").alias("isk2"),
                  col("d_moy").alias("moy2"),
                  col("mean").alias("mean2"), col("cov").alias("cov2"))
    return (m1.join(m2, (col("wsk1") == col("wsk2"))
                    & (col("isk1") == col("isk2")))
            .filter(col("moy2") == col("moy1") + lit(1))
            .sort("wsk1", "isk1", "moy1")
            .limit(100))


def q40(t):
    """Catalog value shift around a date per warehouse/item, net of
    returns."""
    pivot = _d(2000, 3, 11)
    cr = t["catalog_returns"].select(
        col("cr_order_number").alias("cr_o"),
        col("cr_item_sk").alias("cr_i"),
        col("cr_refunded_cash").alias("refund"))
    j = (t["catalog_sales"]
         .join(cr, (col("cs_order_number") == col("cr_o"))
               & (col("cs_item_sk") == col("cr_i")), how="left")
         .join(t["warehouse"],
               col("cs_warehouse_sk") == col("w_warehouse_sk"))
         .join(t["item"].filter((col("i_current_price") >= lit(0.99))
                                & (col("i_current_price")
                                   <= lit(100.0))),
               col("cs_item_sk") == col("i_item_sk"))
         .join(t["date_dim"].filter(
             (col("d_date") >= _d(2000, 2, 10))
             & (col("d_date") <= _d(2000, 4, 10))),
             col("cs_sold_date_sk") == col("d_date_sk")))
    val = col("cs_sales_price") - F.coalesce(col("refund"), lit(0.0))
    return (j.group_by("w_state", "i_item_id")
            .agg(F.sum(F.when(col("d_date") < pivot, val)
                       .otherwise(lit(0.0))).alias("sales_before"),
                 F.sum(F.when(col("d_date") >= pivot, val)
                       .otherwise(lit(0.0))).alias("sales_after"))
            .sort("w_state", "i_item_id")
            .limit(100))


def q41(t):
    """Distinct product names of items matching manufact styles."""
    cond1 = ((col("i_category") == lit("Women"))
             & col("i_color").isin("red", "blue", "navy", "ivory")
             & col("i_units").isin("Each", "Dozen", "Oz", "Pound"))
    cond2 = ((col("i_category") == lit("Men"))
             & col("i_color").isin("green", "black", "white", "plum")
             & col("i_units").isin("Case", "Ton", "Pallet", "Each"))
    styled = (t["item"].filter(cond1 | cond2)
              .select(col("i_manufact").alias("want_m")).distinct())
    return (t["item"]
            .filter((col("i_manufact_id") >= lit(1))
                    & (col("i_manufact_id") <= lit(1000)))
            .join(styled, col("i_manufact") == col("want_m"),
                  how="leftsemi")
            .select("i_product_name")
            .distinct()
            .sort("i_product_name")
            .limit(100))


def q43(t):
    """Per-store weekday sales pivot for one year."""
    def day(nm):
        return F.sum(F.when(col("d_day_name") == lit(nm),
                            col("ss_sales_price"))
                     .otherwise(lit(None)))

    return (t["store_sales"]
            .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .group_by("s_store_name", "s_store_id")
            .agg(day("Sunday").alias("sun_sales"),
                 day("Monday").alias("mon_sales"),
                 day("Tuesday").alias("tue_sales"),
                 day("Wednesday").alias("wed_sales"),
                 day("Thursday").alias("thu_sales"),
                 day("Friday").alias("fri_sales"),
                 day("Saturday").alias("sat_sales"))
            .sort("s_store_name", "s_store_id")
            .limit(100))


def q44(t):
    """Best and worst performing items by average revenue."""
    perf = (t["store_sales"].filter(col("ss_store_sk") == lit(1))
            .group_by("ss_item_sk")
            .agg(F.avg("ss_net_profit").alias("rank_col")))
    asc = (perf.select(
        col("ss_item_sk").alias("best_sk"),
        F.rank().over(Window.order_by(col("rank_col").asc()))
        .alias("rnk_a")).filter(col("rnk_a") < lit(11)))
    desc = (perf.select(
        col("ss_item_sk").alias("worst_sk"),
        F.rank().over(Window.order_by(col("rank_col").desc()))
        .alias("rnk_d")).filter(col("rnk_d") < lit(11)))
    i1 = t["item"].select(col("i_item_sk").alias("i1_sk"),
                          col("i_product_name").alias("best_performing"))
    i2 = t["item"].select(col("i_item_sk").alias("i2_sk"),
                          col("i_product_name")
                          .alias("worst_performing"))
    return (asc.join(desc, col("rnk_a") == col("rnk_d"))
            .join(i1, col("best_sk") == col("i1_sk"))
            .join(i2, col("worst_sk") == col("i2_sk"))
            .select(col("rnk_a").alias("rnk"), col("best_performing"),
                    col("worst_performing"))
            .sort("rnk"))


def q45(t):
    """Web sales by customer geography for selected zips/items."""
    return (t["web_sales"]
            .join(t["customer"],
                  col("ws_bill_customer_sk") == col("c_customer_sk"))
            .join(t["customer_address"],
                  col("c_current_addr_sk") == col("ca_address_sk"))
            .join(t["date_dim"].filter((col("d_qoy") == lit(2))
                                       & (col("d_year") == lit(2001))),
                  col("ws_sold_date_sk") == col("d_date_sk"))
            .join(t["item"], col("ws_item_sk") == col("i_item_sk"))
            .filter(F.substring(col("ca_zip"), 1, 2)
                    .isin("85", "86", "88", "89", "80", "81", "30",
                          "31", "38", "98")
                    | col("i_item_id").isin(
                        "ITEM000000000002", "ITEM000000000003",
                        "ITEM000000000005", "ITEM000000000007",
                        "ITEM000000000011", "ITEM000000000013",
                        "ITEM000000000017", "ITEM000000000019",
                        "ITEM000000000023", "ITEM000000000029"))
            .group_by("ca_zip", "ca_city")
            .agg(F.sum("ws_sales_price").alias("total"))
            .sort("ca_zip", "ca_city")
            .limit(100))


def q46(t):
    """Ticket amounts for customers buying away from home city."""
    hd = t["household_demographics"].filter(
        (col("hd_dep_count") == lit(4))
        | (col("hd_vehicle_count") == lit(3)))
    sales_ca = t["customer_address"].select(
        col("ca_address_sk").alias("sca_sk"),
        col("ca_city").alias("bought_city"))
    tickets = (t["store_sales"]
               .join(t["date_dim"].filter(
                   col("d_dow").isin(5, 6)
                   & col("d_year").isin(1999, 2000, 2001)),
                   col("ss_sold_date_sk") == col("d_date_sk"))
               .join(t["store"].filter(
                   col("s_city").isin("Midway", "Fairview")),
                   col("ss_store_sk") == col("s_store_sk"))
               .join(hd, col("ss_hdemo_sk") == col("hd_demo_sk"))
               .join(sales_ca, col("ss_addr_sk") == col("sca_sk"))
               .group_by("ss_ticket_number", "ss_customer_sk",
                         "bought_city")
               .agg(F.sum("ss_coupon_amt").alias("amt"),
                    F.sum("ss_net_profit").alias("profit")))
    return (tickets
            .join(t["customer"],
                  col("ss_customer_sk") == col("c_customer_sk"))
            .join(t["customer_address"],
                  col("c_current_addr_sk") == col("ca_address_sk"))
            .filter(col("ca_city") != col("bought_city"))
            .select("c_last_name", "c_first_name", "ca_city",
                    "bought_city", "ss_ticket_number", "amt", "profit")
            .sort(col("c_last_name").asc_nulls_last(),
                  col("c_first_name").asc_nulls_last(),
                  col("ca_city").asc_nulls_last(),
                  col("bought_city").asc_nulls_last(),
                  col("ss_ticket_number").asc())
            .limit(100))


def q47(t):
    """Brand-store monthly sales deviating from the yearly average,
    with lag/lead context (v1_lag/v1_lead self-windows)."""
    base = (t["store_sales"]
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .group_by("i_category", "i_brand", "s_store_name",
                      "s_company_name", "d_year", "d_moy")
            .agg(F.sum("ss_sales_price").alias("sum_sales")))
    part = ["i_category", "i_brand", "s_store_name", "s_company_name"]
    w_avg = Window.partition_by(*part)
    w_seq = Window.partition_by(*part).order_by(col("d_moy").asc())
    v1 = base.select(
        *[col(c) for c in part], col("d_year"), col("d_moy"),
        col("sum_sales"),
        F.avg(col("sum_sales")).over(w_avg).alias("avg_monthly_sales"),
        F.lag(col("sum_sales"), 1).over(w_seq).alias("psum"),
        F.lead(col("sum_sales"), 1).over(w_seq).alias("nsum"))
    return (v1.filter((col("avg_monthly_sales") > lit(0.0))
                      & (F.abs(col("sum_sales")
                               - col("avg_monthly_sales"))
                         / col("avg_monthly_sales") > lit(0.1)))
            .select("i_category", "i_brand", "s_store_name", "d_year",
                    "d_moy", "sum_sales", "avg_monthly_sales", "psum",
                    "nsum")
            .sort((col("sum_sales") - col("avg_monthly_sales")).asc(),
                  col("s_store_name").asc(), col("d_moy").asc())
            .limit(100))


def q48(t):
    """Quantity sum under OR'd demographic/address conditions."""
    cd_ok = ((col("cd_marital_status") == lit("M"))
             & (col("cd_education_status") == lit("4 yr Degree"))
             & (col("ss_sales_price") >= lit(100.0))) | \
            ((col("cd_marital_status") == lit("D"))
             & (col("cd_education_status") == lit("Primary"))
             & (col("ss_sales_price") >= lit(50.0))) | \
            ((col("cd_marital_status") == lit("U"))
             & (col("cd_education_status") == lit("Advanced Degree")))
    ca_ok = (col("ca_state").isin("TX", "OH", "CA")
             | col("ca_state").isin("WA", "NY", "GA"))
    return (t["store_sales"]
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .join(t["customer_demographics"],
                  col("ss_cdemo_sk") == col("cd_demo_sk"))
            .join(t["customer_address"],
                  col("ss_addr_sk") == col("ca_address_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(2001)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .filter(cd_ok & ca_ok)
            .agg(F.sum("ss_quantity").alias("total_quantity")))


def _return_ratio(t, fact, prefix, ret, rprefix):
    """q49 helper: per-item return ratio + ranks for one channel."""
    s = (t[fact]
         .join(t["date_dim"].filter((col("d_year") == lit(2001))
                                    & (col("d_moy") == lit(12)))
               .select(col("d_date_sk").alias(prefix + "_dsk")),
               col(f"{prefix}_sold_date_sk") == col(prefix + "_dsk"))
         .filter(col(f"{prefix}_net_profit") > lit(1.0)))
    if prefix == "ss":
        join_cond = (col("ss_ticket_number") == col(f"{rprefix}_tick")) \
            & (col("ss_item_sk") == col(f"{rprefix}_isk"))
        r = t[ret].select(col("sr_ticket_number").alias("sr_tick"),
                          col("sr_item_sk").alias("sr_isk"),
                          col("sr_return_quantity").alias("ret_qty"),
                          col("sr_return_amt").alias("ret_amt"))
    else:
        join_cond = (col(f"{prefix}_order_number")
                     == col(f"{rprefix}_ord")) \
            & (col(f"{prefix}_item_sk") == col(f"{rprefix}_isk"))
        r = t[ret].select(
            col(f"{rprefix}_order_number").alias(f"{rprefix}_ord"),
            col(f"{rprefix}_item_sk").alias(f"{rprefix}_isk"),
            col(f"{rprefix}_return_quantity").alias("ret_qty"),
            col(f"{rprefix}_return_amt" if rprefix == "wr"
                else f"{rprefix}_return_amount").alias("ret_amt"))
    g = (s.join(r, join_cond, how="left")
         .group_by(f"{prefix}_item_sk")
         .agg(F.sum(F.coalesce(col("ret_qty"), lit(0))
                    .cast("double")).alias("rq"),
              F.sum(col(f"{prefix}_quantity").cast("double"))
              .alias("sq"),
              F.sum(F.coalesce(col("ret_amt"), lit(0.0))).alias("ra"),
              F.sum(col(f"{prefix}_net_paid")).alias("sa")))
    ratio = (col("rq") / col("sq")).alias("return_ratio")
    cratio = (col("ra") / col("sa")).alias("currency_ratio")
    v = g.select(col(f"{prefix}_item_sk").alias("item"), ratio, cratio)
    return (v.select(
        col("item"), col("return_ratio"), col("currency_ratio"),
        F.rank().over(Window.order_by(col("return_ratio").asc()))
        .alias("return_rank"),
        F.rank().over(Window.order_by(col("currency_ratio").asc()))
        .alias("currency_rank"))
        .filter((col("return_rank") <= lit(10))
                | (col("currency_rank") <= lit(10))))


def q49(t):
    """Worst return ratios across the three channels."""
    web = (_return_ratio(t, "web_sales", "ws", "web_returns", "wr")
           .select(lit("web").alias("channel"), col("item"),
                   col("return_ratio"), col("return_rank"),
                   col("currency_rank")))
    cat = (_return_ratio(t, "catalog_sales", "cs", "catalog_returns",
                         "cr")
           .select(lit("catalog").alias("channel"), col("item"),
                   col("return_ratio"), col("return_rank"),
                   col("currency_rank")))
    sto = (_return_ratio(t, "store_sales", "ss", "store_returns", "sr")
           .select(lit("store").alias("channel"), col("item"),
                   col("return_ratio"), col("return_rank"),
                   col("currency_rank")))
    return (web.union(cat).union(sto)
            .sort("channel", "return_rank", "currency_rank", "item")
            .limit(100))


def q50(t):
    """Sale-to-return lag buckets per store."""
    sr = t["store_returns"].select(
        col("sr_ticket_number").alias("r_tick"),
        col("sr_item_sk").alias("r_isk"),
        col("sr_customer_sk").alias("r_csk"),
        col("sr_returned_date_sk").alias("r_dsk"))
    d2 = (t["date_dim"].filter((col("d_year") == lit(2001))
                               & (col("d_moy") == lit(8)))
          .select(col("d_date_sk").alias("d2_sk")))
    lag = col("r_dsk") - col("ss_sold_date_sk")
    return (t["store_sales"]
            .join(sr, (col("ss_ticket_number") == col("r_tick"))
                  & (col("ss_item_sk") == col("r_isk"))
                  & (col("ss_customer_sk") == col("r_csk")))
            .join(d2, col("r_dsk") == col("d2_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .group_by("s_store_name", "s_store_id", "s_city", "s_state",
                      "s_zip")
            .agg(F.sum(F.when(lag <= lit(30), lit(1)).otherwise(lit(0)))
                 .alias("days_30"),
                 F.sum(F.when((lag > lit(30)) & (lag <= lit(60)),
                              lit(1)).otherwise(lit(0)))
                 .alias("days_31_60"),
                 F.sum(F.when((lag > lit(60)) & (lag <= lit(90)),
                              lit(1)).otherwise(lit(0)))
                 .alias("days_61_90"),
                 F.sum(F.when(lag > lit(90), lit(1)).otherwise(lit(0)))
                 .alias("days_over_90"))
            .sort("s_store_name", "s_store_id")
            .limit(100))


def q51(t):
    """Cumulative web vs store revenue crossover per item."""
    wd = (t["web_sales"]
          .join(t["date_dim"].filter((col("d_month_seq") >= lit(120))
                                     & (col("d_month_seq")
                                        <= lit(131))),
                col("ws_sold_date_sk") == col("d_date_sk"))
          .group_by("ws_item_sk", "d_month_seq")
          .agg(F.sum("ws_sales_price").alias("ws_mo"))
          .select(col("ws_item_sk").alias("w_item"),
                  col("d_month_seq").alias("w_mseq"),
                  F.sum(col("ws_mo")).over(
                      Window.partition_by("ws_item_sk")
                      .order_by(col("d_month_seq").asc())
                      .rows_between(Window.unbounded_preceding,
                                    Window.current_row))
                  .alias("web_cumulative")))
    sd = (t["store_sales"]
          .join(t["date_dim"].filter((col("d_month_seq") >= lit(120))
                                     & (col("d_month_seq")
                                        <= lit(131)))
                .select(col("d_date_sk").alias("sd_sk"),
                        col("d_month_seq").alias("s_mseq0")),
                col("ss_sold_date_sk") == col("sd_sk"))
          .group_by("ss_item_sk", "s_mseq0")
          .agg(F.sum("ss_sales_price").alias("ss_mo"))
          .select(col("ss_item_sk").alias("s_item"),
                  col("s_mseq0").alias("s_mseq"),
                  F.sum(col("ss_mo")).over(
                      Window.partition_by("ss_item_sk")
                      .order_by(col("s_mseq0").asc())
                      .rows_between(Window.unbounded_preceding,
                                    Window.current_row))
                  .alias("store_cumulative")))
    return (wd.join(sd, (col("w_item") == col("s_item"))
                    & (col("w_mseq") == col("s_mseq")))
            .filter(col("web_cumulative") > col("store_cumulative"))
            .select(col("w_item").alias("item_sk"),
                    col("w_mseq").alias("d_month_seq"),
                    col("web_cumulative"), col("store_cumulative"))
            .sort("item_sk", "d_month_seq")
            .limit(100))


def q53(t):
    """Manufacturer quarterly sales vs their average (iceberg)."""
    base = (t["store_sales"]
            .join(t["item"].filter(col("i_class").isin(
                "class01", "class02", "class03")),
                col("ss_item_sk") == col("i_item_sk"))
            .join(t["date_dim"].filter(col("d_month_seq").isin(
                *range(120, 132))),
                col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .group_by("i_manufact_id", "d_qoy")
            .agg(F.sum("ss_sales_price").alias("sum_sales")))
    v = base.select(
        col("i_manufact_id"), col("sum_sales"),
        F.avg(col("sum_sales")).over(
            Window.partition_by("i_manufact_id"))
        .alias("avg_quarterly_sales"))
    return (v.filter((col("avg_quarterly_sales") > lit(0.0))
                     & (F.abs(col("sum_sales")
                              - col("avg_quarterly_sales"))
                        / col("avg_quarterly_sales") > lit(0.1)))
            .sort(col("avg_quarterly_sales").asc(),
                  col("sum_sales").asc(), col("i_manufact_id").asc())
            .limit(100))


def q54(t):
    """Store revenue segments for cross-channel month customers."""
    month = (t["date_dim"].filter(col("d_moy").isin(11, 12)
                                  & (col("d_year") == lit(1998)))
             .select(col("d_date_sk").alias("m_dsk")))
    cs = (t["catalog_sales"]
          .select(col("cs_sold_date_sk").alias("sold_dsk"),
                  col("cs_item_sk").alias("sold_isk"),
                  col("cs_bill_customer_sk").alias("sold_csk")))
    ws = (t["web_sales"]
          .select(col("ws_sold_date_sk").alias("sold_dsk"),
                  col("ws_item_sk").alias("sold_isk"),
                  col("ws_bill_customer_sk").alias("sold_csk")))
    my_customers = (cs.union(ws)
                    .join(month, col("sold_dsk") == col("m_dsk"))
                    .join(t["item"].filter(
                        col("i_category") == lit("Women")),
                        col("sold_isk") == col("i_item_sk"))
                    .select(col("sold_csk").alias("my_csk"))
                    .distinct())
    revenue = (t["store_sales"]
               .join(my_customers,
                     col("ss_customer_sk") == col("my_csk"),
                     how="leftsemi")
               .join(t["date_dim"].filter(
                   (col("d_moy") <= lit(6))
                   & (col("d_year") == lit(1999))),
                   col("ss_sold_date_sk") == col("d_date_sk"))
               .group_by("ss_customer_sk")
               .agg(F.sum("ss_ext_sales_price").alias("revenue")))
    seg = (revenue.select(
        (F.floor(col("revenue") / lit(50.0))).cast("int")
        .alias("segment")))
    return (seg.group_by("segment")
            .agg(F.count("*").alias("num_customers"))
            .select(col("segment"), col("num_customers"),
                    (col("segment") * lit(50)).alias("segment_base"))
            .sort("segment", "num_customers")
            .limit(100))


def q56(t):
    """Per-item-id revenue across channels for colored items."""
    from spark_rapids_tpu_torch.bench.tpcds_queries_a import _by_manufact  # noqa
    wanted = (t["item"].filter(col("i_color").isin(
        "red", "blue", "green", "navy"))
        .select(col("i_item_id").alias("want_id")).distinct())

    def chan(fact, date_k, item_k, addr_k, price):
        return (t[fact]
                .join(t["date_dim"].filter(
                    (col("d_year") == lit(2000))
                    & (col("d_moy") == lit(2)))
                    .select(col("d_date_sk").alias(fact + "_dsk")),
                    col(date_k) == col(fact + "_dsk"))
                .join(t["customer_address"].filter(
                    col("ca_gmt_offset") == lit(-5.0))
                    .select(col("ca_address_sk").alias(fact + "_csk")),
                    col(addr_k) == col(fact + "_csk"))
                .join(t["item"], col(item_k) == col("i_item_sk"))
                .join(wanted, col("i_item_id") == col("want_id"),
                      how="leftsemi")
                .group_by("i_item_id")
                .agg(F.sum(price).alias("total_sales")))

    ss = chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
              "ss_addr_sk", col("ss_ext_sales_price"))
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
              "cs_bill_addr_sk", col("cs_ext_sales_price"))
    ws = chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
              "ws_bill_addr_sk", col("ws_ext_sales_price"))
    return (ss.union(cs).union(ws)
            .group_by("i_item_id")
            .agg(F.sum("total_sales").alias("total_sales"))
            .sort(col("total_sales").asc(), col("i_item_id").asc())
            .limit(100))


def q57(t):
    """q47 for the catalog channel (call centers)."""
    base = (t["catalog_sales"]
            .join(t["item"], col("cs_item_sk") == col("i_item_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                  col("cs_sold_date_sk") == col("d_date_sk"))
            .join(t["call_center"],
                  col("cs_call_center_sk") == col("cc_call_center_sk"))
            .group_by("i_category", "i_brand", "cc_name", "d_year",
                      "d_moy")
            .agg(F.sum("cs_sales_price").alias("sum_sales")))
    part = ["i_category", "i_brand", "cc_name"]
    v1 = base.select(
        *[col(c) for c in part], col("d_year"), col("d_moy"),
        col("sum_sales"),
        F.avg(col("sum_sales")).over(Window.partition_by(*part))
        .alias("avg_monthly_sales"),
        F.lag(col("sum_sales"), 1).over(
            Window.partition_by(*part).order_by(col("d_moy").asc()))
        .alias("psum"),
        F.lead(col("sum_sales"), 1).over(
            Window.partition_by(*part).order_by(col("d_moy").asc()))
        .alias("nsum"))
    return (v1.filter((col("avg_monthly_sales") > lit(0.0))
                      & (F.abs(col("sum_sales")
                               - col("avg_monthly_sales"))
                         / col("avg_monthly_sales") > lit(0.1)))
            .sort((col("sum_sales") - col("avg_monthly_sales")).asc(),
                  col("cc_name").asc(), col("d_moy").asc())
            .limit(100))


def q58(t):
    """Items with balanced revenue across all three channels in one
    period (Like-delta: month grain and a +/-50%% band — dbgen-lite's
    per-week per-channel item overlap is too sparse for the spec's
    single week / 10%% band)."""
    week = (t["date_dim"].filter(col("d_month_seq") == lit(110))
            .select(col("d_date_sk").alias("wk_dsk")))

    def chan(fact, date_k, item_k, price, nm):
        return (t[fact]
                .join(week, col(date_k) == col("wk_dsk"))
                .join(t["item"], col(item_k) == col("i_item_sk"))
                .group_by("i_item_id")
                .agg(F.sum(price).alias(nm))
                .select(col("i_item_id").alias(nm + "_id"), col(nm)))

    ss = chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
              col("ss_ext_sales_price"), "ss_rev")
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
              col("cs_ext_sales_price"), "cs_rev")
    ws = chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
              col("ws_ext_sales_price"), "ws_rev")
    j = (ss.join(cs, col("ss_rev_id") == col("cs_rev_id"))
         .join(ws, col("ss_rev_id") == col("ws_rev_id")))
    avg3 = ((col("ss_rev") + col("cs_rev") + col("ws_rev"))
            / lit(3.0))
    lo, hi = avg3 * lit(0.5), avg3 * lit(1.5)
    return (j.filter((col("ss_rev") >= lo) & (col("ss_rev") <= hi)
                     & (col("cs_rev") >= lo) & (col("cs_rev") <= hi)
                     & (col("ws_rev") >= lo) & (col("ws_rev") <= hi))
            .select(col("ss_rev_id").alias("item_id"), col("ss_rev"),
                    col("cs_rev"), col("ws_rev"))
            .sort("item_id", "ss_rev")
            .limit(100))


def q59(t):
    """Store weekly sales year-over-year by weekday."""
    def day(nm):
        return F.sum(F.when(col("d_day_name") == lit(nm),
                            col("ss_sales_price"))
                     .otherwise(lit(None)))

    wss = (t["store_sales"]
           .join(t["date_dim"],
                 col("ss_sold_date_sk") == col("d_date_sk"))
           .group_by("d_week_seq", "ss_store_sk")
           .agg(day("Sunday").alias("sun_sales"),
                day("Monday").alias("mon_sales"),
                day("Tuesday").alias("tue_sales"),
                day("Wednesday").alias("wed_sales"),
                day("Thursday").alias("thu_sales"),
                day("Friday").alias("fri_sales"),
                day("Saturday").alias("sat_sales")))
    d = t["date_dim"].select("d_week_seq", "d_month_seq").distinct()
    y1 = (wss.join(d.filter((col("d_month_seq") >= lit(120))
                            & (col("d_month_seq") <= lit(131))),
                   on="d_week_seq")
          .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
          .select(col("s_store_name").alias("name1"),
                  col("s_store_id").alias("id1"),
                  col("d_week_seq").alias("wseq1"),
                  *[col(c).alias(c + "1")
                    for c in ["sun_sales", "mon_sales", "tue_sales",
                              "wed_sales", "thu_sales", "fri_sales",
                              "sat_sales"]]))
    y2 = (wss.join(d.filter((col("d_month_seq") >= lit(132))
                            & (col("d_month_seq") <= lit(143)))
                   .select(col("d_week_seq").alias("dw2"),
                           col("d_month_seq").alias("dm2")),
                   col("d_week_seq") == col("dw2"))
          .join(t["store"].select(col("s_store_sk").alias("ssk2"),
                                  col("s_store_id").alias("id2")),
                col("ss_store_sk") == col("ssk2"))
          .select(col("id2"), (col("dw2") - lit(52)).alias("wseq2"),
                  *[col(c).alias(c + "2")
                    for c in ["sun_sales", "mon_sales", "tue_sales",
                              "wed_sales", "thu_sales", "fri_sales",
                              "sat_sales"]]))
    j = y1.join(y2, (col("id1") == col("id2"))
                & (col("wseq1") == col("wseq2")))
    return (j.select(
        col("name1"), col("wseq1"),
        (col("sun_sales1") / col("sun_sales2")).alias("sun_r"),
        (col("mon_sales1") / col("mon_sales2")).alias("mon_r"),
        (col("tue_sales1") / col("tue_sales2")).alias("tue_r"),
        (col("wed_sales1") / col("wed_sales2")).alias("wed_r"),
        (col("thu_sales1") / col("thu_sales2")).alias("thu_r"),
        (col("fri_sales1") / col("fri_sales2")).alias("fri_r"),
        (col("sat_sales1") / col("sat_sales2")).alias("sat_r"))
        .sort("name1", "wseq1")
        .limit(100))


def q60(t):
    """Per-item-id revenue across channels for one category."""
    wanted = (t["item"].filter(col("i_category") == lit("Music"))
              .select(col("i_item_id").alias("want_id")).distinct())

    def chan(fact, date_k, item_k, addr_k, price):
        return (t[fact]
                .join(t["date_dim"].filter(
                    (col("d_year") == lit(1998))
                    & (col("d_moy") == lit(9)))
                    .select(col("d_date_sk").alias(fact + "_dsk")),
                    col(date_k) == col(fact + "_dsk"))
                .join(t["customer_address"].filter(
                    col("ca_gmt_offset") == lit(-5.0))
                    .select(col("ca_address_sk").alias(fact + "_csk")),
                    col(addr_k) == col(fact + "_csk"))
                .join(t["item"], col(item_k) == col("i_item_sk"))
                .join(wanted, col("i_item_id") == col("want_id"),
                      how="leftsemi")
                .group_by("i_item_id")
                .agg(F.sum(price).alias("total_sales")))

    ss = chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
              "ss_addr_sk", col("ss_ext_sales_price"))
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
              "cs_bill_addr_sk", col("cs_ext_sales_price"))
    ws = chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
              "ws_bill_addr_sk", col("ws_ext_sales_price"))
    return (ss.union(cs).union(ws)
            .group_by("i_item_id")
            .agg(F.sum("total_sales").alias("total_sales"))
            .sort("i_item_id", "total_sales")
            .limit(100))


def q61(t):
    """Promotional to total revenue ratio for a category/month."""
    base = (t["store_sales"]
            .join(t["date_dim"].filter((col("d_year") == lit(1998))
                                       & (col("d_moy") == lit(11))),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"].filter(col("s_gmt_offset") == lit(-5.0)),
                  col("ss_store_sk") == col("s_store_sk"))
            .join(t["item"].filter(col("i_category") == lit("Jewelry")),
                  col("ss_item_sk") == col("i_item_sk"))
            .join(t["customer"],
                  col("ss_customer_sk") == col("c_customer_sk"))
            .join(t["customer_address"].filter(
                col("ca_gmt_offset") == lit(-5.0)),
                col("c_current_addr_sk") == col("ca_address_sk")))
    promos = (base.join(t["promotion"].filter(
        (col("p_channel_dmail") == lit("Y"))
        | (col("p_channel_email") == lit("Y"))
        | (col("p_channel_tv") == lit("Y"))),
        col("ss_promo_sk") == col("p_promo_sk"))
        .agg(F.sum("ss_ext_sales_price").alias("promotions")))
    total = base.agg(F.sum("ss_ext_sales_price").alias("total"))
    return (promos.crossJoin(total)
            .select(col("promotions"), col("total"),
                    (col("promotions").cast("double")
                     / col("total").cast("double") * lit(100.0))
                    .alias("pct")))


def q62(t):
    """Web shipping-lag day buckets by site/ship mode/warehouse."""
    lag = col("ws_ship_date_sk") - col("ws_sold_date_sk")
    return (t["web_sales"]
            .join(t["date_dim"].filter((col("d_month_seq") >= lit(120))
                                       & (col("d_month_seq")
                                          <= lit(131))),
                  col("ws_ship_date_sk") == col("d_date_sk"))
            .join(t["web_site"],
                  col("ws_web_site_sk") == col("web_site_sk"))
            .join(t["ship_mode"],
                  col("ws_ship_mode_sk") == col("sm_ship_mode_sk"))
            .join(t["warehouse"],
                  col("ws_warehouse_sk") == col("w_warehouse_sk"))
            .group_by("w_warehouse_name", "sm_type", "web_name")
            .agg(F.sum(F.when(lag <= lit(30), lit(1)).otherwise(lit(0)))
                 .alias("days_30"),
                 F.sum(F.when((lag > lit(30)) & (lag <= lit(60)),
                              lit(1)).otherwise(lit(0)))
                 .alias("days_31_60"),
                 F.sum(F.when((lag > lit(60)) & (lag <= lit(90)),
                              lit(1)).otherwise(lit(0)))
                 .alias("days_61_90"),
                 F.sum(F.when((lag > lit(90)) & (lag <= lit(120)),
                              lit(1)).otherwise(lit(0)))
                 .alias("days_91_120"),
                 F.sum(F.when(lag > lit(120), lit(1))
                       .otherwise(lit(0))).alias("days_over_120"))
            .sort(col("w_warehouse_name").asc_nulls_last(),
                  col("sm_type").asc(), col("web_name").asc())
            .limit(100))


def q63(t):
    """Manager monthly sales vs average (q53 by manager)."""
    base = (t["store_sales"]
            .join(t["item"].filter(col("i_class").isin(
                "class01", "class02", "class03", "class04")),
                col("ss_item_sk") == col("i_item_sk"))
            .join(t["date_dim"].filter(col("d_month_seq").isin(
                *range(120, 132))),
                col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .group_by("i_manager_id", "d_moy")
            .agg(F.sum("ss_sales_price").alias("sum_sales")))
    v = base.select(
        col("i_manager_id"), col("sum_sales"),
        F.avg(col("sum_sales")).over(
            Window.partition_by("i_manager_id"))
        .alias("avg_monthly_sales"))
    return (v.filter((col("avg_monthly_sales") > lit(0.0))
                     & (F.abs(col("sum_sales")
                              - col("avg_monthly_sales"))
                        / col("avg_monthly_sales") > lit(0.1)))
            .sort("i_manager_id", col("avg_monthly_sales").asc(),
                  col("sum_sales").asc())
            .limit(100))


def q64(t):
    """Cross-channel repurchase chain with demographics (lite)."""
    cs_deals = (t["catalog_sales"]
                .join(t["catalog_returns"].select(
                    col("cr_order_number").alias("cr_o"),
                    col("cr_item_sk").alias("cr_i"),
                    col("cr_refunded_cash").alias("cr_cash")),
                    (col("cs_order_number") == col("cr_o"))
                    & (col("cs_item_sk") == col("cr_i")))
                .group_by("cs_item_sk")
                .agg(F.sum(col("cs_ext_list_price")).alias("sale"),
                     F.sum(col("cr_cash")).alias("refund"))
                .filter(col("sale") > lit(2.0) * col("refund"))
                .select(col("cs_item_sk").alias("deal_sk")))
    cross = (t["store_sales"]
             .join(t["store_returns"],
                   (col("ss_ticket_number") == col("sr_ticket_number"))
                   & (col("ss_item_sk") == col("sr_item_sk")))
             .join(cs_deals, col("ss_item_sk") == col("deal_sk"),
                   how="leftsemi")
             .join(t["date_dim"],
                   col("ss_sold_date_sk") == col("d_date_sk"))
             .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
             .join(t["item"].filter(col("i_color").isin(
                 "red", "blue", "green", "white", "black", "ivory")),
                 col("ss_item_sk") == col("i_item_sk"))
             .join(t["customer"],
                   col("ss_customer_sk") == col("c_customer_sk"))
             .join(t["household_demographics"],
                   col("c_current_hdemo_sk") == col("hd_demo_sk"))
             .join(t["income_band"],
                   col("hd_income_band_sk")
                   == col("ib_income_band_sk")))
    return (cross.group_by("i_product_name", "i_item_sk",
                           "s_store_name", "s_zip", "d_year")
            .agg(F.count("*").alias("cnt"),
                 F.sum("ss_wholesale_cost").alias("s1"),
                 F.sum("ss_list_price").alias("s2"),
                 F.sum("ss_coupon_amt").alias("s3"))
            .sort("i_product_name", "i_item_sk", "s_store_name",
                  "d_year")
            .limit(100))


def q65(t):
    """Store items selling at <= 10% of the store-average revenue."""
    sales = (t["store_sales"]
             .join(t["date_dim"].filter(
                 (col("d_month_seq") >= lit(120))
                 & (col("d_month_seq") <= lit(131))),
                 col("ss_sold_date_sk") == col("d_date_sk"))
             .group_by("ss_store_sk", "ss_item_sk")
             .agg(F.sum("ss_sales_price").alias("revenue")))
    avg_rev = (sales.group_by("ss_store_sk")
               .agg((F.avg("revenue") * lit(0.1)).alias("thr"))
               .select(col("ss_store_sk").alias("avg_ssk"),
                       col("thr")))
    return (sales
            .join(avg_rev, col("ss_store_sk") == col("avg_ssk"))
            .filter(col("revenue") <= col("thr"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .select("s_store_name", "i_item_desc", "revenue",
                    "i_current_price", "i_wholesale_cost", "i_brand")
            .sort(col("s_store_name").asc(),
                  col("i_item_desc").asc_nulls_last())
            .limit(100))


def q66(t):
    """Warehouse monthly shipping pivot for web+catalog, by time-of-day
    halves."""
    half = lit(43200)

    def chan(fact, prefix, qty, price):
        date_k = f"{prefix}_sold_date_sk"
        time_k = f"{prefix}_sold_time_sk"
        ship_k = f"{prefix}_ship_mode_sk"
        wh_k = f"{prefix}_warehouse_sk"
        night = F.sum(F.when(col("t_time") <= half,
                             price * qty.cast("double"))
                      .otherwise(lit(0.0)))
        day_ = F.sum(F.when(col("t_time") > half,
                            price * qty.cast("double"))
                     .otherwise(lit(0.0)))
        return (t[fact]
                .join(t["date_dim"].filter(col("d_year") == lit(2001))
                      .select(col("d_date_sk").alias(fact + "_dsk"),
                              col("d_moy").alias(fact + "_moy")),
                      col(date_k) == col(fact + "_dsk"))
                .join(t["time_dim"],
                      col(time_k) == col("t_time_sk"))
                .join(t["ship_mode"].filter(
                    col("sm_carrier").isin("UPS", "FEDEX"))
                    .select(col("sm_ship_mode_sk")
                            .alias(fact + "_smsk")),
                    col(ship_k) == col(fact + "_smsk"))
                .join(t["warehouse"],
                      col(wh_k) == col("w_warehouse_sk"))
                .group_by("w_warehouse_name", "w_warehouse_sq_ft",
                          "w_city", "w_county", "w_state", "w_country",
                          fact + "_moy")
                .agg(night.alias("night_val"), day_.alias("day_val"))
                .select(col("w_warehouse_name"),
                        col("w_warehouse_sq_ft"), col("w_city"),
                        col("w_county"), col("w_state"),
                        col("w_country"),
                        col(fact + "_moy").alias("moy"),
                        col("night_val"), col("day_val")))

    ws = chan("web_sales", "ws", col("ws_quantity"),
              col("ws_ext_sales_price"))
    cs = chan("catalog_sales", "cs", col("cs_quantity"),
              col("cs_ext_sales_price"))
    return (ws.union(cs)
            .group_by("w_warehouse_name", "w_warehouse_sq_ft", "w_city",
                      "w_county", "w_state", "w_country", "moy")
            .agg(F.sum("night_val").alias("night_total"),
                 F.sum("day_val").alias("day_total"))
            .sort(col("w_warehouse_name").asc_nulls_last(), col("moy"))
            .limit(100))
