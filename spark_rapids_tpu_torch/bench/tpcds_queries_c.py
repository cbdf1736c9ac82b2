"""TpcdsLike queries q67-q99 (DataFrame form).

Ported whole from ``spark_rapids_tpu/bench/tpcds_queries_c.py`` with its
imports retargeted at the port's ``col``, ``functions`` and ``Window``.

Reference analog: integration_tests/.../tests/tpcds/TpcdsLikeSpark.scala.
Same rewrite conventions as tpcds_queries_a.py.
"""

from __future__ import annotations

import datetime as _dt

from spark_rapids_tpu_torch.api.column import col, lit
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window

from spark_rapids_tpu_torch.bench.tpcds_queries_a import _d, _year_total


def q67(t):
    """Top items per category by rolled-up sales with rank window."""
    base = (t["store_sales"]
            .join(t["date_dim"].filter(
                (col("d_month_seq") >= lit(120))
                & (col("d_month_seq") <= lit(131))),
                col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk")))
    val = F.coalesce(col("ss_sales_price")
                     * col("ss_quantity").cast("double"), lit(0.0))
    full = (base.group_by("i_category", "i_class", "i_brand",
                          "i_product_name", "d_year", "d_qoy", "d_moy",
                          "s_store_id")
            .agg(F.sum(val).alias("sumsales")))
    cat = (base.group_by("i_category")
           .agg(F.sum(val).alias("sumsales"))
           .select(col("i_category"),
                   lit(None).cast("string").alias("i_class"),
                   lit(None).cast("string").alias("i_brand"),
                   lit(None).cast("string").alias("i_product_name"),
                   lit(None).cast("int").alias("d_year"),
                   lit(None).cast("int").alias("d_qoy"),
                   lit(None).cast("int").alias("d_moy"),
                   lit(None).cast("string").alias("s_store_id"),
                   col("sumsales")))
    u = full.select("i_category", "i_class", "i_brand",
                    "i_product_name", "d_year", "d_qoy", "d_moy",
                    "s_store_id", "sumsales").union(cat)
    rk = F.rank().over(Window.partition_by("i_category")
                       .order_by(col("sumsales").desc()))
    return (u.select("i_category", "i_class", "i_brand",
                     "i_product_name", "d_year", "d_qoy", "d_moy",
                     "s_store_id", "sumsales", rk.alias("rk"))
            .filter(col("rk") <= lit(100))
            .sort(col("i_category").asc_nulls_last(),
                  col("rk").asc(), col("sumsales").desc())
            .limit(100))


def q69(t):
    """Demographics of store customers inactive on web+catalog."""
    dd = t["date_dim"].filter((col("d_year") == lit(2001))
                              & (col("d_moy") >= lit(4))
                              & (col("d_moy") <= lit(6)))
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
         .join(t["customer_address"].filter(
             col("ca_state").isin("CA", "TX", "NY", "OH", "WA", "GA")),
             col("c_current_addr_sk") == col("ca_address_sk"))
         .join(ss_c, col("c_customer_sk") == col("act_sk"),
               how="leftsemi")
         .join(ws_c, col("c_customer_sk") == col("act_sk"),
               how="leftanti")
         .join(cs_c, col("c_customer_sk") == col("act_sk"),
               how="leftanti")
         .join(t["customer_demographics"],
               col("c_current_cdemo_sk") == col("cd_demo_sk")))
    return (c.group_by("cd_gender", "cd_marital_status",
                       "cd_education_status", "cd_purchase_estimate",
                       "cd_credit_rating")
            .agg(F.count("*").alias("cnt1"))
            .sort("cd_gender", "cd_marital_status",
                  "cd_education_status", "cd_purchase_estimate",
                  "cd_credit_rating")
            .limit(100))


def q70(t):
    """Store net profit rollup over state/county for top-5 states."""
    base = (t["store_sales"]
            .join(t["date_dim"].filter(
                (col("d_month_seq") >= lit(120))
                & (col("d_month_seq") <= lit(131))),
                col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk")))
    state_rank = (base.group_by("s_state")
                  .agg(F.sum("ss_net_profit").alias("sp"))
                  .select(col("s_state").alias("rank_state"),
                          F.rank().over(
                              Window.order_by(col("sp").desc()))
                          .alias("r"))
                  .filter(col("r") <= lit(5)))
    top = base.join(state_rank, col("s_state") == col("rank_state"),
                    how="leftsemi")
    lvl2 = (top.group_by("s_state", "s_county")
            .agg(F.sum("ss_net_profit").alias("total_sum"))
            .select("total_sum", "s_state", "s_county",
                    lit(0).alias("lochierarchy")))
    lvl1 = (top.group_by("s_state")
            .agg(F.sum("ss_net_profit").alias("total_sum"))
            .select(col("total_sum"), col("s_state"),
                    lit(None).cast("string").alias("s_county"),
                    lit(1).alias("lochierarchy")))
    lvl0 = (top.agg(F.sum("ss_net_profit").alias("total_sum"))
            .select(col("total_sum"),
                    lit(None).cast("string").alias("s_state"),
                    lit(None).cast("string").alias("s_county"),
                    lit(2).alias("lochierarchy")))
    u = lvl2.union(lvl1).union(lvl0)
    rk = F.rank().over(Window.partition_by("lochierarchy")
                       .order_by(col("total_sum").desc()))
    return (u.select("total_sum", "s_state", "s_county", "lochierarchy",
                     rk.alias("rank_within_parent"))
            .sort(col("lochierarchy").desc(),
                  col("s_state").asc_nulls_last(),
                  col("rank_within_parent").asc())
            .limit(100))


def q71(t):
    """Brand revenue by meal-time hour across all three channels."""
    def chan(fact, prefix):
        return (t[fact]
                .join(t["date_dim"].filter(
                    (col("d_moy") == lit(11))
                    & (col("d_year") == lit(1999)))
                    .select(col("d_date_sk").alias(fact + "_dsk")),
                    col(f"{prefix}_sold_date_sk") == col(fact + "_dsk"))
                .select(col(f"{prefix}_ext_sales_price")
                        .alias("ext_price"),
                        col(f"{prefix}_item_sk").alias("sold_item_sk"),
                        col(f"{prefix}_sold_time_sk")
                        .alias("time_sk")))

    u = (chan("web_sales", "ws")
         .union(chan("catalog_sales", "cs"))
         .union(chan("store_sales", "ss")))
    return (u.join(t["item"].filter(col("i_manager_id") == lit(1)),
                   col("sold_item_sk") == col("i_item_sk"))
            .join(t["time_dim"].filter(
                col("t_meal_time").isin("breakfast", "dinner")),
                col("time_sk") == col("t_time_sk"))
            .group_by("i_brand_id", "i_brand", "t_hour", "t_minute")
            .agg(F.sum("ext_price").alias("ext_price"))
            .sort(col("ext_price").desc(), col("i_brand_id").asc(),
                  col("t_hour").asc())
            .limit(100))


def q72(t):
    """Catalog orders where inventory ran short, by item/warehouse."""
    d1 = (t["date_dim"].filter(col("d_year") == lit(2000))
          .select(col("d_date_sk").alias("d1_sk"),
                  col("d_week_seq").alias("d1_week"),
                  col("d_date").alias("d1_date")))
    d2 = t["date_dim"].select(col("d_date_sk").alias("d2_sk"),
                              col("d_week_seq").alias("d2_week"))
    d3 = t["date_dim"].select(col("d_date_sk").alias("d3_sk"),
                              col("d_date").alias("d3_date"))
    return (t["catalog_sales"]
            .join(t["household_demographics"].filter(
                col("hd_buy_potential") == lit(">10000")),
                col("cs_bill_hdemo_sk") == col("hd_demo_sk"))
            .join(d1, col("cs_sold_date_sk") == col("d1_sk"))
            .join(t["inventory"],
                  col("cs_item_sk") == col("inv_item_sk"))
            .join(d2, (col("inv_date_sk") == col("d2_sk")))
            .filter((col("d1_week") == col("d2_week"))
                    & (col("inv_quantity_on_hand") < col("cs_quantity")))
            .join(t["warehouse"],
                  col("inv_warehouse_sk") == col("w_warehouse_sk"))
            .join(d3, col("cs_ship_date_sk") == col("d3_sk"))
            .join(t["item"], col("cs_item_sk") == col("i_item_sk"))
            .group_by("i_item_desc", "w_warehouse_name", "d1_week")
            .agg(F.count("*").alias("no_promo"))
            .sort(col("no_promo").desc(), col("i_item_desc").asc(),
                  col("w_warehouse_name").asc_nulls_last(),
                  col("d1_week").asc())
            .limit(100))


def q74(t):
    """Customers with web growth above store growth (quantity q11)."""
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


def q75(t):
    """Sales net of returns per brand/year; shrinking brands."""
    def chan(fact, prefix, ret, rpre, ret_amt):
        r = t[ret].select(
            col(f"{rpre}_order_number" if rpre != "sr"
                else "sr_ticket_number").alias("r_ord"),
            col(f"{rpre}_item_sk").alias("r_isk"),
            col(f"{rpre}_return_quantity").alias("r_qty"),
            col(ret_amt).alias("r_amt"))
        ord_k = f"{prefix}_order_number" if prefix != "ss" \
            else "ss_ticket_number"
        return (t[fact]
                .join(t["item"].filter(
                    col("i_category") == lit("Electronics")),
                    col(f"{prefix}_item_sk") == col("i_item_sk"))
                .join(t["date_dim"]
                      .select(col("d_date_sk").alias(fact + "_dsk"),
                              col("d_year").alias(fact + "_year")),
                      col(f"{prefix}_sold_date_sk")
                      == col(fact + "_dsk"))
                .join(r, (col(ord_k) == col("r_ord"))
                      & (col(f"{prefix}_item_sk") == col("r_isk")),
                      how="left")
                .select(col(fact + "_year").alias("d_year"),
                        col("i_brand_id"),
                        (col(f"{prefix}_quantity")
                         - F.coalesce(col("r_qty"), lit(0)))
                        .alias("sales_cnt"),
                        (col(f"{prefix}_ext_sales_price")
                         - F.coalesce(col("r_amt"), lit(0.0)))
                        .alias("sales_amt")))

    u = (chan("catalog_sales", "cs", "catalog_returns", "cr",
              "cr_return_amount")
         .union(chan("store_sales", "ss", "store_returns", "sr",
                     "sr_return_amt"))
         .union(chan("web_sales", "ws", "web_returns", "wr",
                     "wr_return_amt")))
    year_tot = (u.group_by("d_year", "i_brand_id")
                .agg(F.sum("sales_cnt").alias("sales_cnt"),
                     F.sum("sales_amt").alias("sales_amt")))
    cur = (year_tot.filter(col("d_year") == lit(2002))
           .select(col("i_brand_id").alias("b_cur"),
                   col("sales_cnt").alias("cnt_cur"),
                   col("sales_amt").alias("amt_cur")))
    prev = (year_tot.filter(col("d_year") == lit(2001))
            .select(col("i_brand_id").alias("b_prev"),
                    col("sales_cnt").alias("cnt_prev"),
                    col("sales_amt").alias("amt_prev")))
    return (cur.join(prev, col("b_cur") == col("b_prev"))
            .filter(col("cnt_cur").cast("double")
                    / col("cnt_prev").cast("double") < lit(0.9))
            .select(col("b_cur").alias("i_brand_id"), col("cnt_prev"),
                    col("cnt_cur"), col("amt_prev"), col("amt_cur"))
            .sort((col("cnt_cur") - col("cnt_prev")).asc(),
                  col("i_brand_id").asc())
            .limit(100))


def q76(t):
    """Sales rows with null keys per channel/year/quarter/category."""
    ss = (t["store_sales"].filter(F.isnull(col("ss_addr_sk")))
          .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
          .join(t["date_dim"],
                col("ss_sold_date_sk") == col("d_date_sk"))
          .select(lit("store").alias("channel"),
                  lit("ss_addr_sk").alias("col_name"), col("d_year"),
                  col("d_qoy"), col("i_category"),
                  col("ss_ext_sales_price").alias("ext_sales_price")))
    ws = (t["web_sales"].filter(F.isnull(col("ws_ship_customer_sk")))
          .join(t["item"].select(col("i_item_sk").alias("wi_sk"),
                                 col("i_category").alias("wi_cat")),
                col("ws_item_sk") == col("wi_sk"))
          .join(t["date_dim"].select(col("d_date_sk").alias("wd_sk"),
                                     col("d_year").alias("w_year"),
                                     col("d_qoy").alias("w_qoy")),
                col("ws_sold_date_sk") == col("wd_sk"))
          .select(lit("web").alias("channel"),
                  lit("ws_ship_customer_sk").alias("col_name"),
                  col("w_year").alias("d_year"),
                  col("w_qoy").alias("d_qoy"),
                  col("wi_cat").alias("i_category"),
                  col("ws_ext_sales_price").alias("ext_sales_price")))
    cs = (t["catalog_sales"].filter(F.isnull(col("cs_ship_addr_sk")))
          .join(t["item"].select(col("i_item_sk").alias("ci_sk"),
                                 col("i_category").alias("ci_cat")),
                col("cs_item_sk") == col("ci_sk"))
          .join(t["date_dim"].select(col("d_date_sk").alias("cd_sk"),
                                     col("d_year").alias("c_year"),
                                     col("d_qoy").alias("c_qoy")),
                col("cs_sold_date_sk") == col("cd_sk"))
          .select(lit("catalog").alias("channel"),
                  lit("cs_ship_addr_sk").alias("col_name"),
                  col("c_year").alias("d_year"),
                  col("c_qoy").alias("d_qoy"),
                  col("ci_cat").alias("i_category"),
                  col("cs_ext_sales_price").alias("ext_sales_price")))
    return (ss.union(ws).union(cs)
            .group_by("channel", "col_name", "d_year", "d_qoy",
                      "i_category")
            .agg(F.count("*").alias("sales_cnt"),
                 F.sum("ext_sales_price").alias("sales_amt"))
            .sort("channel", "col_name", "d_year", "d_qoy",
                  "i_category")
            .limit(100))


def q77(t):
    """Per-channel sales & returns totals with channel rollup."""
    dd = t["date_dim"].filter((col("d_date") >= _d(2000, 8, 3))
                              & (col("d_date") <= _d(2000, 10, 2)))

    ss = (t["store_sales"]
          .join(dd.select("d_date_sk"),
                col("ss_sold_date_sk") == col("d_date_sk"))
          .group_by("ss_store_sk")
          .agg(F.sum("ss_ext_sales_price").alias("sales"),
               F.sum("ss_net_profit").alias("profit"))
          .select(lit("store channel").alias("channel"),
                  col("ss_store_sk").cast("bigint").alias("id"),
                  col("sales"), col("profit")))
    sr = (t["store_returns"]
          .join(dd.select(col("d_date_sk").alias("srd_sk")),
                col("sr_returned_date_sk") == col("srd_sk"))
          .group_by("sr_store_sk")
          .agg(F.sum("sr_return_amt").alias("s_returns"),
               F.sum("sr_net_loss").alias("s_loss")))
    ssr = (ss.join(sr.select(col("sr_store_sk").alias("r_id"),
                             col("s_returns"), col("s_loss")),
                   col("id") == col("r_id"), how="left")
           .select(col("channel"), col("id"), col("sales"),
                   F.coalesce(col("s_returns"), lit(0.0))
                   .alias("returns_"),
                   (col("profit") - F.coalesce(col("s_loss"), lit(0.0)))
                   .alias("profit")))

    cs = (t["catalog_sales"]
          .join(dd.select(col("d_date_sk").alias("csd_sk")),
                col("cs_sold_date_sk") == col("csd_sk"))
          .group_by("cs_call_center_sk")
          .agg(F.sum("cs_ext_sales_price").alias("sales"),
               F.sum("cs_net_profit").alias("profit")))
    cr = (t["catalog_returns"]
          .join(dd.select(col("d_date_sk").alias("crd_sk")),
                col("cr_returned_date_sk") == col("crd_sk"))
          .agg(F.sum("cr_return_amount").alias("c_returns"),
               F.sum("cr_net_loss").alias("c_loss")))
    csr = (cs.crossJoin(cr)
           .select(lit("catalog channel").alias("channel"),
                   col("cs_call_center_sk").cast("bigint").alias("id"),
                   col("sales"), col("c_returns").alias("returns_"),
                   (col("profit") - col("c_loss")).alias("profit")))

    ws = (t["web_sales"]
          .join(dd.select(col("d_date_sk").alias("wsd_sk")),
                col("ws_sold_date_sk") == col("wsd_sk"))
          .group_by("ws_web_page_sk")
          .agg(F.sum("ws_ext_sales_price").alias("sales"),
               F.sum("ws_net_profit").alias("profit"))
          .select(lit("web channel").alias("channel"),
                  col("ws_web_page_sk").cast("bigint").alias("id"),
                  col("sales"), lit(0.0).alias("returns_"),
                  col("profit")))

    detail = ssr.union(csr).union(ws)
    per_channel = (detail.group_by("channel")
                   .agg(F.sum("sales").alias("sales"),
                        F.sum("returns_").alias("returns_"),
                        F.sum("profit").alias("profit"))
                   .select(col("channel"),
                           lit(None).cast("bigint").alias("id"),
                           col("sales"), col("returns_"),
                           col("profit")))
    total = (detail.agg(F.sum("sales").alias("sales"),
                        F.sum("returns_").alias("returns_"),
                        F.sum("profit").alias("profit"))
             .select(lit(None).cast("string").alias("channel"),
                     lit(None).cast("bigint").alias("id"),
                     col("sales"), col("returns_"), col("profit")))
    return (detail.union(per_channel).union(total)
            .sort(col("channel").asc_nulls_last(),
                  col("id").asc_nulls_last())
            .limit(100))


def q78(t):
    """Customer-item yearly sales ratios for unreturned sales."""
    ws = (t["web_sales"]
          .join(t["web_returns"].select(
              col("wr_order_number").alias("wr_o"),
              col("wr_item_sk").alias("wr_i")),
              (col("ws_order_number") == col("wr_o"))
              & (col("ws_item_sk") == col("wr_i")), how="leftanti")
          .join(t["date_dim"].select(col("d_date_sk").alias("wd_sk"),
                                     col("d_year").alias("w_year")),
                col("ws_sold_date_sk") == col("wd_sk"))
          .filter(col("w_year") >= lit(1998))
          .group_by("ws_item_sk", "ws_bill_customer_sk")
          .agg(F.sum("ws_quantity").alias("ws_qty"),
               F.sum("ws_wholesale_cost").alias("ws_wc"),
               F.sum("ws_sales_price").alias("ws_sp"))
          .select(col("ws_item_sk").alias("w_isk"),
                  col("ws_bill_customer_sk").alias("w_csk"),
                  col("ws_qty"), col("ws_wc"), col("ws_sp")))
    ss = (t["store_sales"]
          .join(t["store_returns"].select(
              col("sr_ticket_number").alias("sr_t"),
              col("sr_item_sk").alias("sr_i")),
              (col("ss_ticket_number") == col("sr_t"))
              & (col("ss_item_sk") == col("sr_i")), how="leftanti")
          .join(t["date_dim"],
                col("ss_sold_date_sk") == col("d_date_sk"))
          .filter(col("d_year") >= lit(1998))
          .group_by("ss_item_sk", "ss_customer_sk")
          .agg(F.sum("ss_quantity").alias("ss_qty"),
               F.sum("ss_wholesale_cost").alias("ss_wc"),
               F.sum("ss_sales_price").alias("ss_sp")))
    return (ss.join(ws, (col("ss_item_sk") == col("w_isk"))
                    & (col("ss_customer_sk") == col("w_csk")))
            .filter(col("ws_qty") > lit(0))
            .select(col("ss_item_sk"), col("ss_customer_sk"),
                    col("ss_qty"), col("ws_qty"),
                    (col("ss_qty").cast("double")
                     / col("ws_qty").cast("double")).alias("ratio"))
            .sort(col("ratio").desc(), col("ss_item_sk").asc())
            .limit(100))


def q79(t):
    """Customer ticket profits in big stores on weekdays."""
    hd = t["household_demographics"].filter(
        (col("hd_dep_count") == lit(4))
        | (col("hd_vehicle_count") > lit(2)))
    tickets = (t["store_sales"]
               .join(t["date_dim"].filter(
                   (col("d_dow") == lit(1))
                   & col("d_year").isin(1999, 2000, 2001)),
                   col("ss_sold_date_sk") == col("d_date_sk"))
               .join(t["store"].filter(
                   col("s_number_employees") >= lit(200)),
                   col("ss_store_sk") == col("s_store_sk"))
               .join(hd, col("ss_hdemo_sk") == col("hd_demo_sk"))
               .group_by("ss_ticket_number", "ss_customer_sk",
                         "s_city")
               .agg(F.sum("ss_coupon_amt").alias("amt"),
                    F.sum("ss_net_profit").alias("profit")))
    return (tickets
            .join(t["customer"],
                  col("ss_customer_sk") == col("c_customer_sk"))
            .select("c_last_name", "c_first_name", "s_city", "profit",
                    "ss_ticket_number", "amt")
            .sort(col("c_last_name").asc_nulls_last(),
                  col("c_first_name").asc_nulls_last(),
                  col("profit").desc(), col("ss_ticket_number").asc())
            .limit(100))


def q80(t):
    """Promotion channel totals rollup across the three channels."""
    dd = t["date_dim"].filter((col("d_date") >= _d(2000, 8, 3))
                              & (col("d_date") <= _d(2000, 10, 2)))
    promo = t["promotion"].filter(col("p_channel_tv") == lit("N"))

    ss = (t["store_sales"]
          .join(dd.select("d_date_sk"),
                col("ss_sold_date_sk") == col("d_date_sk"))
          .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
          .join(promo.select(col("p_promo_sk").alias("sp_sk")),
                col("ss_promo_sk") == col("sp_sk"), how="leftsemi")
          .join(t["store_returns"].select(
              col("sr_ticket_number").alias("sr_t"),
              col("sr_item_sk").alias("sr_i"),
              col("sr_return_amt").alias("sret"),
              col("sr_net_loss").alias("sloss")),
              (col("ss_ticket_number") == col("sr_t"))
              & (col("ss_item_sk") == col("sr_i")), how="left")
          .group_by("s_store_id")
          .agg(F.sum("ss_ext_sales_price").alias("sales"),
               F.sum(F.coalesce(col("sret"), lit(0.0)))
               .alias("returns_"),
               F.sum(col("ss_net_profit")
                     - F.coalesce(col("sloss"), lit(0.0)))
               .alias("profit"))
          .select(lit("store channel").alias("channel"),
                  col("s_store_id").alias("id"), col("sales"),
                  col("returns_"), col("profit")))
    cs = (t["catalog_sales"]
          .join(dd.select(col("d_date_sk").alias("cd_sk")),
                col("cs_sold_date_sk") == col("cd_sk"))
          .join(t["catalog_page"],
                col("cs_catalog_page_sk") == col("cp_catalog_page_sk"))
          .join(promo.select(col("p_promo_sk").alias("cp_sk")),
                col("cs_promo_sk") == col("cp_sk"), how="leftsemi")
          .join(t["catalog_returns"].select(
              col("cr_order_number").alias("cr_o"),
              col("cr_item_sk").alias("cr_i"),
              col("cr_return_amount").alias("cret"),
              col("cr_net_loss").alias("closs")),
              (col("cs_order_number") == col("cr_o"))
              & (col("cs_item_sk") == col("cr_i")), how="left")
          .group_by("cp_catalog_page_id")
          .agg(F.sum("cs_ext_sales_price").alias("sales"),
               F.sum(F.coalesce(col("cret"), lit(0.0)))
               .alias("returns_"),
               F.sum(col("cs_net_profit")
                     - F.coalesce(col("closs"), lit(0.0)))
               .alias("profit"))
          .select(lit("catalog channel").alias("channel"),
                  col("cp_catalog_page_id").alias("id"), col("sales"),
                  col("returns_"), col("profit")))
    ws = (t["web_sales"]
          .join(dd.select(col("d_date_sk").alias("wd_sk")),
                col("ws_sold_date_sk") == col("wd_sk"))
          .join(t["web_site"],
                col("ws_web_site_sk") == col("web_site_sk"))
          .join(promo.select(col("p_promo_sk").alias("wp_sk")),
                col("ws_promo_sk") == col("wp_sk"), how="leftsemi")
          .join(t["web_returns"].select(
              col("wr_order_number").alias("wr_o"),
              col("wr_item_sk").alias("wr_i"),
              col("wr_return_amt").alias("wret"),
              col("wr_net_loss").alias("wloss")),
              (col("ws_order_number") == col("wr_o"))
              & (col("ws_item_sk") == col("wr_i")), how="left")
          .group_by("web_site_id")
          .agg(F.sum("ws_ext_sales_price").alias("sales"),
               F.sum(F.coalesce(col("wret"), lit(0.0)))
               .alias("returns_"),
               F.sum(col("ws_net_profit")
                     - F.coalesce(col("wloss"), lit(0.0)))
               .alias("profit"))
          .select(lit("web channel").alias("channel"),
                  col("web_site_id").alias("id"), col("sales"),
                  col("returns_"), col("profit")))
    detail = ss.union(cs).union(ws)
    per_channel = (detail.group_by("channel")
                   .agg(F.sum("sales").alias("sales"),
                        F.sum("returns_").alias("returns_"),
                        F.sum("profit").alias("profit"))
                   .select(col("channel"),
                           lit(None).cast("string").alias("id"),
                           col("sales"), col("returns_"),
                           col("profit")))
    total = (detail.agg(F.sum("sales").alias("sales"),
                        F.sum("returns_").alias("returns_"),
                        F.sum("profit").alias("profit"))
             .select(lit(None).cast("string").alias("channel"),
                     lit(None).cast("string").alias("id"),
                     col("sales"), col("returns_"), col("profit")))
    return (detail.union(per_channel).union(total)
            .sort(col("channel").asc_nulls_last(),
                  col("id").asc_nulls_last())
            .limit(100))


def q81(t):
    """Catalog returners above 1.2x state average (q30 catalog)."""
    ctr = (t["catalog_returns"]
           .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                 col("cr_returned_date_sk") == col("d_date_sk"))
           .join(t["customer"].select(
               col("c_customer_sk").alias("rc_sk"),
               col("c_current_addr_sk").alias("rc_addr")),
               col("cr_returning_customer_sk") == col("rc_sk"))
           .join(t["customer_address"],
                 col("rc_addr") == col("ca_address_sk"))
           .group_by("cr_returning_customer_sk", "ca_state")
           .agg(F.sum("cr_refunded_cash").alias("ctr_total_return")))
    avg_ctr = (ctr.group_by("ca_state")
               .agg((F.avg("ctr_total_return") * lit(1.2)).alias("thr"))
               .select(col("ca_state").alias("avg_state"), col("thr")))
    return (ctr
            .join(avg_ctr, col("ca_state") == col("avg_state"))
            .filter(col("ctr_total_return") > col("thr"))
            .join(t["customer"],
                  col("cr_returning_customer_sk")
                  == col("c_customer_sk"))
            .select("c_customer_id", "c_salutation", "c_first_name",
                    "c_last_name", "ca_state", "ctr_total_return")
            .sort("c_customer_id", "ctr_total_return")
            .limit(100))


def q82(t):
    """q37 for the store channel."""
    inv = (t["inventory"]
           .join(t["date_dim"].filter(
               (col("d_date") >= _d(2000, 5, 25))
               & (col("d_date") <= _d(2000, 7, 24))),
               col("inv_date_sk") == col("d_date_sk"))
           .filter((col("inv_quantity_on_hand") >= lit(100))
                   & (col("inv_quantity_on_hand") <= lit(500)))
           .select(col("inv_item_sk").alias("inv_sk")))
    sold = t["store_sales"].select(col("ss_item_sk").alias("sold_sk"))
    return (t["item"]
            .filter((col("i_current_price") >= lit(30.0))
                    & (col("i_current_price") <= lit(90.0)))
            .join(inv, col("i_item_sk") == col("inv_sk"),
                  how="leftsemi")
            .join(sold, col("i_item_sk") == col("sold_sk"),
                  how="leftsemi")
            .group_by("i_item_id", "i_item_desc", "i_current_price")
            .agg(F.count("*").alias("_cnt"))
            .select("i_item_id", "i_item_desc", "i_current_price")
            .sort("i_item_id")
            .limit(100))


def q83(t):
    """Return quantities per item across all three channels.
    (Like-delta: multi-year window — single-quarter triple-channel item
    overlap is empty in dbgen-lite data.)"""
    dd = t["date_dim"].filter((col("d_date") >= _d(1998, 1, 1))
                              & (col("d_date") <= _d(2002, 12, 31)))

    sr = (t["store_returns"]
          .join(dd.select("d_date_sk"),
                col("sr_returned_date_sk") == col("d_date_sk"))
          .join(t["item"], col("sr_item_sk") == col("i_item_sk"))
          .group_by("i_item_id")
          .agg(F.sum("sr_return_quantity").alias("sr_qty"))
          .select(col("i_item_id").alias("sr_id"), col("sr_qty")))
    cr = (t["catalog_returns"]
          .join(dd.select(col("d_date_sk").alias("cd_sk")),
                col("cr_returned_date_sk") == col("cd_sk"))
          .join(t["item"].select(col("i_item_sk").alias("ci_sk"),
                                 col("i_item_id").alias("cr_id")),
                col("cr_item_sk") == col("ci_sk"))
          .group_by("cr_id")
          .agg(F.sum("cr_return_quantity").alias("cr_qty")))
    wr = (t["web_returns"]
          .join(dd.select(col("d_date_sk").alias("wd_sk")),
                col("wr_returned_date_sk") == col("wd_sk"))
          .join(t["item"].select(col("i_item_sk").alias("wi_sk"),
                                 col("i_item_id").alias("wr_id")),
                col("wr_item_sk") == col("wi_sk"))
          .group_by("wr_id")
          .agg(F.sum("wr_return_quantity").alias("wr_qty")))
    j = (sr.join(cr, col("sr_id") == col("cr_id"))
         .join(wr, col("sr_id") == col("wr_id")))
    total = (col("sr_qty") + col("cr_qty") + col("wr_qty")) \
        .cast("double")
    return (j.select(
        col("sr_id").alias("item_id"), col("sr_qty"),
        (col("sr_qty").cast("double") / total * lit(100.0))
        .alias("sr_dev"),
        col("cr_qty"),
        (col("cr_qty").cast("double") / total * lit(100.0))
        .alias("cr_dev"),
        col("wr_qty"),
        (col("wr_qty").cast("double") / total * lit(100.0))
        .alias("wr_dev"),
        (total / lit(3.0)).alias("average"))
        .sort("item_id", "sr_qty")
        .limit(100))


def q84(t):
    """Returning customers in one city within an income band."""
    return (t["customer"]
            .join(t["customer_address"].filter(
                col("ca_city").isin("Midway", "Fairview", "Oakland")),
                col("c_current_addr_sk") == col("ca_address_sk"))
            .join(t["household_demographics"],
                  col("c_current_hdemo_sk") == col("hd_demo_sk"))
            .join(t["income_band"].filter(
                (col("ib_lower_bound") >= lit(0))
                & (col("ib_upper_bound") <= lit(100000))),
                col("hd_income_band_sk") == col("ib_income_band_sk"))
            .join(t["customer_demographics"],
                  col("c_current_cdemo_sk") == col("cd_demo_sk"))
            .join(t["store_returns"],
                  col("cd_demo_sk") == col("sr_cdemo_sk"),
                  how="leftsemi")
            .select(col("c_customer_id").alias("customer_id"),
                    F.concat(col("c_last_name"), lit(", "),
                             col("c_first_name")).alias("customername"))
            .sort("customer_id")
            .limit(100))


def q85(t):
    """Web return stats by reason with OR'd demographic conditions."""
    cd1 = t["customer_demographics"].select(
        col("cd_demo_sk").alias("cd1_sk"),
        col("cd_marital_status").alias("ms1"),
        col("cd_education_status").alias("es1"))
    cd2 = t["customer_demographics"].select(
        col("cd_demo_sk").alias("cd2_sk"),
        col("cd_marital_status").alias("ms2"),
        col("cd_education_status").alias("es2"))
    j = (t["web_sales"]
         .join(t["web_returns"],
               (col("ws_order_number") == col("wr_order_number"))
               & (col("ws_item_sk") == col("wr_item_sk")))
         .join(t["web_page"],
               col("ws_web_page_sk") == col("wp_web_page_sk"))
         .join(cd1, col("wr_refunded_cdemo_sk") == col("cd1_sk"))
         .join(cd2, col("wr_returning_cdemo_sk") == col("cd2_sk"))
         .join(t["customer_address"],
               col("wr_refunded_addr_sk") == col("ca_address_sk"))
         .join(t["date_dim"].filter(col("d_year") == lit(2000)),
               col("ws_sold_date_sk") == col("d_date_sk"))
         .join(t["reason"], col("wr_reason_sk") == col("r_reason_sk"))
         .filter((col("ms1") == col("ms2"))
                 & (col("es1") == col("es2"))))
    return (j.group_by("r_reason_desc")
            .agg(F.avg("ws_quantity").alias("avg_qty"),
                 F.avg("wr_refunded_cash").alias("avg_cash"),
                 F.avg("wr_fee").alias("avg_fee"))
            .sort("r_reason_desc")
            .limit(100))


def q86(t):
    """Web net profit rollup over the item hierarchy with rank."""
    base = (t["web_sales"]
            .join(t["date_dim"].filter(
                (col("d_month_seq") >= lit(120))
                & (col("d_month_seq") <= lit(131))),
                col("ws_sold_date_sk") == col("d_date_sk"))
            .join(t["item"], col("ws_item_sk") == col("i_item_sk")))
    lvl2 = (base.group_by("i_category", "i_class")
            .agg(F.sum("ws_net_profit").alias("total_sum"))
            .select("total_sum", "i_category", "i_class",
                    lit(0).alias("lochierarchy")))
    lvl1 = (base.group_by("i_category")
            .agg(F.sum("ws_net_profit").alias("total_sum"))
            .select(col("total_sum"), col("i_category"),
                    lit(None).cast("string").alias("i_class"),
                    lit(1).alias("lochierarchy")))
    lvl0 = (base.agg(F.sum("ws_net_profit").alias("total_sum"))
            .select(col("total_sum"),
                    lit(None).cast("string").alias("i_category"),
                    lit(None).cast("string").alias("i_class"),
                    lit(2).alias("lochierarchy")))
    u = lvl2.union(lvl1).union(lvl0)
    rk = F.rank().over(Window.partition_by("lochierarchy")
                       .order_by(col("total_sum").desc()))
    return (u.select("total_sum", "i_category", "i_class",
                     "lochierarchy", rk.alias("rank_within_parent"))
            .sort(col("lochierarchy").desc(),
                  col("i_category").asc_nulls_last(),
                  col("rank_within_parent").asc())
            .limit(100))


def q87(t):
    """Store customers minus catalog minus web (EXCEPT chain)."""
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
    return (ss.join(cs, col("sk") == col("csk"), how="leftanti")
            .join(ws, col("sk") == col("wsk"), how="leftanti")
            .agg(F.count("*").alias("num_customers")))


def q88(t):
    """Half-hour sales counts through the day (8 cross-joined cells)."""
    hd = t["household_demographics"].filter(
        (col("hd_dep_count") >= lit(0)))
    slots = [(8, 30), (9, 0), (9, 30), (10, 0), (10, 30), (11, 0),
             (11, 30), (12, 0)]
    out = None
    for i, (h, m) in enumerate(slots, 1):
        td = t["time_dim"].filter(
            (col("t_hour") == lit(h))
            & (col("t_minute") >= lit(m))
            & (col("t_minute") < lit(m + 30))).select(
            col("t_time_sk").alias(f"t{i}_sk"))
        cell = (t["store_sales"]
                .join(td, col("ss_sold_time_sk") == col(f"t{i}_sk"))
                .join(t["store"].filter(
                    col("s_store_name") == lit("store-1"))
                    .select(col("s_store_sk").alias(f"s{i}_sk")),
                    col("ss_store_sk") == col(f"s{i}_sk"))
                .agg(F.count("*").alias(f"h{i}")))
        out = cell if out is None else out.crossJoin(cell)
    return out


def q89(t):
    """Item-class monthly sales below their yearly average."""
    base = (t["store_sales"]
            .join(t["item"].filter(
                col("i_category").isin("Books", "Electronics",
                                       "Sports", "Men", "Jewelry",
                                       "Women")),
                col("ss_item_sk") == col("i_item_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .group_by("i_category", "i_class", "i_brand",
                      "s_store_name", "s_company_name", "d_moy")
            .agg(F.sum("ss_sales_price").alias("sum_sales")))
    v = base.select(
        "i_category", "i_class", "i_brand", "s_store_name",
        "s_company_name", "d_moy", "sum_sales",
        F.avg(col("sum_sales")).over(
            Window.partition_by("i_category", "i_brand",
                                "s_store_name", "s_company_name"))
        .alias("avg_monthly_sales"))
    return (v.filter(F.when(col("avg_monthly_sales") != lit(0.0),
                            F.abs(col("sum_sales")
                                  - col("avg_monthly_sales"))
                            / col("avg_monthly_sales"))
                     .otherwise(lit(None)) > lit(0.1))
            .sort((col("sum_sales") - col("avg_monthly_sales")).asc(),
                  col("s_store_name").asc(), col("d_moy").asc())
            .limit(100))


def q90(t):
    """AM to PM web sales ratio."""
    am = (t["web_sales"]
          .join(t["time_dim"].filter((col("t_hour") >= lit(8))
                                     & (col("t_hour") <= lit(9)))
                .select(col("t_time_sk").alias("am_sk")),
                col("ws_sold_time_sk") == col("am_sk"))
          .join(t["web_page"].filter((col("wp_char_count") >= lit(100))
                                     & (col("wp_char_count")
                                        <= lit(7000)))
                .select(col("wp_web_page_sk").alias("am_wp")),
                col("ws_web_page_sk") == col("am_wp"))
          .agg(F.count("*").alias("amc")))
    pm = (t["web_sales"]
          .join(t["time_dim"].filter((col("t_hour") >= lit(19))
                                     & (col("t_hour") <= lit(20)))
                .select(col("t_time_sk").alias("pm_sk")),
                col("ws_sold_time_sk") == col("pm_sk"))
          .join(t["web_page"].filter((col("wp_char_count") >= lit(100))
                                     & (col("wp_char_count")
                                        <= lit(7000)))
                .select(col("wp_web_page_sk").alias("pm_wp")),
                col("ws_web_page_sk") == col("pm_wp"))
          .agg(F.count("*").alias("pmc")))
    return (am.crossJoin(pm)
            .select((col("amc").cast("double")
                     / col("pmc").cast("double"))
                    .alias("am_pm_ratio")))


def q91(t):
    """Call-center catalog return losses by demographic group."""
    return (t["catalog_returns"]
            .join(t["call_center"],
                  col("cr_call_center_sk") == col("cc_call_center_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(1998)),
                  col("cr_returned_date_sk") == col("d_date_sk"))
            .join(t["customer"],
                  col("cr_returning_customer_sk")
                  == col("c_customer_sk"))
            .join(t["customer_demographics"].filter(
                col("cd_education_status").isin("Unknown",
                                                "Advanced Degree")),
                col("c_current_cdemo_sk") == col("cd_demo_sk"))
            .join(t["household_demographics"].filter(
                col("hd_buy_potential").isin(">10000", "Unknown")),
                col("c_current_hdemo_sk") == col("hd_demo_sk"))
            .join(t["customer_address"],
                  col("c_current_addr_sk") == col("ca_address_sk"))
            .group_by("cc_call_center_id", "cc_name", "cc_manager",
                      "cd_marital_status", "cd_education_status")
            .agg(F.sum("cr_net_loss").alias("returns_loss"))
            .sort(col("returns_loss").desc())
            .limit(100))


def q92(t):
    """Web excess discount (q32 web version)."""
    dd = t["date_dim"].filter((col("d_date") >= _d(2000, 1, 27))
                              & (col("d_date") <= _d(2000, 4, 26)))
    per_item = (t["web_sales"]
                .join(dd.select(col("d_date_sk").alias("ad_sk")),
                      col("ws_sold_date_sk") == col("ad_sk"))
                .group_by("ws_item_sk")
                .agg((F.avg("ws_ext_discount_amt") * lit(1.3))
                     .alias("thr"))
                .select(col("ws_item_sk").alias("avg_item_sk"),
                        col("thr")))
    return (t["web_sales"]
            .join(dd.select("d_date_sk"),
                  col("ws_sold_date_sk") == col("d_date_sk"))
            .join(t["item"].filter(col("i_manufact_id") <= lit(350)),
                  col("ws_item_sk") == col("i_item_sk"))
            .join(per_item, col("ws_item_sk") == col("avg_item_sk"))
            .filter(col("ws_ext_discount_amt") > col("thr"))
            .agg(F.sum("ws_ext_discount_amt")
                 .alias("excess_discount_amount")))


def q93(t):
    """Customer net sales after subtracting returned quantity value."""
    sr = (t["store_returns"]
          .join(t["reason"].filter(col("r_reason_desc")
                                   .startswith("reason 2")),
                col("sr_reason_sk") == col("r_reason_sk"))
          .select(col("sr_ticket_number").alias("r_t"),
                  col("sr_item_sk").alias("r_i"),
                  col("sr_return_quantity").alias("r_q")))
    act = F.when(F.isnull(col("r_q")),
                 col("ss_quantity").cast("double")
                 * col("ss_sales_price")) \
        .otherwise((col("ss_quantity") - col("r_q")).cast("double")
                   * col("ss_sales_price"))
    return (t["store_sales"]
            .join(sr, (col("ss_ticket_number") == col("r_t"))
                  & (col("ss_item_sk") == col("r_i")), how="left")
            .group_by("ss_customer_sk")
            .agg(F.sum(act).alias("sumsales"))
            .sort(col("sumsales").asc(),
                  col("ss_customer_sk").asc_nulls_last())
            .limit(100))


def q94(t):
    """Web orders shipped via multiple sites without returns."""
    ws1 = (t["web_sales"]
           .join(t["date_dim"].filter(
               (col("d_date") >= _d(1999, 2, 1))
               & (col("d_date") <= _d(1999, 4, 2))),
               col("ws_ship_date_sk") == col("d_date_sk"))
           .join(t["customer_address"].filter(
               col("ca_state").isin("IL", "CA", "TX", "NY", "WA")),
               col("ws_ship_addr_sk") == col("ca_address_sk"))
           .join(t["web_site"],
                 col("ws_web_site_sk") == col("web_site_sk")))
    multi = (t["web_sales"]
             .group_by("ws_order_number")
             .agg(F.count_distinct(col("ws_warehouse_sk"))
                  .alias("n_wh"))
             .filter(col("n_wh") > lit(1))
             .select(col("ws_order_number").alias("o2")))
    returned = t["web_returns"].select(
        col("wr_order_number").alias("ro"))
    base = (ws1.join(multi, col("ws_order_number") == col("o2"),
                     how="leftsemi")
            .join(returned, col("ws_order_number") == col("ro"),
                  how="leftanti"))
    dist = (base.select("ws_order_number").distinct()
            .agg(F.count("*").alias("order_count")))
    return (base.agg(F.sum("ws_ext_ship_cost")
                     .alias("total_shipping_cost"),
                     F.sum("ws_net_profit").alias("total_net_profit"))
            .crossJoin(dist)
            .select("order_count", "total_shipping_cost",
                    "total_net_profit"))


def q95(t):
    """Web orders that appear in returns AND ship multi-warehouse."""
    ws_wh = (t["web_sales"]
             .group_by("ws_order_number")
             .agg(F.count_distinct(col("ws_warehouse_sk"))
                  .alias("n_wh"))
             .filter(col("n_wh") > lit(1))
             .select(col("ws_order_number").alias("o2")))
    returned = t["web_returns"].select(
        col("wr_order_number").alias("ro"))
    base = (t["web_sales"]
            .join(t["date_dim"].filter(
                (col("d_date") >= _d(1999, 2, 1))
                & (col("d_date") <= _d(1999, 4, 2))),
                col("ws_ship_date_sk") == col("d_date_sk"))
            .join(t["customer_address"].filter(
                col("ca_state").isin("IL", "CA", "TX", "NY", "WA")),
                col("ws_ship_addr_sk") == col("ca_address_sk"))
            .join(t["web_site"],
                  col("ws_web_site_sk") == col("web_site_sk"))
            .join(ws_wh, col("ws_order_number") == col("o2"),
                  how="leftsemi")
            .join(returned, col("ws_order_number") == col("ro"),
                  how="leftsemi"))
    dist = (base.select("ws_order_number").distinct()
            .agg(F.count("*").alias("order_count")))
    return (base.agg(F.sum("ws_ext_ship_cost")
                     .alias("total_shipping_cost"),
                     F.sum("ws_net_profit").alias("total_net_profit"))
            .crossJoin(dist)
            .select("order_count", "total_shipping_cost",
                    "total_net_profit"))


def q97(t):
    """Store/catalog customer-item overlap counts."""
    dd = t["date_dim"].filter((col("d_month_seq") >= lit(120))
                              & (col("d_month_seq") <= lit(131)))
    ss = (t["store_sales"]
          .join(dd.select("d_date_sk"),
                col("ss_sold_date_sk") == col("d_date_sk"))
          .select(col("ss_customer_sk").alias("s_csk"),
                  col("ss_item_sk").alias("s_isk")).distinct())
    cs = (t["catalog_sales"]
          .join(dd.select(col("d_date_sk").alias("cd_sk")),
                col("cs_sold_date_sk") == col("cd_sk"))
          .select(col("cs_bill_customer_sk").alias("c_csk"),
                  col("cs_item_sk").alias("c_isk")).distinct())
    j = ss.join(cs, (col("s_csk") == col("c_csk"))
                & (col("s_isk") == col("c_isk")), how="full")
    return j.agg(
        F.sum(F.when(F.isnull(col("c_csk")), lit(1)).otherwise(lit(0)))
        .alias("store_only"),
        F.sum(F.when(F.isnull(col("s_csk")), lit(1)).otherwise(lit(0)))
        .alias("catalog_only"),
        F.sum(F.when((~F.isnull(col("s_csk")))
                     & (~F.isnull(col("c_csk"))), lit(1))
              .otherwise(lit(0))).alias("store_and_catalog"))


def q99(t):
    """Catalog shipping-lag buckets by call center/ship mode."""
    lag = col("cs_ship_date_sk") - col("cs_sold_date_sk")
    return (t["catalog_sales"]
            .join(t["date_dim"].filter((col("d_month_seq") >= lit(120))
                                       & (col("d_month_seq")
                                          <= lit(131))),
                  col("cs_ship_date_sk") == col("d_date_sk"))
            .join(t["call_center"],
                  col("cs_call_center_sk") == col("cc_call_center_sk"))
            .join(t["ship_mode"],
                  col("cs_ship_mode_sk") == col("sm_ship_mode_sk"))
            .join(t["warehouse"],
                  col("cs_warehouse_sk") == col("w_warehouse_sk"))
            .group_by("w_warehouse_name", "sm_type", "cc_name")
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
                  col("sm_type").asc(), col("cc_name").asc())
            .limit(100))
