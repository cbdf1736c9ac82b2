"""TpcdsLike for the port: star schema, dbgen-lite generator,
representative queries.

Ported from ``spark_rapids_tpu/bench/tpcds.py`` with the port's ``col``,
``functions`` and ``Window``.  The data is not audited dsdgen output and
the results are not comparable to official TPC-DS numbers; the queries
exercise the reporting-class operator mix (star joins over date_dim,
item, store and demographics, grouped aggregates, CASE, top-k sorts,
window functions) that dominates the 99-query set.

The generator is the reference's, factored into one builder per table:
:func:`generate` runs every builder in the reference's order on one
``numpy`` generator, so ``generate(sf, seed)`` equals the reference's
table for table.  :func:`build_tables` runs only the named builders, on
a generator of their own: a cheap way to make the few tables a star
query reads at a large scale factor (their values differ from
``generate``'s, which draws the other tables in between).

Queries: the reference module's own (q3, q7, q19, q42, q52, q55,
q68-lite, q73, q96, q98), then the 89 others merged in from
``tpcds_queries_a/b/c.py`` as the reference merges them: ``QUERIES``
holds all 99.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch.api.column import col, lit
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.window import Window

TPCDS_TABLES = [
    "date_dim", "time_dim", "item", "store", "customer",
    "customer_address", "customer_demographics",
    "household_demographics", "promotion", "store_sales",
    "store_returns", "catalog_sales", "catalog_returns", "web_sales",
    "web_returns", "inventory", "warehouse", "ship_mode", "reason",
    "call_center", "catalog_page", "web_site", "web_page", "income_band",
]

_CATEGORIES = ["Books", "Electronics", "Home", "Jewelry", "Music",
               "Shoes", "Sports", "Women", "Men", "Children"]
_CLASSES = ["class01", "class02", "class03", "class04", "class05"]
_CITIES = ["Midway", "Fairview", "Oakland", "Riverside", "Centerville",
           "Pleasant Hill", "Bunker Hill", "Five Points"]
_COUNTIES = ["Williamson County", "Ziebach County", "Walker County",
             "Daviess County", "Barrow County", "Luce County",
             "Richland County", "Bronx County"]
_COUNTRIES = ["United States", "Canada", "Mexico", "Germany", "Japan",
              "Brazil", "India", "France"]
_STATES = ["CA", "TX", "NY", "WA", "GA", "OH", "IL", "TN"]
_BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                  "0-500", "Unknown"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]



class _Sizes:
    """Row counts of every table at scale factor ``sf``."""

    def __init__(self, sf: float):
        start = _dt.date(1998, 1, 1)
        self.start = start
        self.n_days = (_dt.date(2002, 12, 31) - start).days + 1
        self.ni = max(100, int(18_000 * sf * 10))
        self.ns = max(6, int(12 * sf * 100))
        self.ncd = 1000
        self.nib = 20
        self.nhd = 720
        self.nca = max(50, int(50_000 * sf * 10))
        self.nc = max(100, int(100_000 * sf * 10))
        self.npromo = 30
        self.nss = max(2000, int(2_880_000 * sf))
        self.nsr = max(200, self.nss // 10)
        self.ncc = 6
        self.ncp = 100
        self.nwh = 5
        self.nsm = 20
        self.nreason = 35
        self.ncs = max(1500, int(1_440_000 * sf))
        self.nws = max(1000, int(720_000 * sf))
        self.nwsite = 12
        self.nwp = 60
        self.items_per = min(self.ni, max(20, int(200 * sf * 100)))


# -- per-table builders: ``fn(rng, z, t)`` draws from ``rng`` in the
# reference generator's order and may read the tables already in ``t``.
# The large tables' string columns are built by Arrow's string kernels
# and from numpy arrays, where the reference builds Python lists: the
# same values, in seconds less per million rows.

def _texts(prefix: str, nums: np.ndarray, width: int = 0,
           suffix: str = "") -> pa.Array:
    """``[f"{prefix}{n:0{width}d}{suffix}" for n in nums]`` for
    non-negative ``nums``."""
    s = pa.array(nums).cast(pa.string())
    if width:
        s = pc.utf8_lpad(s, width, "0")
    return pc.binary_join_element_wise(prefix, s, suffix, "")


def _choice(rng, values, n: int) -> pa.Array:
    """``rng.choice(values, n).tolist()`` as an Arrow string array: the
    same draw (``choice`` of an int samples as if from ``arange`` of
    it), taken from ``values`` by index."""
    return pa.array(values).take(rng.choice(len(values), n))

def _date_dim(rng, sz: _Sizes, t) -> pa.Table:
    # 1998-01-01 .. 2002-12-31, sk = index + 1
    start = sz.start
    days = [start + _dt.timedelta(days=i) for i in range(sz.n_days)]
    epoch_week = (start - _dt.date(1995, 1, 2)).days // 7
    day_names = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
                 "Saturday", "Sunday"]
    return pa.table({
        "d_date_sk": pa.array(np.arange(1, sz.n_days + 1, dtype=np.int64)),
        "d_date": pa.array(days, type=pa.date32()),
        "d_year": pa.array(np.array([d.year for d in days],
                                    dtype=np.int32)),
        "d_moy": pa.array(np.array([d.month for d in days],
                                   dtype=np.int32)),
        "d_dom": pa.array(np.array([d.day for d in days],
                                   dtype=np.int32)),
        "d_dow": pa.array(np.array([d.weekday() for d in days],
                                   dtype=np.int32)),
        "d_qoy": pa.array(np.array([(d.month - 1) // 3 + 1 for d in days],
                                   dtype=np.int32)),
        "d_week_seq": pa.array(np.array(
            [epoch_week + (d - start).days // 7 for d in days],
            dtype=np.int32)),
        "d_month_seq": pa.array(np.array(
            [(d.year - 1990) * 12 + d.month - 1 for d in days],
            dtype=np.int32)),
        "d_day_name": [day_names[d.weekday()] for d in days],
        "d_quarter_name": [f"{d.year}Q{(d.month - 1) // 3 + 1}"
                           for d in days],
    })


def _time_dim(rng, sz: _Sizes, t) -> pa.Table:
    meal = np.full(86400, "", dtype=object)
    hours = np.arange(86400) // 3600
    meal[(hours >= 6) & (hours < 9)] = "breakfast"
    meal[(hours >= 17) & (hours < 21)] = "dinner"
    return pa.table({
        "t_time_sk": pa.array(np.arange(1, 86401, dtype=np.int64)),
        "t_time": pa.array(np.arange(86400).astype(np.int32)),
        "t_hour": pa.array(hours.astype(np.int32)),
        "t_minute": pa.array(((np.arange(86400) % 3600) // 60)
                             .astype(np.int32)),
        "t_meal_time": meal.tolist(),
    })


def _item(rng, sz: _Sizes, t) -> pa.Table:
    ni = sz.ni
    brand_id = rng.integers(1, 1000, ni).astype(np.int32)
    cat_id = rng.integers(0, len(_CATEGORIES), ni)
    manu = rng.integers(1, 1000, ni).astype(np.int32)
    ids = np.arange(1, ni + 1)
    return pa.table({
        "i_item_sk": pa.array(np.arange(1, ni + 1, dtype=np.int64)),
        "i_item_id": _texts("ITEM", ids, 12),
        "i_item_desc": _texts("desc of item ", ids),
        "i_brand_id": pa.array(brand_id),
        "i_brand": _texts("brand#", brand_id),
        "i_category_id": pa.array(cat_id.astype(np.int32) + 1),
        "i_category": pa.array(np.array(_CATEGORIES)[cat_id]),
        "i_class_id": pa.array(
            rng.integers(1, len(_CLASSES) + 1, ni).astype(np.int32)),
        "i_class": _choice(rng, _CLASSES, ni),
        "i_manufact_id": pa.array(manu),
        "i_manufact": _texts("manufact#", manu),
        # 1..30 (spec uses 1..100) so point filters like q55's
        # i_manager_id = 28 select rows even at tiny scale factors
        "i_manager_id": pa.array(
            rng.integers(1, 31, ni).astype(np.int32)),
        "i_current_price": np.round(rng.uniform(0.1, 100.0, ni), 2),
        "i_wholesale_cost": np.round(rng.uniform(0.1, 80.0, ni), 2),
        "i_size": _choice(rng, ["small", "medium", "large", "extra large",
                                "economy", "N/A", "petite"], ni),
        "i_color": _choice(rng, ["red", "blue", "green", "white", "black",
                                 "ivory", "almond", "navy", "plum",
                                 "indian", "khaki"], ni),
        "i_units": _choice(rng, ["Each", "Dozen", "Case", "Pound", "Ton",
                                 "Oz", "Pallet"], ni),
        "i_product_name": _texts("product", ids),
    })


def _store(rng, sz: _Sizes, t) -> pa.Table:
    ns = sz.ns
    return pa.table({
        "s_store_sk": pa.array(np.arange(1, ns + 1, dtype=np.int64)),
        "s_store_id": [f"STORE{i:06d}" for i in range(1, ns + 1)],
        "s_store_name": [f"store-{i}" for i in range(1, ns + 1)],
        "s_city": rng.choice(_CITIES, ns).tolist(),
        "s_county": rng.choice(_COUNTIES, ns).tolist(),
        "s_state": rng.choice(_STATES, ns).tolist(),
        "s_zip": [f"{z:05d}" for z in rng.integers(10000, 99999, ns)],
        "s_number_employees": pa.array(
            rng.integers(200, 301, ns).astype(np.int32)),
        "s_floor_space": pa.array(
            rng.integers(5_000_000, 10_000_000, ns).astype(np.int32)),
        "s_gmt_offset": rng.choice([-5.0, -6.0, -7.0, -8.0], ns),
        "s_market_id": pa.array(rng.integers(1, 11, ns).astype(np.int32)),
        "s_company_name": ["Unknown"] * ns,
    })


def _customer_demographics(rng, sz: _Sizes, t) -> pa.Table:
    ncd = sz.ncd
    return pa.table({
        "cd_demo_sk": pa.array(np.arange(1, ncd + 1, dtype=np.int64)),
        "cd_gender": rng.choice(["M", "F"], ncd).tolist(),
        "cd_marital_status": rng.choice(
            ["M", "S", "D", "W", "U"], ncd).tolist(),
        "cd_education_status": rng.choice(_EDUCATION, ncd).tolist(),
        "cd_purchase_estimate": pa.array(
            (rng.integers(1, 21, ncd) * 500).astype(np.int32)),
        "cd_credit_rating": rng.choice(
            ["Good", "Low Risk", "High Risk", "Unknown"], ncd).tolist(),
        "cd_dep_count": pa.array(rng.integers(0, 7, ncd).astype(np.int32)),
        "cd_dep_employed_count": pa.array(
            rng.integers(0, 7, ncd).astype(np.int32)),
        "cd_dep_college_count": pa.array(
            rng.integers(0, 7, ncd).astype(np.int32)),
    })


def _income_band(rng, sz: _Sizes, t) -> pa.Table:
    nib = sz.nib
    return pa.table({
        "ib_income_band_sk": pa.array(np.arange(1, nib + 1,
                                                dtype=np.int64)),
        "ib_lower_bound": pa.array(
            (np.arange(nib) * 10000).astype(np.int32)),
        "ib_upper_bound": pa.array(
            ((np.arange(nib) + 1) * 10000).astype(np.int32)),
    })


def _household_demographics(rng, sz: _Sizes, t) -> pa.Table:
    nhd, nib = sz.nhd, sz.nib
    return pa.table({
        "hd_demo_sk": pa.array(np.arange(1, nhd + 1, dtype=np.int64)),
        "hd_income_band_sk": pa.array(
            rng.integers(1, nib + 1, nhd).astype(np.int64)),
        "hd_dep_count": pa.array(
            rng.integers(0, 10, nhd).astype(np.int32)),
        "hd_vehicle_count": pa.array(
            rng.integers(-1, 5, nhd).astype(np.int32)),
        "hd_buy_potential": rng.choice(_BUY_POTENTIAL, nhd).tolist(),
    })


def _customer_address(rng, sz: _Sizes, t) -> pa.Table:
    nca = sz.nca
    return pa.table({
        "ca_address_sk": pa.array(np.arange(1, nca + 1, dtype=np.int64)),
        "ca_city": _choice(rng, _CITIES, nca),
        "ca_county": _choice(rng, _COUNTIES, nca),
        "ca_state": _choice(rng, _STATES, nca),
        "ca_zip": _texts("", rng.integers(10000, 99999, nca), 5),
        "ca_country": pa.array(np.full(nca, "United States")),
        "ca_gmt_offset": rng.choice([-5.0, -6.0, -7.0, -8.0], nca),
        "ca_location_type": _choice(
            rng, ["condo", "apartment", "single family"], nca),
    })


def _customer(rng, sz: _Sizes, t) -> pa.Table:
    nc, nca, ncd, nhd, n_days = sz.nc, sz.nca, sz.ncd, sz.nhd, sz.n_days
    return pa.table({
        "c_customer_sk": pa.array(np.arange(1, nc + 1, dtype=np.int64)),
        "c_customer_id": _texts("CUST", np.arange(1, nc + 1), 12),
        "c_current_addr_sk": pa.array(
            rng.integers(1, nca + 1, nc).astype(np.int64)),
        "c_current_cdemo_sk": pa.array(
            rng.integers(1, ncd + 1, nc).astype(np.int64)),
        "c_current_hdemo_sk": pa.array(
            rng.integers(1, nhd + 1, nc).astype(np.int64)),
        "c_first_name": _texts("First", np.arange(nc) % 977),
        "c_last_name": _texts("Last", np.arange(nc) % 653),
        "c_preferred_cust_flag": _choice(rng, ["Y", "N"], nc),
        "c_birth_year": pa.array(
            rng.integers(1924, 1993, nc).astype(np.int32)),
        "c_birth_month": pa.array(
            rng.integers(1, 13, nc).astype(np.int32)),
        "c_birth_day": pa.array(
            rng.integers(1, 29, nc).astype(np.int32)),
        "c_birth_country": _choice(rng, _COUNTRIES, nc),
        "c_salutation": _choice(rng, ["Mr.", "Mrs.", "Ms.", "Dr.", "Sir"],
                                nc),
        "c_email_address": _texts("c", np.arange(nc),
                                  suffix="@example.com"),
        "c_first_sales_date_sk": pa.array(
            rng.integers(1, n_days + 1, nc).astype(np.int64)),
        "c_first_shipto_date_sk": pa.array(
            rng.integers(1, n_days + 1, nc).astype(np.int64)),
    })


def _promotion(rng, sz: _Sizes, t) -> pa.Table:
    npromo = sz.npromo
    return pa.table({
        "p_promo_sk": pa.array(np.arange(1, npromo + 1, dtype=np.int64)),
        "p_promo_id": [f"PROMO{i:08d}" for i in range(1, npromo + 1)],
        "p_promo_name": [f"promo-{i}" for i in range(1, npromo + 1)],
        "p_channel_email": rng.choice(["Y", "N"], npromo,
                                      p=[0.15, 0.85]).tolist(),
        "p_channel_event": rng.choice(["Y", "N"], npromo,
                                      p=[0.15, 0.85]).tolist(),
        "p_channel_dmail": rng.choice(["Y", "N"], npromo,
                                      p=[0.5, 0.5]).tolist(),
        "p_channel_tv": rng.choice(["Y", "N"], npromo,
                                   p=[0.15, 0.85]).tolist(),
    })


def _store_sales(rng, sz: _Sizes, t) -> pa.Table:
    nss, n_days, ni, ns, npromo = sz.nss, sz.n_days, sz.ni, sz.ns, sz.npromo
    nc, ncd, nhd, nca = sz.nc, sz.ncd, sz.nhd, sz.nca
    qty = rng.integers(1, 101, nss).astype(np.int32)
    list_price = np.round(rng.uniform(1.0, 200.0, nss), 2)
    sales_price = np.round(list_price * rng.uniform(0.2, 1.0, nss), 2)
    coupon = np.where(rng.random(nss) < 0.1,
                      np.round(sales_price * qty * 0.1, 2), 0.0)
    ext_sales = np.round(sales_price * qty, 2)
    wholesale = np.round(list_price * 0.6, 2)
    return pa.table({
        "ss_sold_date_sk": pa.array(
            rng.integers(1, n_days + 1, nss).astype(np.int64)),
        "ss_sold_time_sk": pa.array(
            rng.integers(1, 86401, nss).astype(np.int64)),
        "ss_item_sk": pa.array(
            rng.integers(1, ni + 1, nss).astype(np.int64)),
        "ss_customer_sk": pa.array(
            rng.integers(1, nc + 1, nss).astype(np.int64)),
        "ss_cdemo_sk": pa.array(
            rng.integers(1, ncd + 1, nss).astype(np.int64)),
        "ss_hdemo_sk": pa.array(
            rng.integers(1, nhd + 1, nss).astype(np.int64)),
        # ~4% null addresses (q76-class queries probe null fk buckets)
        "ss_addr_sk": pa.array(
            rng.integers(1, nca + 1, nss).astype(np.int64),
            mask=rng.random(nss) < 0.04),
        "ss_store_sk": pa.array(
            rng.integers(1, ns + 1, nss).astype(np.int64)),
        "ss_promo_sk": pa.array(
            rng.integers(1, npromo + 1, nss).astype(np.int64)),
        "ss_ticket_number": pa.array(
            rng.integers(1, nss // 3 + 2, nss).astype(np.int64)),
        "ss_quantity": pa.array(qty),
        "ss_wholesale_cost": wholesale,
        "ss_list_price": list_price,
        "ss_sales_price": sales_price,
        "ss_ext_sales_price": ext_sales,
        "ss_ext_list_price": np.round(list_price * qty, 2),
        "ss_ext_discount_amt": coupon,
        "ss_ext_wholesale_cost": np.round(wholesale * qty, 2),
        "ss_ext_tax": np.round(ext_sales * 0.08, 2),
        "ss_coupon_amt": coupon,
        "ss_net_paid": np.round(ext_sales - coupon, 2),
        "ss_net_profit": np.round(ext_sales - wholesale * qty - coupon,
                                  2),
    })


def _store_returns(rng, sz: _Sizes, t) -> pa.Table:
    """~10% of store_sales rows, correlated on (ticket, item,
    customer) so returns join back to their sale."""
    nss, nsr, n_days = sz.nss, sz.nsr, sz.n_days
    ncd, nhd, nca = sz.ncd, sz.nhd, sz.nca
    ss = t["store_sales"]
    qty = np.asarray(ss.column("ss_quantity"))
    sales_price = np.asarray(ss.column("ss_sales_price"))
    ridx = rng.choice(nss, nsr, replace=False)
    r_qty = np.minimum(qty[ridx],
                       rng.integers(1, 101, nsr).astype(np.int32))
    r_amt = np.round(sales_price[ridx] * r_qty, 2)
    return pa.table({
        "sr_returned_date_sk": pa.array(np.minimum(
            np.asarray(ss.column("ss_sold_date_sk"))[ridx]
            + rng.integers(1, 60, nsr), n_days).astype(np.int64)),
        "sr_return_time_sk": pa.array(
            rng.integers(1, 86401, nsr).astype(np.int64)),
        "sr_item_sk": pa.array(
            np.asarray(ss.column("ss_item_sk"))[ridx]),
        "sr_customer_sk": pa.array(
            np.asarray(ss.column("ss_customer_sk"))[ridx]),
        "sr_cdemo_sk": pa.array(
            rng.integers(1, ncd + 1, nsr).astype(np.int64)),
        "sr_hdemo_sk": pa.array(
            rng.integers(1, nhd + 1, nsr).astype(np.int64)),
        "sr_addr_sk": pa.array(
            rng.integers(1, nca + 1, nsr).astype(np.int64)),
        "sr_store_sk": pa.array(
            np.asarray(ss.column("ss_store_sk"))[ridx]),
        "sr_reason_sk": pa.array(
            rng.integers(1, 36, nsr).astype(np.int64)),
        "sr_ticket_number": pa.array(
            np.asarray(ss.column("ss_ticket_number"))[ridx]),
        "sr_return_quantity": pa.array(r_qty),
        "sr_return_amt": r_amt,
        "sr_return_tax": np.round(r_amt * 0.08, 2),
        "sr_return_amt_inc_tax": np.round(r_amt * 1.08, 2),
        "sr_fee": np.round(rng.uniform(0.5, 100.0, nsr), 2),
        "sr_return_ship_cost": np.round(rng.uniform(0, 30.0, nsr), 2),
        "sr_refunded_cash": np.round(r_amt * 0.7, 2),
        "sr_reversed_charge": np.round(r_amt * 0.2, 2),
        "sr_store_credit": np.round(r_amt * 0.1, 2),
        "sr_net_loss": np.round(r_amt * 0.1
                                + rng.uniform(0.5, 50.0, nsr), 2),
    })


def _call_center(rng, sz: _Sizes, t) -> pa.Table:
    ncc = sz.ncc
    return pa.table({
        "cc_call_center_sk": pa.array(np.arange(1, ncc + 1,
                                                dtype=np.int64)),
        "cc_call_center_id": [f"CC{i:06d}" for i in range(1, ncc + 1)],
        "cc_name": [f"call center {i}" for i in range(1, ncc + 1)],
        "cc_manager": [f"Manager{i}" for i in range(1, ncc + 1)],
        "cc_county": rng.choice(_COUNTIES, ncc).tolist(),
    })


def _catalog_page(rng, sz: _Sizes, t) -> pa.Table:
    ncp = sz.ncp
    return pa.table({
        "cp_catalog_page_sk": pa.array(np.arange(1, ncp + 1,
                                                 dtype=np.int64)),
        "cp_catalog_page_id": [f"CP{i:08d}" for i in range(1, ncp + 1)],
    })


def _warehouse(rng, sz: _Sizes, t) -> pa.Table:
    nwh = sz.nwh
    return pa.table({
        "w_warehouse_sk": pa.array(np.arange(1, nwh + 1, dtype=np.int64)),
        "w_warehouse_name": [f"Warehouse {i}" for i in range(1, nwh + 1)],
        "w_warehouse_sq_ft": pa.array(
            rng.integers(50_000, 1_000_000, nwh).astype(np.int32)),
        "w_city": rng.choice(_CITIES, nwh).tolist(),
        "w_county": rng.choice(_COUNTIES, nwh).tolist(),
        "w_state": rng.choice(_STATES, nwh).tolist(),
        "w_country": ["United States"] * nwh,
    })


def _ship_mode(rng, sz: _Sizes, t) -> pa.Table:
    nsm = sz.nsm
    return pa.table({
        "sm_ship_mode_sk": pa.array(np.arange(1, nsm + 1,
                                              dtype=np.int64)),
        "sm_type": rng.choice(["EXPRESS", "NEXT DAY", "OVERNIGHT",
                               "REGULAR", "TWO DAY", "LIBRARY"],
                              nsm).tolist(),
        "sm_carrier": rng.choice(["UPS", "FEDEX", "AIRBORNE", "USPS",
                                  "DHL", "TBS"], nsm).tolist(),
        "sm_code": rng.choice(["AIR", "SURFACE", "SEA"], nsm).tolist(),
    })


def _reason(rng, sz: _Sizes, t) -> pa.Table:
    nreason = sz.nreason
    return pa.table({
        "r_reason_sk": pa.array(np.arange(1, nreason + 1,
                                          dtype=np.int64)),
        "r_reason_desc": [f"reason {i}" for i in range(1, nreason + 1)],
    })


def _sales_channel(rng, sz: _Sizes, prefix: str, nrows: int,
                   order_div: int, extra: Dict[str, pa.Array]) -> pa.Table:
    """Shared generator for catalog_sales/web_sales columns."""
    n_days, ni, npromo, nwh, nsm = (sz.n_days, sz.ni, sz.npromo, sz.nwh,
                                    sz.nsm)
    q2 = rng.integers(1, 101, nrows).astype(np.int32)
    lp2 = np.round(rng.uniform(1.0, 200.0, nrows), 2)
    sp2 = np.round(lp2 * rng.uniform(0.2, 1.0, nrows), 2)
    ws2 = np.round(lp2 * 0.6, 2)
    ext2 = np.round(sp2 * q2, 2)
    disc = np.where(rng.random(nrows) < 0.1,
                    np.round(ext2 * 0.1, 2), 0.0)
    sold = rng.integers(1, n_days + 1, nrows).astype(np.int64)
    cols = {
        f"{prefix}_sold_date_sk": pa.array(sold),
        f"{prefix}_sold_time_sk": pa.array(
            rng.integers(1, 86401, nrows).astype(np.int64)),
        f"{prefix}_ship_date_sk": pa.array(np.minimum(
            sold + rng.integers(1, 121, nrows), n_days)
            .astype(np.int64)),
        f"{prefix}_item_sk": pa.array(
            rng.integers(1, ni + 1, nrows).astype(np.int64)),
        f"{prefix}_order_number": pa.array(
            rng.integers(1, nrows // order_div + 2, nrows)
            .astype(np.int64)),
        f"{prefix}_quantity": pa.array(q2),
        f"{prefix}_wholesale_cost": ws2,
        f"{prefix}_list_price": lp2,
        f"{prefix}_sales_price": sp2,
        f"{prefix}_ext_discount_amt": disc,
        f"{prefix}_ext_sales_price": ext2,
        f"{prefix}_ext_wholesale_cost": np.round(ws2 * q2, 2),
        f"{prefix}_ext_list_price": np.round(lp2 * q2, 2),
        f"{prefix}_ext_ship_cost": np.round(
            rng.uniform(0, 25.0, nrows) * q2, 2),
        f"{prefix}_net_paid": np.round(ext2 - disc, 2),
        f"{prefix}_net_profit": np.round(ext2 - ws2 * q2 - disc, 2),
        f"{prefix}_coupon_amt": disc,
        f"{prefix}_promo_sk": pa.array(
            rng.integers(1, npromo + 1, nrows).astype(np.int64)),
        f"{prefix}_warehouse_sk": pa.array(
            rng.integers(1, nwh + 1, nrows).astype(np.int64)),
        f"{prefix}_ship_mode_sk": pa.array(
            rng.integers(1, nsm + 1, nrows).astype(np.int64)),
    }
    cols.update(extra)
    return pa.table(cols)

def _returns(rng, sz: _Sizes, prefix: str, sales: pa.Table, sprefix: str,
             extra_fn) -> pa.Table:
    n_days, nreason = sz.n_days, sz.nreason
    nr = max(150, sales.num_rows // 10)
    idx = rng.choice(sales.num_rows, nr, replace=False)
    rq = np.minimum(np.asarray(sales.column(f"{sprefix}_quantity"))[idx],
                    rng.integers(1, 101, nr).astype(np.int32))
    ra = np.round(
        np.asarray(sales.column(f"{sprefix}_sales_price"))[idx] * rq, 2)
    cols = {
        f"{prefix}_returned_date_sk": pa.array(np.minimum(
            np.asarray(sales.column(f"{sprefix}_sold_date_sk"))[idx]
            + rng.integers(1, 60, nr), n_days).astype(np.int64)),
        f"{prefix}_item_sk": pa.array(
            np.asarray(sales.column(f"{sprefix}_item_sk"))[idx]),
        f"{prefix}_order_number": pa.array(
            np.asarray(sales.column(f"{sprefix}_order_number"))[idx]),
        f"{prefix}_return_quantity": pa.array(rq),
        f"{prefix}_reason_sk": pa.array(
            rng.integers(1, nreason + 1, nr).astype(np.int64)),
        f"{prefix}_refunded_cash": np.round(ra * 0.7, 2),
        f"{prefix}_reversed_charge": np.round(ra * 0.2, 2),
        f"{prefix}_net_loss": np.round(
            ra * 0.1 + rng.uniform(0.5, 50.0, nr), 2),
        f"{prefix}_fee": np.round(rng.uniform(0.5, 100.0, nr), 2),
    }
    cols.update(extra_fn(idx, nr, ra))
    return pa.table(cols)

# correlate ~1/3 of catalog orders with store-returned (customer,
# item) pairs so cross-channel repurchase chains (q17/q25/q29/q64)

def _catalog_sales(rng, sz: _Sizes, t) -> pa.Table:
    ncs, nc, ncd, nhd, nca = sz.ncs, sz.nc, sz.ncd, sz.nhd, sz.nca
    ncc, ncp = sz.ncc, sz.ncp
    return _sales_channel(rng, sz, "cs", ncs, 4, {
        "cs_bill_customer_sk": pa.array(
            rng.integers(1, nc + 1, ncs).astype(np.int64)),
        "cs_bill_cdemo_sk": pa.array(
            rng.integers(1, ncd + 1, ncs).astype(np.int64)),
        "cs_bill_hdemo_sk": pa.array(
            rng.integers(1, nhd + 1, ncs).astype(np.int64)),
        "cs_bill_addr_sk": pa.array(
            rng.integers(1, nca + 1, ncs).astype(np.int64)),
        "cs_ship_customer_sk": pa.array(
            rng.integers(1, nc + 1, ncs).astype(np.int64)),
        "cs_ship_addr_sk": pa.array(
            rng.integers(1, nca + 1, ncs).astype(np.int64),
            mask=rng.random(ncs) < 0.04),
        "cs_call_center_sk": pa.array(
            rng.integers(1, ncc + 1, ncs).astype(np.int64)),
        "cs_catalog_page_sk": pa.array(
            rng.integers(1, ncp + 1, ncs).astype(np.int64)),
    })


def _web_sales(rng, sz: _Sizes, t) -> pa.Table:
    nws, nc, ncd, nhd, nca = sz.nws, sz.nc, sz.ncd, sz.nhd, sz.nca
    return _sales_channel(rng, sz, "ws", nws, 4, {
        "ws_bill_customer_sk": pa.array(
            rng.integers(1, nc + 1, nws).astype(np.int64)),
        "ws_bill_cdemo_sk": pa.array(
            rng.integers(1, ncd + 1, nws).astype(np.int64)),
        "ws_bill_hdemo_sk": pa.array(
            rng.integers(1, nhd + 1, nws).astype(np.int64)),
        "ws_bill_addr_sk": pa.array(
            rng.integers(1, nca + 1, nws).astype(np.int64)),
        "ws_ship_customer_sk": pa.array(
            rng.integers(1, nc + 1, nws).astype(np.int64),
            mask=rng.random(nws) < 0.04),
        "ws_ship_addr_sk": pa.array(
            rng.integers(1, nca + 1, nws).astype(np.int64)),
        "ws_web_site_sk": pa.array(
            rng.integers(1, 13, nws).astype(np.int64)),
        "ws_web_page_sk": pa.array(
            rng.integers(1, 61, nws).astype(np.int64)),
    })


def _correlate_catalog_sales(rng, sz: _Sizes, t) -> pa.Table:
    """catalog_sales with ~1/3 of its orders moved onto store-returned
    (customer, item) pairs, so cross-channel repurchase chains
    (q17/q25/q29/q64) select rows even at tiny scale factors."""
    nsr, ncs = sz.nsr, sz.ncs
    sr_cust = np.asarray(t["store_returns"].column("sr_customer_sk"))
    sr_item = np.asarray(t["store_returns"].column("sr_item_sk"))
    n_corr = min(nsr, ncs // 3)
    corr_rows = rng.choice(ncs, n_corr, replace=False)
    pick = rng.integers(0, nsr, n_corr)
    cs_tbl = t["catalog_sales"]
    bill = np.asarray(cs_tbl.column("cs_bill_customer_sk")).copy()
    citem = np.asarray(cs_tbl.column("cs_item_sk")).copy()
    bill[corr_rows] = sr_cust[pick]
    citem[corr_rows] = sr_item[pick]
    cs_tbl = cs_tbl.set_column(
        cs_tbl.column_names.index("cs_bill_customer_sk"),
        "cs_bill_customer_sk", pa.array(bill))
    return cs_tbl.set_column(
        cs_tbl.column_names.index("cs_item_sk"), "cs_item_sk",
        pa.array(citem))


def _catalog_returns(rng, sz: _Sizes, t) -> pa.Table:
    nc, ncc, ncp, nwh = sz.nc, sz.ncc, sz.ncp, sz.nwh
    return _returns(rng, sz, "cr", t["catalog_sales"], "cs",
        lambda idx, nr, ra: {
            "cr_return_amount": ra,
            "cr_return_amt_inc_tax": np.round(ra * 1.08, 2),
            "cr_returning_customer_sk": pa.array(
                rng.integers(1, nc + 1, nr).astype(np.int64)),
            "cr_refunded_customer_sk": pa.array(np.asarray(
                t["catalog_sales"].column("cs_bill_customer_sk"))[idx]),
            "cr_call_center_sk": pa.array(
                rng.integers(1, ncc + 1, nr).astype(np.int64)),
            "cr_catalog_page_sk": pa.array(
                rng.integers(1, ncp + 1, nr).astype(np.int64)),
            "cr_warehouse_sk": pa.array(
                rng.integers(1, nwh + 1, nr).astype(np.int64)),
            "cr_store_credit": np.round(ra * 0.1, 2),
        })


def _web_returns(rng, sz: _Sizes, t) -> pa.Table:
    nc, ncd, nca = sz.nc, sz.ncd, sz.nca
    return _returns(rng, sz, "wr", t["web_sales"], "ws",
        lambda idx, nr, ra: {
            "wr_return_amt": ra,
            "wr_return_amt_inc_tax": np.round(ra * 1.08, 2),
            "wr_returning_customer_sk": pa.array(
                rng.integers(1, nc + 1, nr).astype(np.int64)),
            "wr_refunded_customer_sk": pa.array(np.asarray(
                t["web_sales"].column("ws_bill_customer_sk"))[idx]),
            "wr_refunded_cdemo_sk": pa.array(
                rng.integers(1, ncd + 1, nr).astype(np.int64)),
            "wr_returning_cdemo_sk": pa.array(
                rng.integers(1, ncd + 1, nr).astype(np.int64)),
            "wr_refunded_addr_sk": pa.array(
                rng.integers(1, nca + 1, nr).astype(np.int64)),
            "wr_web_page_sk": pa.array(
                rng.integers(1, 61, nr).astype(np.int64)),
        })


def _web_site(rng, sz: _Sizes, t) -> pa.Table:
    nwsite = sz.nwsite
    return pa.table({
        "web_site_sk": pa.array(np.arange(1, nwsite + 1,
                                          dtype=np.int64)),
        "web_site_id": [f"WEB{i:06d}" for i in range(1, nwsite + 1)],
        "web_name": [f"site-{i}" for i in range(1, nwsite + 1)],
        "web_company_name": rng.choice(["pri", "able", "ese", "anti",
                                        "cally"], nwsite).tolist(),
    })


def _web_page(rng, sz: _Sizes, t) -> pa.Table:
    nwp = sz.nwp
    return pa.table({
        "wp_web_page_sk": pa.array(np.arange(1, nwp + 1,
                                             dtype=np.int64)),
        "wp_char_count": pa.array(
            rng.integers(100, 8000, nwp).astype(np.int32)),
    })


def _inventory(rng, sz: _Sizes, t) -> pa.Table:
    """Weekly snapshots (every 7th date): one row per (week, warehouse)
    x a sampled item subset."""
    n_days, ni, nwh, items_per = sz.n_days, sz.ni, sz.nwh, sz.items_per
    inv_dates = np.arange(1, n_days + 1, 7, dtype=np.int64)
    inv_items = np.arange(1, ni + 1, dtype=np.int64)
    di, wi = np.meshgrid(inv_dates, np.arange(1, nwh + 1,
                                              dtype=np.int64))
    di, wi = di.ravel(), wi.ravel()
    reps = len(di)
    inv_item = rng.choice(inv_items, (reps, items_per))
    return pa.table({
        "inv_date_sk": pa.array(np.repeat(di, items_per)),
        "inv_warehouse_sk": pa.array(np.repeat(wi, items_per)),
        "inv_item_sk": pa.array(inv_item.ravel()),
        "inv_quantity_on_hand": pa.array(
            rng.integers(0, 1000, reps * items_per).astype(np.int32)),
    })


# (table, builder) in the reference generator's order of draws; the
# correlation step rewrites catalog_sales once web_sales is drawn
_BUILDERS = [
    ("date_dim", _date_dim), ("time_dim", _time_dim), ("item", _item),
    ("store", _store), ("customer_demographics", _customer_demographics),
    ("income_band", _income_band),
    ("household_demographics", _household_demographics),
    ("customer_address", _customer_address), ("customer", _customer),
    ("promotion", _promotion), ("store_sales", _store_sales),
    ("store_returns", _store_returns), ("call_center", _call_center),
    ("catalog_page", _catalog_page), ("warehouse", _warehouse),
    ("ship_mode", _ship_mode), ("reason", _reason),
    ("catalog_sales", _catalog_sales), ("web_sales", _web_sales),
    ("catalog_sales", _correlate_catalog_sales),
    ("catalog_returns", _catalog_returns), ("web_returns", _web_returns),
    ("web_site", _web_site), ("web_page", _web_page),
    ("inventory", _inventory),
]


def generate(sf: float = 0.001, seed: int = 0) -> Dict[str, pa.Table]:
    """dbgen-lite star schema at scale factor ``sf``."""
    return build_tables([name for name, _ in _BUILDERS], sf, seed)


def build_tables(names: Sequence[str], sf: float = 0.001,
                 seed: int = 0) -> Dict[str, pa.Table]:
    """The tables ``names`` at scale factor ``sf``: their builders run in
    the reference's order on one generator seeded with ``seed``.  A
    builder that reads another table (store_returns reads store_sales)
    needs it among ``names``."""
    rng = np.random.default_rng(seed)
    sz = _Sizes(sf)
    wanted = set(names)
    t: Dict[str, pa.Table] = {}
    for name, fn in _BUILDERS:
        if name in wanted:
            t[name] = fn(rng, sz, t)
    return t


def setup(session, tables: Dict[str, pa.Table]):
    return {name: session.create_dataframe(tbl)
            for name, tbl in tables.items()}


# ---------------------------------------------------------------------------
# Queries (validation parameters from the spec templates, simplified to
# this schema subset)
# ---------------------------------------------------------------------------

def q3(t):
    """Brand revenue for manufacturer 1..100 subset in month 11 by year."""
    return (t["date_dim"].filter(col("d_moy") == lit(11))
            .join(t["store_sales"],
                  col("d_date_sk") == col("ss_sold_date_sk"))
            .join(t["item"].filter(col("i_manufact_id") <= lit(100)),
                  col("ss_item_sk") == col("i_item_sk"))
            .group_by("d_year", "i_brand", "i_brand_id")
            .agg(F.sum("ss_ext_sales_price").alias("sum_agg"))
            .select(col("d_year"), col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), col("sum_agg"))
            .sort(col("d_year").asc(), col("sum_agg").desc(),
                  col("brand_id").asc())
            .limit(100))


def q7(t):
    """Item averages for a demographic slice with promo filter."""
    cd = t["customer_demographics"].filter(
        (col("cd_gender") == lit("M"))
        & (col("cd_marital_status") == lit("S"))
        & (col("cd_education_status") == lit("College")))
    promo = t["promotion"].filter(
        (col("p_channel_email") == lit("N"))
        | (col("p_channel_event") == lit("N")))
    return (t["store_sales"]
            .join(cd, col("ss_cdemo_sk") == col("cd_demo_sk"))
            .join(t["date_dim"].filter(col("d_year") == lit(2000)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
            .join(promo, col("ss_promo_sk") == col("p_promo_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .group_by("i_item_id")
            .agg(F.avg("ss_quantity").alias("agg1"),
                 F.avg("ss_list_price").alias("agg2"),
                 F.avg("ss_coupon_amt").alias("agg3"),
                 F.avg("ss_sales_price").alias("agg4"))
            .sort("i_item_id")
            .limit(100))


def q19(t):
    """Brand revenue where customer and store are in different zips."""
    return (t["date_dim"].filter((col("d_moy") == lit(11))
                                 & (col("d_year") == lit(1999)))
            .join(t["store_sales"],
                  col("d_date_sk") == col("ss_sold_date_sk"))
            .join(t["item"].filter(col("i_manager_id") <= lit(20)),
                  col("ss_item_sk") == col("i_item_sk"))
            .join(t["customer"],
                  col("ss_customer_sk") == col("c_customer_sk"))
            .join(t["customer_address"],
                  col("c_current_addr_sk") == col("ca_address_sk"))
            .join(t["store"], col("ss_store_sk") == col("s_store_sk"))
            .filter(F.substring(col("ca_zip"), 1, 5)
                    != F.substring(col("s_zip"), 1, 5))
            .group_by("i_brand", "i_brand_id", "i_manufact_id")
            .agg(F.sum("ss_ext_sales_price").alias("ext_price"))
            .select(col("i_brand").alias("brand"),
                    col("i_brand_id").alias("brand_id"),
                    col("i_manufact_id"), col("ext_price"))
            .sort(col("ext_price").desc(), col("brand_id").asc(),
                  col("i_manufact_id").asc())
            .limit(100))


def q42(t):
    """Category revenue for one month/year."""
    return (t["date_dim"].filter((col("d_moy") == lit(11))
                                 & (col("d_year") == lit(2000)))
            .join(t["store_sales"],
                  col("d_date_sk") == col("ss_sold_date_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .group_by("d_year", "i_category_id", "i_category")
            .agg(F.sum("ss_ext_sales_price").alias("total"))
            .sort(col("total").desc(), col("d_year").asc(),
                  col("i_category_id").asc(), col("i_category").asc())
            .limit(100))


def q52(t):
    """Brand revenue for one month/year (q42 over brand)."""
    return (t["date_dim"].filter((col("d_moy") == lit(12))
                                 & (col("d_year") == lit(1998)))
            .join(t["store_sales"],
                  col("d_date_sk") == col("ss_sold_date_sk"))
            .join(t["item"], col("ss_item_sk") == col("i_item_sk"))
            .group_by("d_year", "i_brand", "i_brand_id")
            .agg(F.sum("ss_ext_sales_price").alias("ext_price"))
            .select(col("d_year"), col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), col("ext_price"))
            .sort(col("d_year").asc(), col("ext_price").desc(),
                  col("brand_id").asc())
            .limit(100))


def q55(t):
    """Brand revenue for one manager's items in one month."""
    return (t["date_dim"].filter((col("d_moy") == lit(11))
                                 & (col("d_year") == lit(1999)))
            .join(t["store_sales"],
                  col("d_date_sk") == col("ss_sold_date_sk"))
            .join(t["item"].filter(col("i_manager_id") == lit(28)),
                  col("ss_item_sk") == col("i_item_sk"))
            .group_by("i_brand", "i_brand_id")
            .agg(F.sum("ss_ext_sales_price").alias("ext_price"))
            .select(col("i_brand_id").alias("brand_id"),
                    col("i_brand").alias("brand"), col("ext_price"))
            .sort(col("ext_price").desc(), col("brand_id").asc())
            .limit(100))


def q68(t):
    """Per-ticket extended-price/ discount/ tax rollup for two cities
    (lite: no tax column, grouped on ticket + customer + city)."""
    hd = t["household_demographics"].filter(
        (col("hd_dep_count") == lit(4))
        | (col("hd_vehicle_count") == lit(3)))
    return (t["store_sales"]
            .join(t["date_dim"].filter(
                col("d_year").isin(1999, 2000)
                & (col("d_dom") >= lit(1)) & (col("d_dom") <= lit(2))),
                col("ss_sold_date_sk") == col("d_date_sk"))
            .join(t["store"].filter(
                col("s_city").isin("Midway", "Fairview")),
                col("ss_store_sk") == col("s_store_sk"))
            .join(hd, col("ss_hdemo_sk") == col("hd_demo_sk"))
            .join(t["customer_address"],
                  col("ss_addr_sk") == col("ca_address_sk"))
            .group_by("ss_ticket_number", "ss_customer_sk", "ca_city")
            .agg(F.sum("ss_ext_sales_price").alias("extended_price"),
                 F.sum("ss_ext_discount_amt").alias("extended_discount"))
            .join(t["customer"],
                  col("ss_customer_sk") == col("c_customer_sk"))
            .select("c_last_name", "c_first_name", "ca_city",
                    "ss_ticket_number", "extended_price",
                    "extended_discount")
            .sort("c_last_name", "ss_ticket_number")
            .limit(100))


def q73(t):
    """Ticket counts per household bucket, 1..5 items per ticket."""
    hd = t["household_demographics"].filter(
        col("hd_buy_potential").isin(">10000", "Unknown")
        & (col("hd_vehicle_count") > lit(0)))
    counts = (t["store_sales"]
              .join(t["date_dim"].filter(
                  (col("d_dom") >= lit(1)) & (col("d_dom") <= lit(2))
                  & col("d_year").isin(1999, 2000)),
                  col("ss_sold_date_sk") == col("d_date_sk"))
              .join(t["store"].filter(
                  col("s_number_employees") >= lit(200)),
                  col("ss_store_sk") == col("s_store_sk"))
              .join(hd, col("ss_hdemo_sk") == col("hd_demo_sk"))
              .group_by("ss_ticket_number", "ss_customer_sk")
              .agg(F.count("*").alias("cnt"))
              .filter((col("cnt") >= lit(1)) & (col("cnt") <= lit(5))))
    return (counts
            .join(t["customer"],
                  col("ss_customer_sk") == col("c_customer_sk"))
            .select("c_last_name", "c_first_name", "ss_ticket_number",
                    "cnt")
            .sort(col("cnt").desc(), col("c_last_name").asc())
            .limit(100))


def q96(t):
    """Sales count in a time window for busy households."""
    return (t["store_sales"]
            .join(t["time_dim"].filter((col("t_hour") == lit(20))
                                       & (col("t_minute") >= lit(30))),
                  col("ss_sold_time_sk") == col("t_time_sk"))
            .join(t["household_demographics"].filter(
                col("hd_dep_count") == lit(7)),
                col("ss_hdemo_sk") == col("hd_demo_sk"))
            .join(t["store"].filter(col("s_store_name") != lit("")),
                  col("ss_store_sk") == col("s_store_sk"))
            .agg(F.count("*").alias("cnt")))


def q98(t):
    """Item revenue + share of its class's revenue (window)."""
    base = (t["store_sales"]
            .join(t["item"].filter(
                col("i_category").isin("Sports", "Books", "Home")),
                col("ss_item_sk") == col("i_item_sk"))
            .join(t["date_dim"].filter(
                (col("d_date") >= lit(_dt.date(1999, 2, 22)))
                & (col("d_date") <= lit(_dt.date(1999, 3, 24)))),
                col("ss_sold_date_sk") == col("d_date_sk"))
            .group_by("i_item_id", "i_item_desc", "i_category",
                      "i_class", "i_current_price")
            .agg(F.sum("ss_ext_sales_price").alias("itemrevenue")))
    return (base.select(
                col("i_item_id"), col("i_item_desc"), col("i_category"),
                col("i_class"), col("i_current_price"),
                col("itemrevenue"),
                (col("itemrevenue") * lit(100.0)
                 / F.sum(col("itemrevenue")).over(
                     Window.partition_by("i_class"))).alias(
                     "revenueratio"))
            .sort("i_category", "i_class", "i_item_id", "i_item_desc",
                  "revenueratio"))


QUERIES = {"q3": q3, "q7": q7, "q19": q19, "q42": q42, "q52": q52,
           "q55": q55, "q68": q68, "q73": q73, "q96": q96, "q98": q98}


def _collect_extended():
    """Merge q1-q99 from the three query modules (all 99 present)."""
    from spark_rapids_tpu_torch.bench import (tpcds_queries_a,
                                              tpcds_queries_b,
                                              tpcds_queries_c)
    for mod in (tpcds_queries_a, tpcds_queries_b, tpcds_queries_c):
        for name, fn in vars(mod).items():
            if name.startswith("q") and name[1:].isdigit():
                QUERIES.setdefault(name, fn)


_collect_extended()
assert len(QUERIES) == 99, f"expected 99 TPC-DS queries, {len(QUERIES)}"
