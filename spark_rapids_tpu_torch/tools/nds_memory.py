"""Five SQL texts over the NDS tables whose working set is larger than the
device budget they run under, each with its conf and an oracle in numpy
and pyarrow: the memory manager's out-of-core paths.

    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_memory as nm
    conf = nm.conf_for("q_sales_sorted", 64 << 10)
    s = nds.session_over_files(paths, conf, device="cpu")
    got = s.sql(nm.SQL_QUERIES["q_sales_sorted"]).collect()
    want = nm.oracle("q_sales_sorted", nds.gen_tables(1 << 14))

- ``q_sales_sorted``: every store_sales row by customer, date, item and
  profit, a global ORDER BY over every selected column (the generator
  has no unique key, so a tie is a duplicate row). It sorts out of core
  (``exec/sort._sort_out_of_core``), and a cut
  ``spark.rapids.memory.host.spillStorageSize`` sends its runs on to
  sealed disk files. Users: analysts exporting ranked extracts.
- ``q_last_purchase``: each customer's latest purchase,
  ``ROW_NUMBER() OVER (PARTITION BY ss_customer_sk ORDER BY
  ss_sold_date_sk DESC, ss_item_sk DESC, ss_net_profit DESC)``, ``rn =
  1``; the order keys are the output columns, so the pick is
  deterministic in them. It takes the bucketed window
  (``exec/window._execute_bucketed``). Users: "latest purchase per
  customer" reports.
- ``q_customer_items``: revenue and sales by (customer, item), nearly one
  group a row; the partials merge in bounded rounds
  (``exec/aggregate._merge_bounded``). Users: recommendation feature
  extracts.
- ``q_percentile``: NDS's median sale price by state; the exact
  percentile's single pass sends an input over half the budget to its
  CPU run.
- ``q3``: NDS q3, run at 16 partitions: the shuffle's map entries spill
  and come back at their reads.

``conf_for(q, budget)`` is the text's conf under a device budget of
``budget`` bytes (``spark.rapids.memory.device.budgetBytes``), with the
host spill tier cut to half of it for ``q_sales_sorted``. ``CONF`` holds
the confs at 2^22 store_sales rows: a budget of 64 MiB for every text.
The reasons: at 2^22 rows the sort's four selected columns hold 128 MiB
on the device (past ``budget // 2``, the out-of-core cut), the window's
input as much (``ceil(total / (budget // 4))``, about 9 buckets), the
aggregate's partials several hundred MiB (past ``budget // 4``, the
bounded merge's cut), the percentile's (state, price) input some
70 MiB (past ``budget // 2``), and q3's map batches more than the
budget, so the ledger spills them; the host tier's 32 MiB is less than
the sort's runs, which go on to disk. ``FLOAT_COLUMNS`` names the output
columns that hold float sums (compared at a relative tolerance); every
other column is compared exactly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import pyarrow as pa

from .. import nds
from ..nds import _ss

__all__ = ["SQL_QUERIES", "QUERIES", "CONF", "FLOAT_COLUMNS", "PARTITIONS",
           "conf_for", "oracle", "CHIP_BUDGET"]

SQL_QUERIES = {
    "q_sales_sorted": """
SELECT ss_customer_sk, ss_sold_date_sk, ss_item_sk, ss_net_profit
FROM store_sales
ORDER BY ss_customer_sk, ss_sold_date_sk, ss_item_sk, ss_net_profit
""",
    "q_last_purchase": """
SELECT ss_customer_sk, ss_sold_date_sk, ss_item_sk, ss_net_profit
FROM (SELECT ss_customer_sk, ss_sold_date_sk, ss_item_sk, ss_net_profit,
             ROW_NUMBER() OVER (PARTITION BY ss_customer_sk
                                ORDER BY ss_sold_date_sk DESC,
                                         ss_item_sk DESC,
                                         ss_net_profit DESC) AS rn
      FROM store_sales) ranked
WHERE rn = 1
ORDER BY ss_customer_sk
""",
    "q_customer_items": """
SELECT ss_customer_sk, ss_item_sk, SUM(ss_ext_sales_price) AS revenue,
       COUNT(*) AS n_sales
FROM store_sales
GROUP BY ss_customer_sk, ss_item_sk
ORDER BY ss_customer_sk, ss_item_sk
""",
    "q_percentile": nds.SQL_QUERIES["q_percentile"],
    "q3": nds.SQL_QUERIES["q3"],
}

QUERIES = tuple(SQL_QUERIES)

#: the partition counts each text runs at on the card
PARTITIONS = {q: (1, 16) for q in QUERIES}
PARTITIONS["q3"] = (16,)

#: the device budget every text runs under at 2^22 store_sales rows
CHIP_BUDGET = 64 << 20


def conf_for(q: str, budget: int) -> Dict[str, str]:
    """The text's conf under a device budget of ``budget`` bytes."""
    conf = {"spark.rapids.memory.device.budgetBytes": str(budget)}
    if q == "q_sales_sorted":
        conf["spark.rapids.memory.host.spillStorageSize"] = str(budget // 2)
    return conf


CONF = {q: conf_for(q, CHIP_BUDGET) for q in QUERIES}

FLOAT_COLUMNS = {"q_sales_sorted": (), "q_last_purchase": (),
                 "q_customer_items": ("revenue",), "q_percentile": (),
                 "q3": ("sum_agg",)}


def _sales(tables):
    return (_ss(tables, "ss_customer_sk"), _ss(tables, "ss_sold_date_sk"),
            _ss(tables, "ss_item_sk"), _ss(tables, "ss_net_profit"))


def _table(cust, day, item, profit) -> pa.Table:
    return pa.table({"ss_customer_sk": pa.array(cust, pa.int64()),
                     "ss_sold_date_sk": pa.array(day, pa.int64()),
                     "ss_item_sk": pa.array(item, pa.int64()),
                     "ss_net_profit": pa.array(profit, pa.float64())})


def _q_sales_sorted(tables):
    cust, day, item, profit = _sales(tables)
    order = np.lexsort((profit, item, day, cust))
    return _table(cust[order], day[order], item[order], profit[order])


def _q_last_purchase(tables):
    cust, day, item, profit = _sales(tables)
    # ascending by customer, then the window's order (all descending)
    order = np.lexsort((-profit, -item, -day, cust))
    first = np.ones(len(order), bool)
    first[1:] = cust[order][1:] != cust[order][:-1]
    pick = order[first]
    return _table(cust[pick], day[pick], item[pick], profit[pick])


def _q_customer_items(tables):
    cust, _, item, _ = _sales(tables)
    revenue = _ss(tables, "ss_ext_sales_price")
    n_items = int(item.max()) + 1 if len(item) else 1
    key = cust * n_items + item
    uniq, inv = np.unique(key, return_inverse=True)
    return pa.table({
        "ss_customer_sk": pa.array(uniq // n_items, pa.int64()),
        "ss_item_sk": pa.array(uniq % n_items, pa.int64()),
        "revenue": pa.array(np.bincount(inv, weights=revenue,
                                        minlength=len(uniq)), pa.float64()),
        "n_sales": pa.array(np.bincount(inv, minlength=len(uniq)),
                            pa.int64())})


_ORACLES = {"q_sales_sorted": _q_sales_sorted,
            "q_last_purchase": _q_last_purchase,
            "q_customer_items": _q_customer_items,
            "q_percentile": lambda t: nds.oracle("q_percentile", t),
            "q3": lambda t: nds.oracle("q3", t)}


def oracle(name: str, tables: Dict[str, pa.Table]) -> pa.Table:
    """The query's rows from numpy and pyarrow over the same tables, in
    its output order."""
    return _ORACLES[name](tables)
