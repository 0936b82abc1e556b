"""Shared parts of the CPU-fallback tests (``tests/test_torch_fallback.py``,
``tests/test_torch_fallback_switches.py``): the NDS tables at 2^12
store_sales rows written once a module, the reference's all-CPU rows
(``spark.rapids.sql.enabled=false``, its ``execute_cpu`` at every node:
no JAX compile, a tenth of a second to a few seconds a query), computed
once a text and conf, and the reference's placement from planning
alone.

``check_text`` runs one text on the port (``device="cpu"``) under a
conf, holds its rows to the reference's all-CPU rows
(``torch_dual_run.assert_same_rows``: ints, strings and nulls exact,
floats rel 1e-9, the row order exact under an outermost ORDER BY) and
its ``fallback_nodes()`` to the reference's under the same conf."""
from typing import Dict, Optional

import pyarrow as pa

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.planner import GpuOverrides
from torch_dual_run import assert_same_rows, is_ordered, run_reference

N_SALES = 1 << 12

_REF_ROWS: Dict[tuple, pa.Table] = {}


def _key(sql: str, conf: Optional[dict]) -> tuple:
    return sql, tuple(sorted((conf or {}).items()))


def reference_cpu_rows(sql: str, paths, conf: Optional[dict] = None) \
        -> pa.Table:
    """The reference's rows with every node on its CPU path, once a
    text and conf."""
    key = _key(sql, conf)
    if key not in _REF_ROWS:
        c = dict(conf or {})
        c["spark.rapids.sql.enabled"] = "false"
        _REF_ROWS[key] = run_reference(sql, paths, c)[0]
    return _REF_ROWS[key]


def reference_fallback(sql: str, paths, conf: Optional[dict] = None):
    """The reference's ``fallback_nodes()`` and ``NOT_ON_GPU`` explain
    text under ``conf``, from planning alone."""
    from spark_rapids_tpu.planner import TpuOverrides
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.tools import nds as jnds
    s = TpuSession(conf=dict(conf or {}))
    jnds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    pp = TpuOverrides(s.conf).apply(s.sql(sql)._node)
    return pp.fallback_nodes(), pp.explain("NOT_ON_GPU")


def port_plan(sql: str, paths, conf: Optional[dict] = None):
    s = nds.session_over_files(paths, dict(conf or {}), device="cpu")
    return GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)


def check_text(sql: str, paths, conf: Optional[dict] = None,
               label: str = "") -> "object":
    """The port's rows and placement against the reference's (module
    docstring); returns the port's physical plan."""
    pp = port_plan(sql, paths, conf)
    got = pp.collect()
    assert_same_rows(got, reference_cpu_rows(sql, paths, conf),
                     is_ordered(sql), label=label)
    assert pp.fallback_nodes() == reference_fallback(sql, paths, conf)[0], \
        label
    return pp
