"""The dual-run assert: one SQL text through the JAX package's
``TpuSession`` and through the port's ``GpuSession(device="cpu")`` over
the same Parquet files with the same conf, the Arrow outputs compared.

    from torch_dual_run import dual_run, assert_same_rows
    port, ref = dual_run(sql, paths, {"spark.sql.shuffle.partitions": "16"})

``assert_same_rows`` holds the port to the reference:

- column names and Arrow types equal;
- integers, booleans, strings and nulls equal bit for bit;
- floats within a relative ``FLOAT_RTOL`` = 1e-9 (a sum's order of
  additions differs between the packages), NaN equal to NaN;
- the row order exact where the query orders its output (its outermost
  ORDER BY), else the rows compared as sorted multisets.

``dual_run`` also holds the scans' ``deviceChunks`` and
``fallbackChunks`` of both runs equal. ``dual_run_frames`` does the same
for a DataFrame builder ``build(session, E)`` (``tools/nds_nested``'s
texts), ``E`` each package's expression namespace
(``nds_nested.namespace``), so one text runs through both packages;
where the reference must read its files another way (``ref_conf``),
the port's scan counters are held to ``port_chunks`` instead.

Importing the module sets two things for the test process (every
pytest-xdist worker collects every test file, so every worker imports
it): the JAX package's compiled programs go to a persistent compilation
cache under the temporary directory, shared by the workers, so a
program one file compiled (the NDS scans of the 2^14-row tables, their
joins and exchanges, which many files run) is read back in the next;
and torch runs one intra-op thread, so the six workers of the tier-1 run
do not each spread their small CPU ops over every core. Neither changes
a result: the cache is keyed by the program, and the tests' tensors are
small.
"""
from __future__ import annotations

import math
import os
import tempfile
from typing import Dict, Optional, Tuple

import pyarrow as pa

FLOAT_RTOL = 1e-9


def _test_process_settings() -> None:
    import jax
    import torch
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        tempfile.gettempdir(), "spark_rapids_torch_tests_xla_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    torch.set_num_threads(1)


_test_process_settings()


def scan_chunks(metrics) -> list:
    """Sorted ``(deviceChunks, fallbackChunks)`` of every scan, from
    either package's ctx metrics (None where a scan keeps no such
    counter: the host-decode path)."""
    return sorted(tuple(m[k].value if k in m else None
                        for k in ("deviceChunks", "fallbackChunks"))
                  for label, m in metrics.items()
                  if label.startswith("FileScanExec"))


def run_reference(sql: str, paths: Dict[str, str],
                  conf: Optional[dict] = None) -> Tuple[pa.Table, list]:
    """The JAX package's rows and scan counters."""
    from spark_rapids_tpu.exec.base import ExecCtx
    from spark_rapids_tpu.planner import TpuOverrides
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.tools import nds as jnds
    s = TpuSession(conf=dict(conf or {}))
    jnds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    pp = TpuOverrides(s.conf).apply(s.sql(sql)._node)
    ctx = ExecCtx(s.conf)
    return pp.collect(ctx), scan_chunks(ctx.metrics)


def run_port(sql: str, paths: Dict[str, str],
             conf: Optional[dict] = None,
             metrics: Optional[dict] = None) -> Tuple[pa.Table, list]:
    """The port's rows and scan counters, on the CPU; with ``metrics``
    (a dict), the run's operator metrics too, ``{label: {name:
    value}}``."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.planner import GpuOverrides
    s = nds.session_over_files(paths, conf, device="cpu")
    pp = GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)
    ctx = ExecCtx(s.conf, "cpu")
    out = pp.collect(ctx)
    if metrics is not None:
        metrics.update({label: {k: m.value for k, m in ms.items()}
                        for label, ms in ctx.metrics.items()})
    return out, scan_chunks(ctx.metrics)


def _reference_namespace():
    from spark_rapids_tpu import datatypes, expr
    from spark_rapids_tpu.expr import aggregates
    from spark_rapids_tpu_torch.tools.nds_nested import namespace
    return namespace(expr, aggregates, datatypes)


def run_reference_frames(build, paths: Dict[str, str],
                         conf: Optional[dict] = None, namespace=None):
    """The JAX package's rows, scan counters and planned plan for a
    builder (``namespace``: its ``E``, ``nds_nested``'s by default)."""
    from spark_rapids_tpu.exec.base import ExecCtx
    from spark_rapids_tpu.planner import TpuOverrides
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.tools import nds as jnds
    s = TpuSession(conf=dict(conf or {}))
    jnds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    pp = TpuOverrides(s.conf).apply(
        build(s, namespace or _reference_namespace())._node)
    ctx = ExecCtx(s.conf)
    return pp.collect(ctx), scan_chunks(ctx.metrics), pp


def run_port_frames(build, paths: Dict[str, str],
                    conf: Optional[dict] = None, namespace=None):
    """The port's rows, scan counters and planned plan for a builder, on
    the CPU (``namespace``: its ``E``, ``nds_nested``'s by default)."""
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.exec.base import ExecCtx
    from spark_rapids_tpu_torch.planner import GpuOverrides
    from spark_rapids_tpu_torch.tools.nds_nested import port_namespace
    s = nds.session_over_files(paths, conf, device="cpu")
    pp = GpuOverrides(s.conf, s.device).apply(
        build(s, namespace or port_namespace())._node)
    ctx = ExecCtx(s.conf, "cpu")
    return pp.collect(ctx), scan_chunks(ctx.metrics), pp


def dual_run_frames(build, paths: Dict[str, str],
                    conf: Optional[dict] = None, ordered: bool = True,
                    ref_conf: Optional[dict] = None,
                    port_chunks=None, label: str = "", namespaces=None):
    """``dual_run`` for a builder: rows and types held to the
    reference's (``ordered``: the row order too), the scan counters to
    the reference's or to ``port_chunks(port's plan)``. ``ref_conf``
    adds settings to the reference's run only; ``namespaces`` is
    ``(port's E, reference's E)`` where the builder needs other names
    than ``nds_nested``'s. Returns ``(port's table, reference's table,
    port's plan, reference's plan)``."""
    port_ns, ref_ns = namespaces or (None, None)
    got, got_chunks, pp = run_port_frames(build, paths, conf, port_ns)
    want, want_chunks, jpp = run_reference_frames(
        build, paths, dict(conf or {}, **(ref_conf or {})), ref_ns)
    assert_same_rows(got, want, ordered, label=label)
    need = want_chunks if port_chunks is None \
        else sorted(port_chunks(pp))
    assert got_chunks == need, (got_chunks, need)
    return got, want, pp, jpp


def is_ordered(sql: str) -> bool:
    """The query orders its output: its outermost ORDER BY."""
    from spark_rapids_tpu_torch.sql import parse_statement
    return bool(parse_statement(sql).query.order_by)


def _key(v):
    if v is None:
        return (0, "")
    if isinstance(v, float) and math.isnan(v):
        return (2, "")
    return (1, repr(v) if not isinstance(v, (int, float)) else v)


def _sorted_rows(t: pa.Table):
    rows = list(zip(*[t.column(c).to_pylist() for c in t.column_names]))
    return sorted(rows, key=lambda r: tuple(_key(v) for v in r))


def _same_value(a, b, is_float: bool, rtol: float = FLOAT_RTOL) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if is_float:
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or math.isclose(a, b, rel_tol=rtol)
    return type(a) is type(b) and a == b


def assert_same_rows(got: pa.Table, want: pa.Table, ordered: bool,
                     label: str = "", rtol: float = FLOAT_RTOL) -> None:
    """The port's table against the reference's (module docstring);
    ``rtol=0`` holds floats exactly."""
    assert got.column_names == want.column_names, \
        (label, got.column_names, want.column_names)
    assert got.schema.types == want.schema.types, \
        (label, got.schema.types, want.schema.types)
    assert got.num_rows == want.num_rows, (label, got.num_rows,
                                           want.num_rows)
    floats = [pa.types.is_floating(t) for t in got.schema.types]
    if ordered:
        g = list(zip(*[got.column(c).to_pylist()
                       for c in got.column_names]))
        w = list(zip(*[want.column(c).to_pylist()
                       for c in want.column_names]))
    else:
        g, w = _sorted_rows(got), _sorted_rows(want)
    for i, (gr, wr) in enumerate(zip(g, w)):
        for name, a, b, f in zip(got.column_names, gr, wr, floats):
            assert _same_value(a, b, f, rtol), (label, i, name, a, b)


def dual_run(sql: str, paths: Dict[str, str],
             conf: Optional[dict] = None,
             port_metrics: Optional[dict] = None) \
        -> Tuple[pa.Table, pa.Table]:
    """Run ``sql`` through both packages and hold the port to the
    reference: rows (``assert_same_rows``) and scan counters. Returns
    ``(port's table, reference's table)``; ``port_metrics`` (a dict)
    receives the port run's operator metrics."""
    got, got_chunks = run_port(sql, paths, conf, port_metrics)
    want, want_chunks = run_reference(sql, paths, conf)
    assert_same_rows(got, want, is_ordered(sql), label=sql.strip()[:60])
    assert got_chunks == want_chunks, (got_chunks, want_chunks)
    return got, want
