"""The port and its smoke test import neither jax nor the JAX package,
and the smoke test refuses to report a result without a card."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "spark_rapids_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _port_files():
    out = [SMOKE]
    for root, _, files in os.walk(PORT):
        out.extend(os.path.join(root, f) for f in sorted(files)
                   if f.endswith(".py"))
    return out


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "spark_rapids_tpu", "bench")


JOIN_GROUPBY_MODULES = [
    "ops/sort_keys.py", "ops/segments.py", "ops/gather.py",
    "ops/concat.py", "ops/join.py", "exec/joins.py", "join_groupby.py"]
DECODE_MODULES = ["io/parquet_plan.py", "ops/parquet_decode.py",
                  "ops/kernel_checks.py"]
SQL_MODULES = [
    "ops/strings.py", "ops/hash.py", "shuffle/partitioner.py",
    "shuffle/transport.py", "exec/exchange.py", "exec/aqe.py",
    "exec/sort.py", "planner.py", "session.py", "sql/__init__.py",
    "sql/errors.py", "sql/ast.py", "sql/lexer.py", "sql/parser.py",
    "sql/functions.py", "sql/compiler.py", "nds.py", "tools/nds_trace.py"]
WINDOW_UNION_MODULES = ["expr/window.py", "exec/window.py", "exec/misc.py"]
# the staged join, APPROX_PERCENTILE and LIKE on K6, and K6's timing
# across trees
JOIN_PERCENTILE_LIKE_MODULES = ["ops/regex.py", "expr/strings.py",
                                "expr/aggregates.py", "exec/aggregate.py",
                                "tools/k6_bench.py"]
# the outer, cross and nested-loop joins and their SQL texts
OUTER_CROSS_MODULES = ["exec/joins.py", "ops/join.py",
                       "tools/nds_joins.py"]
# the per-operator CPU fallback and its SQL texts
FALLBACK_MODULES = ["exec/transitions.py", "exec/base.py", "planner.py",
                    "io/scan.py", "tools/nds_fallback.py"]
# the memory manager, the query lifecycle, sealed files and the
# out-of-core texts
MEMORY_MODULES = ["memory.py", "lifecycle.py", "shuffle/integrity.py",
                  "shuffle/transport.py", "exec/sort.py", "exec/window.py",
                  "exec/aggregate.py", "exec/aqe.py", "exec/joins.py",
                  "session.py", "tools/nds_memory.py"]
# the static plan verifier and the per-operator metrics
VERIFIER_OPMETRICS_MODULES = ["analysis/__init__.py",
                              "analysis/plan_verifier.py",
                              "obs/__init__.py", "obs/opmetrics.py",
                              "exec/base.py", "planner.py", "session.py"]
# the telemetry: tracer, registry, flight recorder, anomaly bundles,
# warehouse, attribution and the event log
TELEMETRY_MODULES = ["obs/tracer.py", "obs/metrics.py", "obs/recorder.py",
                     "obs/anomaly.py", "obs/warehouse.py",
                     "obs/attribution.py", "tools/event_log.py"]


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 10
    for rel in JOIN_GROUPBY_MODULES + DECODE_MODULES + SQL_MODULES \
            + WINDOW_UNION_MODULES + JOIN_PERCENTILE_LIKE_MODULES \
            + OUTER_CROSS_MODULES + FALLBACK_MODULES + MEMORY_MODULES \
            + VERIFIER_OPMETRICS_MODULES + TELEMETRY_MODULES:
        assert os.path.join(PORT, rel) in files, rel
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module or ""]
            elif isinstance(node, ast.Call) \
                    and getattr(node.func, "attr", None) == "import_module":
                names = [a.value for a in node.args
                         if isinstance(a, ast.Constant)]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def _smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(alone, tmp_path):
    script = SMOKE
    if alone:
        script = shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    r = _smoke(str(tmp_path), str(script))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_q6_trace_needs_a_card():
    from spark_rapids_tpu_torch.tools import q6_trace
    if not q6_trace.torch.cuda.is_available():
        with pytest.raises(SystemExit):
            q6_trace.trace_q6()


def test_join_trace_needs_a_card():
    from spark_rapids_tpu_torch.tools import join_trace
    if not join_trace.torch.cuda.is_available():
        with pytest.raises(SystemExit):
            join_trace.trace_join()
    assert join_trace._union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_nds_trace_needs_a_card():
    from spark_rapids_tpu_torch.tools import nds_trace
    if not nds_trace.torch.cuda.is_available():
        with pytest.raises(SystemExit):
            nds_trace.trace_nds()


def test_sql_modules_import_without_a_card():
    import importlib
    for rel in SQL_MODULES + WINDOW_UNION_MODULES \
            + JOIN_PERCENTILE_LIKE_MODULES + OUTER_CROSS_MODULES:
        importlib.import_module("spark_rapids_tpu_torch."
                                + rel[:-3].replace("/", ".")
                                .replace(".__init__", ""))
