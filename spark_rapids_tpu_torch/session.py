"""Session and DataFrame: the user's entry point.

Counterpart of ``spark_rapids_tpu/session.py:130-150,215-505``
(``_analyze``, ``GroupedData``, ``DataFrame``, ``TpuSession``): a user
builds DataFrame transformations or registers tables and writes SQL;
the session builds the operator tree, ``GpuOverrides`` plans it, and the
plan runs on the session's device (``cuda:0`` unless the caller passes
``device="cpu"``) and returns a pyarrow Table.

A grouped aggregation is planned as Spark plans it: a hash exchange over
``spark.sql.shuffle.partitions`` partitions, then the aggregate. The
analyzer widens mixed numeric operands with ``Cast`` (``_analyze``), as
the reference's does. ``union`` is UNION ALL; ``sample`` keeps a hash
of each row's global position under the fraction (``GpuSampleExec``);
``group_by(...).pivot(col[, values])`` rewrites each aggregate into one
``If``-masked aggregate a pivot value (Spark's analyzer rewrite), running
one query first for the distinct values when none are given; ``write``
and ``write_parquet`` run ``GpuFileWriteExec`` through the planner and
return the files; ``read_parquet``, ``read_csv``, ``read_json`` and
``read_orc`` (and ``_read`` for Hive text under an explicit schema)
build the file scan. ``sql("EXPLAIN ANALYZE [FORMATTED] ...")`` runs the query
in process, or across an attached ``GpuProcessCluster``'s workers
(``set_cluster``), and returns the plan annotated with each operator's
metrics, folded over the workers on the cluster (``:389-394,452-463``).

``DataFrame.cache()`` is the reference's ``TpuCacheExec`` (``:30-70``):
the child runs once into spill-catalog entries, which later runs replay
(uploaded again where the ledger spilled them). ``collect(qctx=...)``
takes a ``QueryContext`` from ``GpuSession.query_context`` (a deadline,
a tenant, a memory budget, a handle to ``cancel()``); without one the
conf's lifecycle defaults apply (``:349-410``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import pyarrow as pa

from . import datatypes as dt
from .config import CASE_SENSITIVE, SHUFFLE_PARTITIONS, RapidsConf
from .exec.base import (ExecCtx, GpuExec, HostBatchSourceExec, OpContract,
                        UnaryExec, resolve_device)
from .expr.base import Expression, Literal, UnresolvedColumn, bind_expr

__all__ = ["GpuSession", "DataFrame", "GroupedData", "PivotedData",
           "GpuCacheExec"]


class GpuCacheExec(UnaryExec):
    """``df.cache()``: the child materializes once into spillable
    catalog entries and every later run replays them; the CPU path
    keeps up to ``_CPU_CACHE_LIMIT`` bytes of Arrow batches, past which
    it runs the child again each time."""

    CONTRACT = OpContract(
        schema_preserving=True,
        notes="materializes once into the spill catalog and replays")

    _CPU_CACHE_LIMIT = 256 << 20

    def __init__(self, child: GpuExec):
        super().__init__(child)
        self._entries = None   # List[SpillableBatch]
        self._cpu_cache = None

    def describe(self):
        state = "cached" if self._entries is not None else "lazy"
        return f"CacheExec [{state}]"

    def with_new_children(self, children):
        # the planner rebuilds the tree a plan; the cache lives on the
        # node the DataFrame holds
        node = super().with_new_children(children)
        if node is not self:
            node._owner = getattr(self, "_owner", self)
        return node

    def _state(self) -> "GpuCacheExec":
        return getattr(self, "_owner", self)

    def execute(self, ctx: ExecCtx):
        owner = self._state()
        if owner._entries is None:
            entries = []
            try:
                for b in self.child.execute(ctx):
                    entries.append(ctx.mm.register(b))
            except BaseException:
                for sb in entries:
                    sb.release()
                raise
            owner._entries = entries
            import weakref
            for sb in entries:
                weakref.finalize(owner, type(sb).release, sb)
        ctx.metric(self, "cachedBatches").set(len(owner._entries))
        for sb in owner._entries:
            yield sb.get()

    def execute_cpu(self, ctx: ExecCtx):
        owner = self._state()
        if owner._cpu_cache is not None:
            yield from owner._cpu_cache
            return
        acc: Optional[list] = []
        total = 0
        for rb in self.child.execute_cpu(ctx):
            if acc is not None:
                total += rb.nbytes
                acc.append(rb)
                if total > self._CPU_CACHE_LIMIT:
                    acc = None
            yield rb
        if acc is not None:
            owner._cpu_cache = acc


def _decimal_operand(e: Expression) -> dt.DataType:
    """The decimal an integral operand of a decimal operation becomes:
    an integer literal's fewest digits, else ``DecimalType.forType``."""
    if isinstance(e, Literal) and isinstance(e.value, int) \
            and not isinstance(e.value, bool):
        return dt.literal_decimal(e.value)
    return dt.decimal_for(e.dtype)


def _coerce_decimal(node, left: Expression, right: Expression):
    """Spark's ``DecimalPrecision`` over a decimal and another number: a
    float side makes both double; an integral side becomes a decimal
    (``_decimal_operand``); a comparison then casts both to their wider
    decimal, while arithmetic keeps both (its result type is the
    operator's, ``expr/arithmetic.py``)."""
    from .expr.cast import Cast
    from .expr.predicates import BinaryComparison
    lt, rt = left.dtype, right.dtype
    if dt.is_floating(lt) or dt.is_floating(rt):
        targets = (dt.FLOAT64, dt.FLOAT64)
    else:
        targets = tuple(t if isinstance(t, dt.DecimalType)
                        else _decimal_operand(c)
                        for c, t in ((left, lt), (right, rt)))
        if isinstance(node, BinaryComparison) and targets[0] != targets[1]:
            w = dt.wider_decimal(*targets)
            targets = (w, w)
    new = [c if c.dtype == t else Cast(c, t)
           for c, t in zip((left, right), targets)]
    if new[0] is not left or new[1] is not right:
        return node.with_children(new)
    return node


def _analyze(e: Expression) -> Expression:
    """The analyzer slice the typed expressions expect (the reference's
    ``_analyze``, ``session.py:89``, Catalyst's TypeCoercion): a binary
    comparison or arithmetic over two numeric types casts both to their
    common type, and ``/`` over integral operands to double; with a
    decimal operand, Spark's ``DecimalPrecision`` (``_coerce_decimal``)."""
    from .expr.arithmetic import BinaryArithmetic, Divide
    from .expr.cast import Cast
    from .expr.predicates import BinaryComparison

    def coerce(node):
        if isinstance(node, (BinaryComparison, BinaryArithmetic)) \
                and len(node.children) == 2:
            left, right = node.children
            try:
                lt, rt = left.dtype, right.dtype
            except TypeError:
                return node
            if dt.is_numeric(lt) and dt.is_numeric(rt) and (
                    isinstance(lt, dt.DecimalType)
                    or isinstance(rt, dt.DecimalType)):
                return _coerce_decimal(node, left, right)
            if lt == rt and not isinstance(node, Divide):
                return node
            if dt.is_numeric(lt) and dt.is_numeric(rt):
                t = dt.common_type(lt, rt)
                if isinstance(node, Divide) and dt.is_integral(t):
                    t = dt.FLOAT64  # Spark's `/` is fractional
                new = [c if c.dtype == t else Cast(c, t)
                       for c in (left, right)]
                if new[0] is not left or new[1] is not right:
                    return node.with_children(new)
        return node

    return e.transform(coerce)


def coerce_join_keys(lk: Expression, rk: Expression):
    """Join keys of two numeric types, both cast to their common type."""
    from .expr.cast import Cast
    if lk.dtype != rk.dtype and dt.is_numeric(lk.dtype) \
            and dt.is_numeric(rk.dtype):
        t = dt.common_type(lk.dtype, rk.dtype)
        lk = lk if lk.dtype == t else Cast(lk, t)
        rk = rk if rk.dtype == t else Cast(rk, t)
    return lk, rk


def _as_expr(c) -> Expression:
    if isinstance(c, Expression):
        return c
    if isinstance(c, str):
        return UnresolvedColumn(c)
    raise TypeError(f"not a column: {c!r}")


class GroupedData:
    def __init__(self, df: "DataFrame", keys: List[Expression]):
        self._df = df
        self._keys = keys

    def agg(self, *agg_exprs) -> "DataFrame":
        """Exchange by the grouping keys (``spark.sql.shuffle.partitions``
        partitions, the plan shape Spark produces), then aggregate."""
        from .exec.aggregate import GpuHashAggregateExec
        from .exec.exchange import GpuShuffleExchangeExec
        from .shuffle.partitioner import HashPartitioning
        df = self._df
        child = df._node
        if self._keys:
            n = df._session.conf.get(SHUFFLE_PARTITIONS)
            child = GpuShuffleExchangeExec(HashPartitioning(self._keys, n),
                                           child)
        return DataFrame(GpuHashAggregateExec(self._keys, list(agg_exprs),
                                              child), df._session)

    def pivot(self, pivot_col, values=None) -> "PivotedData":
        """Spark's pivot, rewritten into one conditional aggregate a pivot
        value (``PivotedData.agg``); with ``values`` None the distinct
        non-null values are collected first, sorted (one more query)."""
        pe = self._df._bind(pivot_col)
        if values is None:
            from .expr.aggregates import Count
            from .expr.base import Alias
            distinct = GroupedData(self._df, [pe]).agg(
                Alias(Count(), "__n__")).collect()
            values = sorted(v for v in distinct.column(0).to_pylist()
                            if v is not None)
        return PivotedData(self._df, self._keys, pe, list(values))


class PivotedData:
    def __init__(self, df: "DataFrame", keys, pivot_expr, values):
        self._df = df
        self._keys = keys
        self._pivot = pivot_expr
        self._values = values

    def agg(self, *agg_exprs) -> "DataFrame":
        """One output column a (pivot value, aggregate): each aggregate's
        inputs masked to its value by ``If``, ``count(*)`` counting the
        rows of the value. One aggregate names its columns by the value
        alone, several by ``value_aggname``, as Spark does."""
        import copy
        from .expr.aggregates import AggregateFunction
        from .expr.base import Alias
        from .expr.conditional import If
        from .expr.predicates import EqualTo
        out = []
        multi = len(agg_exprs) > 1
        for v in self._values:
            cond = EqualTo(self._pivot, Literal(v, self._pivot.dtype))
            for e in agg_exprs:
                if isinstance(e, Alias):
                    fn, nm = e.child, e.name
                else:
                    fn, nm = e, e.pretty_name().lower()
                if not isinstance(fn, AggregateFunction):
                    raise TypeError(f"pivot agg must be an aggregate: "
                                    f"{e!r}")
                if fn.children:
                    # bound first: the null literal takes the child's type
                    clone = copy.copy(fn)
                    clone.children = tuple(
                        If(cond, c, Literal(None, c.dtype))
                        for c in (self._df._bind(c) for c in fn.children))
                else:
                    clone = type(fn)(If(cond, Literal(1, dt.INT32),
                                        Literal(None, dt.INT32)))
                out.append(Alias(clone, f"{v}_{nm}" if multi else str(v)))
        return GroupedData(self._df, self._keys).agg(*out)


class DataFrame:
    def __init__(self, node: GpuExec, session: "GpuSession"):
        self._node = node
        self._session = session

    @property
    def schema(self) -> dt.Schema:
        return self._node.output_schema

    def _bind(self, e) -> Expression:
        bound = bind_expr(_as_expr(e), self._node.output_schema,
                          case_sensitive=self._session.conf.get(
                              CASE_SENSITIVE), validate=False)
        analyzed = _analyze(bound)
        analyzed.transform(lambda n: (n.validate(), n)[1])
        return analyzed

    def _plan(self):
        from .planner import GpuOverrides
        return GpuOverrides(self._session.conf,
                            self._session.device).apply(self._node)

    def explain(self, mode: str = "ALL") -> str:
        return self._plan().explain(mode)

    # --- transformations --------------------------------------------------
    def select(self, *cols) -> "DataFrame":
        from .exec.basic import GpuProjectExec
        return DataFrame(GpuProjectExec([self._bind(c) for c in cols],
                                        self._node), self._session)

    def filter(self, cond) -> "DataFrame":
        from .exec.basic import GpuFilterExec
        return DataFrame(GpuFilterExec(self._bind(cond), self._node),
                         self._session)

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, [self._bind(k) for k in keys])

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None, build_unique: bool = False) -> "DataFrame":
        """Equi-join through the shuffled hash join: ``on`` is column
        name(s) both sides share, or ``(left, right)`` pairs.
        ``build_unique`` declares the right side's keys unique (checked
        at the download under ``spark.rapids.sql.join.verifyUniqueHint``).
        Without ``on`` the join is the nested-loop join, with
        ``condition`` over both sides' columns or none (every pair), as
        the reference's plan rules route it."""
        from .exec.joins import (GpuBroadcastNestedLoopJoinExec,
                                 GpuShuffledHashJoinExec)
        how = {"left": "left_outer", "right": "right_outer",
               "outer": "full_outer", "full": "full_outer",
               "semi": "left_semi", "anti": "left_anti"}.get(how, how)
        if on is None:
            return DataFrame(GpuBroadcastNestedLoopJoinExec(
                how, self._node, other._node, condition), self._session)
        if isinstance(on, str):
            on = [on]
        cs = self._session.conf.get(CASE_SENSITIVE)
        lkeys, rkeys = [], []
        for k in on:
            lk = _as_expr(k if not isinstance(k, tuple) else k[0])
            rk = _as_expr(k if not isinstance(k, tuple) else k[1])
            lk = bind_expr(lk, self._node.output_schema, case_sensitive=cs)
            rk = bind_expr(rk, other._node.output_schema,
                           case_sensitive=cs)
            lk, rk = coerce_join_keys(lk, rk)
            lkeys.append(lk)
            rkeys.append(rk)
        return DataFrame(GpuShuffledHashJoinExec(
            lkeys, rkeys, how, self._node, other._node, condition,
            build_unique_hint=build_unique), self._session)

    def order_by(self, *cols, ascending: Union[bool, Sequence[bool]] =
                 True) -> "DataFrame":
        from .exec.sort import GpuSortExec, SortOrder
        if isinstance(ascending, bool):
            ascending = [ascending] * len(cols)
        orders = [SortOrder(_as_expr(c), asc)
                  for c, asc in zip(cols, ascending)]
        return DataFrame(GpuSortExec(orders, self._node), self._session)

    def limit(self, n: int) -> "DataFrame":
        from .exec.sort import GpuGlobalLimitExec
        return DataFrame(GpuGlobalLimitExec(n, self._node), self._session)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position; the column types must agree."""
        from .exec.misc import GpuUnionExec
        return DataFrame(GpuUnionExec([self._node, other._node]),
                         self._session)

    def sample(self, fraction: float, seed: int = 42) -> "DataFrame":
        from .exec.misc import GpuSampleExec
        return DataFrame(GpuSampleExec(fraction, seed, self._node),
                         self._session)

    def explode(self, column, outer: bool = False,
                position: bool = False) -> "DataFrame":
        """One row an element of an array or map column (``posexplode``
        with ``position``, ``_outer`` with ``outer``), after the other
        columns; the element is ``col`` (a map's ``key`` and
        ``value``), the position ``pos``."""
        from .exec.generate import GpuGenerateExec
        return DataFrame(GpuGenerateExec(self._bind(column), self._node,
                                         outer=outer, position=position),
                         self._session)

    def cache(self) -> "DataFrame":
        return DataFrame(GpuCacheExec(self._node), self._session)

    def write(self, path: str, fmt: str = "parquet",
              partition_by=None) -> List[str]:
        """Write through ``GpuFileWriteExec`` (planned and run now);
        returns the part files. The planned write stays as
        ``last_write_plan``: its ``last_ctx`` holds the run's metrics,
        the writer's ``writeTime`` among them."""
        from .io.write import GpuFileWriteExec
        node = GpuFileWriteExec(self._node, path, fmt,
                                partition_by=partition_by,
                                conf=self._session.conf)
        from .planner import GpuOverrides
        self.last_write_plan = GpuOverrides(
            self._session.conf, self._session.device).apply(node)
        self.last_write_plan.collect()
        return list(node.written_files)

    def write_parquet(self, path: str, **kw) -> List[str]:
        return self.write(path, "parquet", **kw)

    # --- actions ----------------------------------------------------------
    def collect(self, qctx=None) -> pa.Table:
        """Run and download; ``qctx`` (``GpuSession.query_context``)
        carries the cancellation token, deadline, tenant and memory
        budget, else the conf's lifecycle defaults apply."""
        return self._plan().collect(qctx=qctx)


class GpuSession:
    """The SparkSession analog: a conf, a device, DataFrame constructors and
    a temp-view catalog for ``sql``."""

    def __init__(self, conf: Optional[Union[RapidsConf, Dict]] = None,
                 device=None):
        if isinstance(conf, dict):
            conf = RapidsConf(conf)
        self.conf = conf or RapidsConf()
        self.device = resolve_device(device)
        self._tables: Dict[str, DataFrame] = {}
        self._cluster = None  # set_cluster: EXPLAIN ANALYZE's target

    def set_cluster(self, cluster) -> None:
        """Attach a ``GpuProcessCluster``: ``EXPLAIN ANALYZE`` then runs
        across its workers (None detaches)."""
        self._cluster = cluster

    def query_context(self, **kw):
        """A ``lifecycle.QueryContext`` over this session's conf;
        ``deadline_s``, ``tenant``, ``budget_bytes`` and ``query_id``
        override it. ``qctx.cancel()`` stops the query between batches
        with ``QueryCancelled(reason="user")``."""
        from .lifecycle import QueryContext
        return QueryContext(self.conf, **kw)

    # --- SQL --------------------------------------------------------------
    def register_table(self, name: str, df) -> DataFrame:
        """A DataFrame (or anything ``create_dataframe`` takes) as a temp
        view for ``sql``; names resolve case-insensitively."""
        if not isinstance(df, DataFrame):
            df = self.create_dataframe(df)
        self._tables[name.lower()] = df
        return df

    def table(self, name: str) -> DataFrame:
        df = self._tables.get(name.lower())
        if df is None:
            raise KeyError(f"table or view {name!r} is not registered")
        return df

    def _catalog_node(self, name: str):
        """The SQL compiler's hook: a registered view's node, or None."""
        df = self._tables.get(name.lower())
        return df._node if df is not None else None

    def sql(self, text: str) -> Union[DataFrame, str]:
        """Compile one SQL statement into a DataFrame over the same
        planner path. ``EXPLAIN [FORMATTED] <query>`` returns the plan's
        text without running it; ``EXPLAIN ANALYZE [FORMATTED] <query>``
        runs the query in process and returns the executed plan with
        each operator's rows, batches, times and counters (FORMATTED:
        every metric). Parse and analysis errors raise
        ``SqlParseError`` / ``SqlAnalysisError`` and write one event-log
        line (its type the error's slug) when ``spark.rapids.eventLog
        .dir`` is set."""
        from .sql import SqlError, sql_to_plan
        from .tools.event_log import log_sql_error
        try:
            node, stmt = sql_to_plan(text, self)
        except SqlError as e:
            log_sql_error(self.conf, e, text)
            raise
        if stmt.explain:
            from .planner import GpuOverrides
            pp = GpuOverrides(self.conf, self.device).apply(node)
            if stmt.analyze:
                if self._cluster is not None:
                    return self._cluster.explain_analyze(
                        pp, formatted=stmt.formatted)
                pp.collect()
                return pp.explain_analyze(formatted=stmt.formatted)
            if stmt.formatted:
                return pp.root.tree_string()
            return pp.explain("ALL")
        return DataFrame(node, self)

    # --- constructors -----------------------------------------------------
    def create_dataframe(self, data) -> DataFrame:
        """From a pyarrow Table or RecordBatch, or a ``{name: list}``
        dict."""
        if isinstance(data, dict):
            data = pa.table(data)
        if isinstance(data, pa.Table):
            rbs = data.combine_chunks().to_batches()
            schema = data.schema
        elif isinstance(data, pa.RecordBatch):
            rbs, schema = [data], data.schema
        else:
            raise TypeError(f"cannot build a DataFrame from {type(data)}")
        from .columnar.arrow_bridge import engine_schema
        return DataFrame(HostBatchSourceExec(
            rbs, schema=engine_schema(schema)), self)

    def _read(self, paths, fmt: str, schema=None) -> DataFrame:
        from .io.scan import GpuFileScanExec
        if isinstance(paths, str):
            paths = [paths]
        return DataFrame(GpuFileScanExec(paths, fmt=fmt, schema=schema,
                                         conf=self.conf), self)

    def read_parquet(self, paths, schema=None) -> DataFrame:
        return self._read(paths, "parquet", schema)

    def read_csv(self, paths, schema=None) -> DataFrame:
        return self._read(paths, "csv", schema)

    def read_json(self, paths, schema=None) -> DataFrame:
        return self._read(paths, "json", schema)

    def read_orc(self, paths, schema=None) -> DataFrame:
        return self._read(paths, "orc", schema)
