"""The host-file shuffle (``shuffle/host.py``), the port against the JAX
package on the CPU.

Both packages' ``HostShuffleTransport`` take the same map batches (made
with numpy from a seed) and the same ``HashPartitioning``, in ``HOST``
and ``MULTITHREADED`` mode and with each Arrow IPC codec: every
partition's rows and ``partition_stats`` equal the reference's exactly.
The attempt protocol: the first commit wins, a zombie's files never
show, staging is invisible until its commit, an aborted attempt and an
unregistered shuffle leave nothing, and ``snappy`` is refused as in the
reference. A few corpus texts run through ``GpuSession`` with
``spark.rapids.shuffle.mode=HOST`` and ``MULTITHREADED`` at 16
partitions, their rows equal to the reference's in-process run
(``tests/torch_dual_run.run_reference``), and ``ICI`` raises naming
ROADMAP item 17."""
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.arrow_bridge import arrow_to_device as j_up
from spark_rapids_tpu.columnar.arrow_bridge import device_to_arrow as j_down
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu.shuffle.host import HostShuffleTransport as JHost
from spark_rapids_tpu.shuffle.partitioner import HashPartitioning as JHash
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.columnar import arrow_to_device
from spark_rapids_tpu_torch.columnar.arrow_bridge import (device_to_arrow,
                                                          engine_schema)
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.shuffle import integrity
from spark_rapids_tpu_torch.shuffle.host import HostShuffleTransport
from spark_rapids_tpu_torch.shuffle.partitioner import HashPartitioning
from torch_dual_run import assert_same_rows, run_port, run_reference

CPU = torch.device("cpu")
N_PARTS = 5


def _map_batches(seed=11, n_batches=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = int(rng.integers(40, 120))
        k = rng.integers(0, 17, n).astype(np.int64)
        v = rng.normal(size=n)
        s = [None if x % 7 == 0 else f"s{x}-{i}" for x in
             rng.integers(0, 50, n)]
        kmask = rng.random(n) < 0.1
        out.append(pa.record_batch({
            "k": pa.array(k, mask=kmask),
            "v": pa.array(v),
            "s": pa.array(s, pa.string())}))
    return out


def _write_port(t, rbs, sid, subdir=None, task=None):
    schema = engine_schema(rbs[0].schema)
    part = HashPartitioning([tcol("k"), tcol("s")], N_PARTS).bind(schema)
    t.register_shuffle(sid, N_PARTS)
    for i, rb in enumerate(rbs):
        b = arrow_to_device(rb, schema, CPU)
        pids = part.partition_ids(b, None)
        w = t.writer(sid, i, subdir=subdir)
        w.write_unsplit(b, pids)
        w.close()


def _write_ref(t, rbs, sid):
    from spark_rapids_tpu.columnar.arrow_bridge import engine_schema as jes
    schema = jes(rbs[0].schema)
    part = JHash([jcol("k"), jcol("s")], N_PARTS).bind(schema)
    t.register_shuffle(sid, N_PARTS)
    for i, rb in enumerate(rbs):
        b = j_up(rb, schema)
        pids = part.partition_ids_device(b, None)
        w = t.writer(sid, i)
        w.write_unsplit(b, pids)
        w.close()


def _read_port(t, sid, p):
    return [device_to_arrow(b) for b in t.read_partition(sid, p)]


def _read_ref(t, sid, p):
    return [j_down(b) for b in t.read_partition(sid, p)]


def _rows(rbs):
    return [r for rb in rbs for r in rb.to_pylist()]


@pytest.mark.parametrize("codec", ["none", "lz4", "zstd"])
@pytest.mark.parametrize("threads", [0, 2], ids=["HOST", "MULTITHREADED"])
def test_partitions_and_stats_equal_the_reference(codec, threads, tmp_path):
    rbs = _map_batches()
    settings = {"spark.rapids.shuffle.compression.codec": codec}
    port = HostShuffleTransport(RapidsConf(settings), threads=threads,
                                root=str(tmp_path / "port"))
    ref = JHost(JConf(settings), threads=threads,
                root=str(tmp_path / "ref"))
    try:
        _write_port(port, rbs, 1)
        _write_ref(ref, rbs, 1)
        seen = 0
        for p in range(N_PARTS):
            got, want = _read_port(port, 1, p), _read_ref(ref, 1, p)
            assert _rows(got) == _rows(want), p
            seen += sum(rb.num_rows for rb in got)
        assert seen == sum(rb.num_rows for rb in rbs)
        assert port.partition_stats(1) == ref.partition_stats(1)
        assert port.stage_bytes(1) == ref.stage_bytes(1)
        # a transport that did not write the shuffle reads the stats from
        # the committed manifests: none here (direct writes), so None,
        # as the reference's
        fresh = HostShuffleTransport(RapidsConf(settings), threads=0,
                                     root=port.root)
        jfresh = JHost(JConf(settings), threads=0, root=ref.root)
        assert fresh.partition_stats(1) == jfresh.partition_stats(1)
    finally:
        port.close()
        ref.close()


def _attempt(t, rbs, sid, task, attempt):
    d = t.begin_task_attempt(sid, task, attempt)
    _write_port(t, rbs, sid, subdir=d)
    return d


def test_first_commit_wins_and_staging_is_invisible(tmp_path):
    rbs = _map_batches(seed=3, n_batches=2)
    t = HostShuffleTransport(RapidsConf(), threads=0, root=str(tmp_path))
    sdir = os.path.join(t.root, "s7")
    _attempt(t, rbs, 7, "m0", 0)
    # staged, not committed: no reader sees a block
    assert all(HostShuffleTransport.committed_partition_files(sdir, p)
               == [] for p in range(N_PARTS))
    assert t.partition_stats(7) is None
    zombie = _attempt(t, rbs[:1], 7, "m0", 1)
    assert t.commit_task_attempt(7, "m0", 0) is True
    # the zombie loses its commit and its staging is gone
    assert t.commit_task_attempt(7, "m0", 1) is False
    assert not os.path.exists(zombie)
    rows = sum(rb.num_rows for p in range(N_PARTS)
               for rb in _read_port(t, 7, p))
    assert rows == sum(rb.num_rows for rb in rbs)
    # a fresh transport rebuilds the stats from the committed manifest
    fresh = HostShuffleTransport(RapidsConf(), threads=0, root=t.root)
    assert fresh.partition_stats(7) == t.partition_stats(7)
    assert sum(t.partition_stats(7)) > 0
    t.unregister_shuffle(7)
    assert not os.path.exists(sdir)


def test_commit_protocol_equals_the_reference(tmp_path):
    """The same attempt sequence through both packages: the same commit
    verdicts, committed files and stats."""
    from spark_rapids_tpu.columnar.arrow_bridge import engine_schema as jes
    rbs = _map_batches(seed=5, n_batches=2)
    out = []
    for pkg in ("port", "ref"):
        root = str(tmp_path / pkg)
        if pkg == "port":
            t = HostShuffleTransport(RapidsConf(), threads=0, root=root)
        else:
            t = JHost(JConf(), threads=0, root=root)
        verdicts = []
        for task, att in (("m0", 0), ("m0", 1), ("m1", 0)):
            d = t.begin_task_attempt(3, task, att)
            if pkg == "port":
                _write_port(t, rbs, 3, subdir=d)
            else:
                schema = jes(rbs[0].schema)
                part = JHash([jcol("k"), jcol("s")],
                             N_PARTS).bind(schema)
                t.register_shuffle(3, N_PARTS)
                for i, rb in enumerate(rbs):
                    b = j_up(rb, schema)
                    w = t.writer(3, i, subdir=d)
                    w.write_unsplit(b, part.partition_ids_device(b, None))
                    w.close()
        verdicts = [t.commit_task_attempt(3, "m0", 0),
                    t.commit_task_attempt(3, "m0", 1),
                    t.commit_task_attempt(3, "m1", 0)]
        t.abort_task_attempt(3, "m2", 0)
        files = sorted(os.path.relpath(p, root) for q in range(N_PARTS)
                       for p in type(t).committed_partition_files(
                           os.path.join(root, "s3"), q))
        out.append((verdicts, files, t.partition_stats(3)))
        t.close()
    assert out[0] == out[1]
    assert out[0][0] == [True, False, True]


def test_abort_and_unregister_leave_nothing(tmp_path):
    rbs = _map_batches(seed=4, n_batches=1)
    t = HostShuffleTransport(RapidsConf(), threads=0, root=str(tmp_path))
    d = _attempt(t, rbs, 2, "m0", 0)
    t.abort_task_attempt(2, "m0", 0)
    assert not os.path.exists(d)
    assert t.commit_task_attempt(2, "m0", 0) is False
    t.unregister_shuffle(2)
    assert os.listdir(t.root) == []
    t.close()


def test_owned_root_is_removed_at_close():
    t = HostShuffleTransport(RapidsConf(), threads=0)
    _write_port(t, _map_batches(seed=6, n_batches=1), 0)
    assert os.path.isdir(t.root)
    t.close()
    assert not os.path.exists(t.root)


def test_snappy_is_refused_like_the_reference():
    conf = {"spark.rapids.shuffle.compression.codec": "snappy"}
    with pytest.raises(ValueError, match="snappy") as port:
        HostShuffleTransport(RapidsConf(conf))
    with pytest.raises(ValueError, match="snappy") as ref:
        JHost(JConf(conf))
    assert str(port.value) == str(ref.value)


def test_a_corrupt_block_is_a_classified_fetch_failure(tmp_path):
    from spark_rapids_tpu_torch.shuffle.transport import FetchFailure
    rbs = _map_batches(seed=8, n_batches=1)
    t = HostShuffleTransport(RapidsConf(), threads=0, root=str(tmp_path))
    _attempt(t, rbs, 4, "m0", 0)
    assert t.commit_task_attempt(4, "m0", 0)
    sdir = os.path.join(t.root, "s4")
    path = next(p for q in range(N_PARTS) for p in
                HostShuffleTransport.committed_partition_files(sdir, q))
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff\x00\xff")
    pid = int(integrity._PID_RE.search(path).group(1))
    with pytest.raises(FetchFailure) as e:
        list(t.read_partition(4, pid))
    assert e.value.kind == "corrupt" and e.value.map_task == "m0"
    t.close()


@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(1 << 12)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))


@pytest.mark.parametrize("q", ["q3", "q_rank", "q97"])
@pytest.mark.parametrize("mode", ["HOST", "MULTITHREADED"])
def test_corpus_text_over_the_host_shuffle(q, mode, paths, tables):
    conf = {"spark.sql.shuffle.partitions": "16",
            "spark.rapids.shuffle.mode": mode}
    got, chunks = run_port(nds.SQL_QUERIES[q], paths, conf)
    want, want_chunks = run_reference(
        nds.SQL_QUERIES[q], paths, {"spark.sql.shuffle.partitions": "16"})
    assert got.num_rows > 0
    assert_same_rows(got, want, ordered=True, label=q)
    assert_same_rows(got, nds.oracle(q, tables), ordered=True, label=q)
    assert chunks == want_chunks


def test_ici_mode_names_item_17(paths):
    with pytest.raises(NotImplementedError, match="item 17"):
        run_port(nds.SQL_QUERIES["q3"], paths,
                 {"spark.sql.shuffle.partitions": "4",
                  "spark.rapids.shuffle.mode": "ICI"})


def test_multithreaded_writes_lose_no_update(tmp_path):
    """More pool threads than cores and a short switch interval: the
    rows read and the write-time stats equal a synchronous run's."""
    import sys
    rbs = _map_batches(seed=12, n_batches=40)
    threads = (os.cpu_count() or 4) + 2
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mt = HostShuffleTransport(RapidsConf(), threads=threads,
                                  root=str(tmp_path / "mt"))
        _write_port(mt, rbs, 9)
        rows = [_rows(_read_port(mt, 9, p)) for p in range(N_PARTS)]
        stats = mt.partition_stats(9)
    finally:
        sys.setswitchinterval(old)
        mt.close()
    sync = HostShuffleTransport(RapidsConf(), threads=0,
                                root=str(tmp_path / "sync"))
    _write_port(sync, rbs, 9)
    assert rows == [_rows(_read_port(sync, 9, p)) for p in range(N_PARTS)]
    assert stats == sync.partition_stats(9)
    sync.close()
