"""The port's memory runtime (``spark_rapids_tpu_torch/memory.py``)
against the JAX package's (``spark_rapids_tpu/memory.py``), both on the
CPU, at small sizes (64-512 rows, budgets of a few KB):

- spill round trips, device -> host -> sealed disk file -> device, of
  fixed-width, string, null, ``NullType``, lazily selected and empty
  batches, equal to the original's download; an upload is charged its
  own bytes (a selection's live rows), not the registered batch's;
- for a scripted sequence of registrations, reads, pins and releases,
  the ledger's bytes and the LRU victims each step equal the
  reference's (the batches carry nulls in every column, where the two
  packages' ``device_size_bytes`` agree); pinned entries are never
  evicted;
- the disk limit, an injected full disk, injected spill faults and
  read retries classify as in the reference;
- ``split_batch``'s halves download to the reference's halves, and
  ``with_retry`` under ``injectRetryOOM`` makes the same splits and
  rows; a non-OOM error is not retried;
- the orphan sweep removes what the reference's removes;
- ``leak_report`` names a live entry and its registration site.

Tolerance: exact (rows, bytes, kinds)."""
import os
import subprocess
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import memory as jmem
from spark_rapids_tpu.columnar.arrow_bridge import \
    arrow_to_device as j_arrow_to_device
from spark_rapids_tpu.columnar.arrow_bridge import \
    device_to_arrow as j_device_to_arrow
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu_torch import memory as tmem
from spark_rapids_tpu_torch.columnar.arrow_bridge import (arrow_to_device,
                                                          device_to_arrow)
from spark_rapids_tpu_torch.columnar.batch import GpuBatch
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.shuffle import integrity as tint

CPU = torch.device("cpu")


def _rb(n, seed=1, nulls=True):
    """int32, float64 and string columns; with ``nulls`` every column
    holds a null (the two packages' byte counts then agree)."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-50, 50, n).astype(np.int32)
    dbl = rng.normal(0, 10, n)
    strs = [("x" * int(k % 7)) + str(k) for k in rng.integers(0, 99, n)]
    mask = np.zeros(n, bool)
    if nulls and n:
        mask[rng.integers(0, n, max(1, n // 9))] = True
    return pa.record_batch({
        "i": pa.array(ints, pa.int32(), mask=mask),
        "d": pa.array(dbl, pa.float64(), mask=mask),
        "s": pa.array([None if m else s for s, m in zip(strs, mask)],
                      pa.string())})


def _port_mgr(tmp_path, **extra):
    conf = {"spark.rapids.memory.device.budgetBytes": 1 << 22,
            "spark.rapids.memory.spillDir": str(tmp_path)}
    conf.update(extra)
    return tmem.DeviceMemoryManager(RapidsConf(conf), CPU)


def _ref_mgr(tmp_path, **extra):
    conf = {"spark.rapids.memory.device.budgetBytes": 1 << 22,
            "spark.rapids.memory.spillDir": str(tmp_path)}
    conf.update(extra)
    return jmem.DeviceMemoryManager(JConf(conf))


def _port_batch(rb):
    return arrow_to_device(rb, None, CPU)


# --- spill round trips --------------------------------------------------------

def _kind_batch(kind):
    if kind == "fixed":
        rb = pa.record_batch({"a": pa.array(np.arange(300), pa.int64()),
                              "b": pa.array(np.linspace(0, 1, 300),
                                            pa.float32())})
    elif kind == "strings":
        rb = pa.record_batch({"s": pa.array(
            [f"row-{k}" * (k % 4) for k in range(300)])})
    elif kind == "nulls":
        rb = _rb(300, seed=4)
    elif kind == "nulltype":
        rb = pa.record_batch({"n": pa.nulls(200),
                              "v": pa.array(np.arange(200), pa.int32())})
    elif kind == "empty":
        rb = pa.record_batch({"a": pa.array([], pa.int64()),
                              "s": pa.array([], pa.string())})
    else:  # selected: a lazy selection over a sliced string input
        rb = _rb(400, seed=5).slice(37, 300)
    b = _port_batch(rb)
    if kind == "selected":
        keep = torch.arange(b.capacity) % 3 != 1
        b = b.with_selection(keep)
    return b


KINDS = ["fixed", "strings", "nulls", "nulltype", "empty", "selected"]


@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("kind", KINDS)
def test_spill_round_trip_equals_the_original(tmp_path, kind, tier):
    mm = _port_mgr(tmp_path)
    b = _kind_batch(kind)
    want = device_to_arrow(b)
    sb = mm.register(b)
    assert mm.device_bytes == b.device_size_bytes() == sb.nbytes
    sb.spill(cascade=False)
    assert not sb.on_device and mm.device_bytes == 0
    if tier == "disk":
        assert sb.spill_to_disk() and sb.on_disk
        # the spill file is sealed: the integrity reader verifies it
        payload = tint.read_sealed_file(sb._disk_path, RuntimeError)
        assert len(payload) + tint.FOOTER_LEN == sb._disk_size \
            == mm.disk_in_use_bytes
        assert mm.host_bytes == 0
    again = sb.get()
    assert sb.on_device and not sb.on_disk
    assert mm.device_bytes == sb.nbytes
    assert device_to_arrow(again).equals(want)
    assert mm.readback_count == 1
    sb.release()
    assert (mm.device_bytes, mm.host_bytes, mm.disk_in_use_bytes) \
        == (0, 0, 0)
    assert mm.leak_report() == "no leaked catalog entries"


def test_an_upload_is_charged_its_own_bytes(tmp_path):
    """A spill downloads a selection's live rows only: the upload after
    it holds fewer bytes than the batch registered, and the ledger
    charges, and a later spill credits, what the card holds."""
    mm = _port_mgr(tmp_path)
    b = _kind_batch("selected")
    sb = mm.register(b)
    registered = sb.nbytes
    del b
    sb.spill(cascade=False)
    again = sb.get()
    assert sb.nbytes == again.device_size_bytes() < registered
    assert mm.device_bytes == sb.nbytes
    spilled = mm.spill_bytes
    del again
    sb.spill(cascade=False)
    assert mm.spill_bytes - spilled == sb.nbytes and mm.device_bytes == 0
    sb.release()


def test_host_tier_cascades_to_disk_and_back(tmp_path):
    mm = _port_mgr(tmp_path, **{
        "spark.rapids.memory.device.budgetBytes": 1 << 12,
        "spark.rapids.memory.host.spillStorageSize": 1 << 12})
    rng = np.random.default_rng(0)
    rbs = [pa.record_batch({"v": pa.array(rng.integers(0, 1000, 512),
                                          pa.int64())}) for _ in range(6)]
    sbs = [mm.register(_port_batch(rb)) for rb in rbs]
    assert mm.spill_bytes > 0 and mm.disk_spill_bytes > 0
    assert any(sb.on_disk for sb in sbs)
    assert os.path.dirname(mm.spill_dir) == str(tmp_path)
    assert os.listdir(mm.spill_dir)
    for sb, rb in zip(sbs, rbs):
        assert sb.get_host().equals(rb)
    for sb in sbs:
        sb.release()
    assert os.listdir(mm.spill_dir) == []
    assert mm.disk_in_use_bytes == 0


# --- the ledger and its victims, step by step against the reference ---------

SCRIPT = [("register", 0), ("register", 1), ("register", 2),
          ("get", 0), ("register", 3), ("pin", 3), ("register", 4),
          ("get", 1), ("register", 5), ("release", 2), ("get", 2),
          ("unpin", 3), ("register", 6), ("get", 4), ("spill_all", None),
          ("get", 6), ("release", 0)]


def _run_script(mgr, to_device, budget_units):
    rbs = [_rb(256, seed=10 + k) for k in range(7)]
    sbs, states = {}, []
    for op, k in SCRIPT:
        if op == "register":
            sbs[k] = mgr.register(to_device(rbs[k]))
        elif op == "get":
            if k in sbs:
                sbs[k].get()
        elif op == "pin":
            sbs[k].pin()
        elif op == "unpin":
            sbs[k].unpin()
        elif op == "release":
            sbs.pop(k).release()
        else:
            mgr.spill_all_unpinned()
        states.append((op, k, mgr.device_bytes, mgr.spill_bytes,
                       tuple(sorted(i for i, sb in sbs.items()
                                    if sb.on_device))))
    for sb in sbs.values():
        sb.release()
    return states, mgr.device_bytes


def test_ledger_bytes_and_lru_victims_match_reference(tmp_path):
    unit = _port_batch(_rb(256, seed=10)).device_size_bytes()
    budget = int(unit * 3.5)
    port = _port_mgr(tmp_path / "p", **{
        "spark.rapids.memory.device.budgetBytes": budget})
    ref = _ref_mgr(tmp_path / "r", **{
        "spark.rapids.memory.device.budgetBytes": budget})
    got, left = _run_script(port, _port_batch, budget)
    want, ref_left = _run_script(ref, j_arrow_to_device, budget)
    assert got == want
    assert left == ref_left == 0
    # the script evicted something and the pinned entry stayed
    assert got[-1][3] > 0


def test_pinned_entries_are_never_evicted(tmp_path):
    mm = _port_mgr(tmp_path, **{
        "spark.rapids.memory.device.budgetBytes": 1})
    pinned = mm.register(_port_batch(_rb(128, seed=1)), pinned=True)
    shared = mm.register(_port_batch(_rb(128, seed=2)), pinned=True)
    shared.pin()  # a second consumer
    others = [mm.register(_port_batch(_rb(128, seed=3 + k)))
              for k in range(4)]
    mm.spill_all_unpinned()
    shared.unpin()  # still pinned once
    mm.spill_all_unpinned()
    assert pinned.on_device and shared.on_device
    assert not any(sb.on_device for sb in others)
    shared.unpin()
    mm.spill_all_unpinned()
    assert not shared.on_device and pinned.on_device
    for sb in [pinned, shared] + others:
        sb.release()
    assert mm.device_bytes == 0


# --- the disk tier's faults, classified as in the reference -------------------

def _to_disk(mm, to_device, seed=1):
    sb = mm.register(to_device(_rb(256, seed=seed)))
    sb.spill(cascade=False)
    assert sb.spill_to_disk()
    return sb


PAIRS = [(_port_mgr, _port_batch, tmem), (_ref_mgr, j_arrow_to_device, jmem)]


@pytest.mark.parametrize("damage", ["torn", "corrupt", "missing",
                                    "inject_corrupt", "inject_torn",
                                    "eio_exhausted"])
def test_spill_read_failures_classify_as_in_reference(tmp_path, damage):
    kinds = []
    for i, (make, to_dev, mod) in enumerate(PAIRS):
        extra = {"spark.rapids.memory.disk.readRetries": 1,
                 "spark.rapids.memory.disk.readRetryWaitMs": 1}
        if damage.startswith("inject_"):
            extra["spark.rapids.memory.test.injectSpillFault"] = \
                damage[len("inject_"):]
        mm = make(tmp_path / str(i), **extra)
        sb = _to_disk(mm, to_dev)
        path = sb._disk_path
        if damage == "torn":
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) - 8)
        elif damage == "corrupt":
            with open(path, "r+b") as f:
                f.seek(os.path.getsize(path) // 2)
                f.write(b"\xde\xad\xbe\xef")
        elif damage == "missing":
            os.unlink(path)
        elif damage == "eio_exhausted":
            open(path + ".eio", "w").write("99")
        with pytest.raises(mod.SpillReadError) as e:
            sb.get_host()
        kinds.append(e.value.kind)
        assert sb.on_disk  # the tier state is as it was
        sb.release()
        assert mm.disk_in_use_bytes == 0
    want = {"torn": "torn", "corrupt": "corrupt", "missing": "missing",
            "inject_corrupt": "corrupt", "inject_torn": "torn",
            "eio_exhausted": "io"}[damage]
    assert kinds == [want, want]


def test_spill_read_eio_retries_in_place(tmp_path):
    for i, (make, to_dev, _) in enumerate(PAIRS):
        mm = make(tmp_path / str(i), **{
            "spark.rapids.memory.disk.readRetryWaitMs": 1})
        sb = _to_disk(mm, to_dev, seed=7)
        open(sb._disk_path + ".eio", "w").write("2")
        assert sb.get_host().num_rows == 256
        sb.release()


def test_injected_disk_full_leaves_the_batch_on_the_host(tmp_path):
    """ENOSPC mid-write: the partial file is removed, the batch stays on
    the host, a second attempt (the countdown spent) commits."""
    outcomes = []
    for i, (make, to_dev, _) in enumerate(PAIRS):
        mm = make(tmp_path / str(i), **{
            "spark.rapids.memory.test.injectDiskFull": 2})
        sb = mm.register(to_dev(_rb(128)))
        sb.spill(cascade=False)
        first = sb.spill_to_disk()
        files = os.listdir(mm.spill_dir) if os.path.isdir(mm.spill_dir) \
            else []
        pressure = mm.disk_pressure_active()
        host_left = sb._host is not None
        sb._no_disk_until = 0.0
        second = sb.spill_to_disk()
        outcomes.append((first, files, pressure, host_left, second,
                         mm.disk_in_use_bytes > 0))
        sb.release()
        assert mm.disk_in_use_bytes == 0
    assert outcomes[0] == outcomes[1] == (False, [], True, True, True, True)


def test_disk_limit_evicts_oldest_then_refuses_as_budget(tmp_path):
    results = []
    for i, (make, to_dev, _) in enumerate(PAIRS):
        mm = make(tmp_path / str(i))
        sb1 = _to_disk(mm, to_dev, seed=1)
        mm.disk_limit = int(sb1._disk_size * 1.5)
        sb2 = _to_disk(mm, to_dev, seed=2)  # evicts sb1 to the host
        step1 = (sb2.on_disk, sb1.on_disk, sb1._host is not None)
        sb2.pin()
        sb3 = mm.register(to_dev(_rb(256, seed=3)))
        sb3.spill(cascade=False)
        sb1._no_disk_until = 0.0
        refused = sb3.spill_to_disk() is False
        results.append((step1, refused, mm.disk_pressure_active()))
        sb2.unpin()
        for sb in (sb1, sb2, sb3):
            sb.release()
        assert mm.disk_in_use_bytes == 0
    assert results[0] == results[1] == ((True, False, True), True, True)
    port = _port_mgr(tmp_path / "count")
    sb = _to_disk(port, _port_batch)
    port.disk_limit = 1
    sb2 = port.register(_port_batch(_rb(64)))
    sb2.spill(cascade=False)
    sb.pin()
    assert sb2.spill_to_disk() is False
    assert port.spill_write_failures == {"budget": 1}
    sb.release()
    sb2.release()


# --- split and retry ----------------------------------------------------------

@pytest.mark.parametrize("n", [300, 256, 129])
def test_split_batch_halves_match_reference(n):
    rb = _rb(n, seed=n)
    t1, t2 = tmem.split_batch(_port_batch(rb))
    j1, j2 = jmem.split_batch(j_arrow_to_device(rb))
    assert device_to_arrow(t1).equals(j_device_to_arrow(j1))
    assert device_to_arrow(t2).equals(j_device_to_arrow(j2))
    assert t1.capacity == t2.capacity == j1.capacity
    assert pa.Table.from_batches([device_to_arrow(t1),
                                  device_to_arrow(t2)]).equals(
        pa.Table.from_batches([rb]))


def test_split_batch_keeps_a_selection():
    b = _kind_batch("selected")
    h1, h2 = tmem.split_batch(b)
    got = pa.Table.from_batches([device_to_arrow(h1), device_to_arrow(h2)])
    assert got.equals(pa.Table.from_batches([device_to_arrow(b)]))
    with pytest.raises(tmem.TpuRetryOOM):  # nothing left to halve
        tmem.split_batch(GpuBatch([], b.schema, 0))


@pytest.mark.parametrize("inject", ["injectRetryOOM", "storm"])
def test_with_retry_splits_like_reference(tmp_path, inject):
    key = "spark.rapids.sql.test.injectRetryOOM" + (
        "" if inject == "injectRetryOOM" else ".storm")
    value = 1 if inject == "injectRetryOOM" else 3
    rb = _rb(512, seed=8)
    port = tmem.DeviceMemoryManager(RapidsConf({key: value}), CPU)
    ref = jmem.DeviceMemoryManager(JConf({key: value}))
    got = port.with_retry(_port_batch(rb), lambda b: b)
    want = ref.with_retry(j_arrow_to_device(rb), lambda b: b)
    assert [b.capacity for b in got] == [b.capacity for b in want]
    assert len(got) > 1
    assert [device_to_arrow(b) for b in got] \
        == [j_device_to_arrow(b) for b in want]
    assert port.oom_retries == len(got) - 1


def test_with_retry_exhausts_and_does_not_retry_other_errors():
    port = tmem.DeviceMemoryManager(RapidsConf({
        "spark.rapids.sql.test.injectRetryOOM.storm": 100,
        "spark.rapids.sql.oomRetry.maxSplits": 2}), CPU)
    with pytest.raises(tmem.TpuRetryOOM):
        port.with_retry(_port_batch(_rb(64)), lambda b: b)
    calls = []

    def fail(b):
        calls.append(b.capacity)
        raise RuntimeError("CUDA error: an illegal memory access")

    plain = tmem.DeviceMemoryManager(RapidsConf({}), CPU)
    with pytest.raises(RuntimeError, match="illegal"):
        plain.with_retry(_port_batch(_rb(64)), fail)
    assert calls == [128]
    assert tmem.is_oom_error(torch.OutOfMemoryError("x"))
    assert not tmem.is_oom_error(RuntimeError("out of memory"))


def test_with_retry_answers_a_real_allocation_failure():
    """A ``torch.OutOfMemoryError`` raised by the function is halved like
    the injected one, and the halves run after the failed attempt is
    gone."""
    mm = tmem.DeviceMemoryManager(RapidsConf({}), CPU)
    seen = []

    def fn(b):
        seen.append(b.capacity)
        if b.capacity > 128:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return b.row_count

    assert mm.with_retry(_port_batch(_rb(400)), fn) == [128, 128, 128, 16]
    assert seen == [512, 256, 128, 128, 256, 128, 128]


# --- the orphan sweep and the leak report ------------------------------------

def test_orphan_sweep_removes_what_the_reference_removes(tmp_path):
    p = subprocess.Popen(["true"])
    p.wait()  # reaped: the pid is dead
    removed = {}
    for name, mod in (("port", tmem), ("reference", jmem)):
        base = tmp_path / name
        host = mod._hostname()
        dead = base / f"{host}-{p.pid}-{'a' * 8}"
        dead.mkdir(parents=True)
        (dead / "spill-x.arrow").write_bytes(b"x")
        old = base / f"elsewhere-4242-{'b' * 8}"
        old.mkdir()
        os.utime(old, (1.0, 1.0))
        (base / f"elsewhere-4243-{'c' * 8}").mkdir()
        own = mod.spill_namespace(str(base))
        os.makedirs(own)
        flat = base / "spill-old.arrow"
        flat.write_bytes(b"x")
        os.utime(flat, (1.0, 1.0))
        got = mod.sweep_orphan_spill_dirs(str(base), ttl_s=3600.0,
                                          force=True)
        removed[name] = sorted(os.path.basename(x) for x in got)
        assert os.path.exists(own)
        assert sorted(os.listdir(base)) == sorted(
            [os.path.basename(own), f"elsewhere-4243-{'c' * 8}"])
    assert removed["port"] == removed["reference"]
    assert len(removed["port"]) == 3


def test_leak_report_names_the_registration_site(tmp_path):
    mm = _port_mgr(tmp_path, **{"spark.rapids.refcount.debug": True})
    sb = mm.register(_port_batch(_rb(16)))
    rep = mm.leak_report()
    assert "1 catalog entry never released" in rep
    assert "test_torch_memory" in rep
    sb.release()
    sb.release()  # idempotent
    assert mm.leak_report() == "no leaked catalog entries"
    assert mm.device_bytes == 0


def test_budget_resolves_like_reference():
    conf = {"spark.rapids.memory.device.budgetBytes": "3m"}
    assert tmem.resolve_device_budget(RapidsConf(conf), CPU) \
        == jmem.resolve_device_budget(JConf(conf)) == 3 << 20
    # no budget set: allocFraction x the device's memory, 6 GiB on the CPU
    assert tmem.resolve_device_budget(RapidsConf({}), CPU) \
        == int((6 << 30) * 0.85)


def test_transient_reservation_charges_and_releases(tmp_path):
    mm = _port_mgr(tmp_path, **{
        "spark.rapids.memory.device.budgetBytes": 4096})
    sb = mm.register(_port_batch(_rb(64)))
    with mm.transient_reservation(8192):
        assert mm.device_bytes == 8192  # the entry was evicted for it
        assert not sb.on_device
    assert mm.device_bytes == 0
    sb.release()


def test_host_ledger_is_unbounded_and_never_retries():
    h = tmem.DeviceMemoryManager.host()
    assert h is tmem.DeviceMemoryManager.host()
    assert h.budget >= 1 << 62 and not h._retry_enabled
    with pytest.raises(tmem.TpuRetryOOM):
        h.with_retry(_port_batch(_rb(8)),
                     lambda b: (_ for _ in ()).throw(tmem.TpuRetryOOM("x")))


def test_slow_disk_injection_sleeps_on_write_and_read(tmp_path):
    mm = _port_mgr(tmp_path, **{
        "spark.rapids.memory.test.injectSlowDisk": 0.05})
    t0 = time.monotonic()
    sb = _to_disk(mm, _port_batch)
    sb.get_host()
    assert time.monotonic() - t0 >= 0.1
    sb.release()
