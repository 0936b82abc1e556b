"""The port's sealed files against the JAX package's
(``spark_rapids_tpu_torch/shuffle/integrity.py`` against
``spark_rapids_tpu/shuffle/integrity.py``), both on the CPU:

- a file sealed by either package is read by the other, and the
  footers are the same bytes;
- missing, torn (truncated, a bad magic, a length that disagrees),
  corrupt (a flipped payload byte, a CRC other than the manifest's) and
  io (an EIO countdown past the retries) raise the same classified kind
  in both, and an EIO countdown within the retries reads through;
- manifests and the partition index read the same in both;
- the port's own CRC32C (``crc32c_numpy``) equals ``google_crc32c`` on
  random buffers from 0 B to 1 MB, and the standard check value.

Tolerance: exact (bytes and kinds)."""
import os

import google_crc32c
import numpy as np
import pytest

from spark_rapids_tpu.shuffle import integrity as jint
from spark_rapids_tpu_torch.shuffle import integrity as tint
from spark_rapids_tpu_torch.shuffle.transport import FetchFailure

PACKAGES = {"port": tint, "reference": jint}


class Classified(Exception):
    def __init__(self, kind, detail):
        super().__init__(f"{kind}: {detail}")
        self.kind = kind


def _payload(n=4096, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port"),
                                           ("port", "port")])
@pytest.mark.parametrize("n", [0, 1, 4096, 100_003])
def test_sealed_file_is_read_by_either_package(tmp_path, writer, reader, n):
    data = _payload(n, seed=n)
    path = str(tmp_path / "blob.arrow")
    size, crc = PACKAGES[writer].write_sealed_file(path, data)
    assert size == n + tint.FOOTER_LEN == os.path.getsize(path)
    assert crc == google_crc32c.value(data)
    got = PACKAGES[reader].read_sealed_file(path, Classified)
    assert bytes(got) == data
    assert not os.path.exists(path + ".tmp")


def test_footers_and_blocks_are_the_same_bytes(tmp_path):
    data = _payload(777, seed=3)
    assert tint.footer_bytes(data) == jint.footer_bytes(data)
    for name, mod in PACKAGES.items():
        size, crc = mod.write_block(str(tmp_path / f"{name}.bin"), data)
        assert (size, crc) == (777 + 16, google_crc32c.value(data))
    assert (tmp_path / "port.bin").read_bytes() \
        == (tmp_path / "reference.bin").read_bytes()


def _damage(path, how):
    raw = open(path, "rb").read()
    if how == "missing":
        os.unlink(path)
    elif how == "truncated":
        open(path, "wb").write(raw[:-5])
    elif how == "short":
        open(path, "wb").write(raw[:7])
    elif how == "bad_magic":
        open(path, "wb").write(raw[:-4] + b"XXXX")
    elif how == "length":
        # one more payload byte than the footer claims
        open(path, "wb").write(raw[:-16] + b"\x00" + raw[-16:])
    elif how == "flipped":
        b = bytearray(raw)
        b[len(raw) // 3] ^= 0x55
        open(path, "wb").write(bytes(b))
    elif how == "eio_exhausted":
        open(path + ".eio", "w").write("9")


DAMAGE = [("missing", "missing"), ("truncated", "torn"),
          ("short", "torn"), ("bad_magic", "torn"), ("length", "torn"),
          ("flipped", "corrupt"), ("eio_exhausted", "io")]


@pytest.mark.parametrize("how,kind", DAMAGE, ids=[d[0] for d in DAMAGE])
def test_damaged_files_classify_alike(tmp_path, how, kind):
    got = {}
    for name, mod in PACKAGES.items():
        path = str(tmp_path / f"{name}.arrow")
        mod.write_sealed_file(path, _payload(1000))
        _damage(path, how)
        with pytest.raises(Classified) as e:
            mod.read_sealed_file(path, Classified, max_retries=2,
                                 retry_wait_s=0.0)
        got[name] = e.value.kind
    assert got == {"port": kind, "reference": kind}


def test_eio_within_the_retries_reads_through(tmp_path):
    for name, mod in PACKAGES.items():
        path = str(tmp_path / f"{name}.arrow")
        mod.write_sealed_file(path, _payload(500))
        open(path + ".eio", "w").write("2")
        seen = []
        got = mod.read_sealed_file(path, Classified, max_retries=3,
                                   retry_wait_s=0.0,
                                   on_retry=lambda n, e: seen.append(n))
        assert bytes(got) == _payload(500) and seen == [1, 2], name


@pytest.mark.parametrize("expect", ["size", "crc"])
def test_manifest_expectations_classify_alike(tmp_path, expect):
    data = _payload(300)
    kinds = {}
    for name, mod in PACKAGES.items():
        path = str(tmp_path / f"{name}.arrow")
        size, crc = mod.write_sealed_file(path, data)
        kw = {"expected_size": size + 1} if expect == "size" \
            else {"expected_crc": crc ^ 1}
        with pytest.raises(Classified) as e:
            mod.read_sealed_file(path, Classified, **kw)
        kinds[name] = e.value.kind
    want = "torn" if expect == "size" else "corrupt"
    assert kinds == {"port": want, "reference": want}


def test_manifest_and_partition_index_read_alike(tmp_path):
    sdir = tmp_path / "shuffle"
    commit = sdir / "m0.mapout"
    commit.mkdir(parents=True)
    files = {}
    for p in range(3):
        name = f"m0_p{p}.arrow"
        size, crc = tint.write_block(str(commit / name), _payload(50 + p))
        files[name] = {"size": size, "crc": crc}
    tint.write_manifest(str(commit), "m0", 0, files)
    idx = {name: mod.expected_partition_index(str(sdir), ["m0"])
           for name, mod in PACKAGES.items()}
    assert idx["port"] == idx["reference"]
    assert sorted(idx["port"]) == [0, 1, 2]
    for pid, [(path, meta)] in idx["port"].items():
        assert bytes(tint.read_block(path, meta)) == _payload(50 + pid)
    os.unlink(commit / "m0_p1.arrow")
    with pytest.raises(FetchFailure) as e:
        tint.read_block(idx["port"][1][0][0], idx["port"][1][0][1])
    assert e.value.kind == "missing"
    with pytest.raises(FetchFailure) as e:
        tint.expected_partition_index(str(sdir), ["m0", "m1"])
    assert e.value.kind == "missing"
    (commit / tint.MANIFEST_NAME).write_text("{not json")
    with pytest.raises(FetchFailure) as e:
        tint.read_manifest(str(commit))
    assert e.value.kind == "torn"


SIZES = [0, 1, 3, 4, 7, 63, 64, 65, 255, 4096, 4099, 65_537, 262_147,
         1 << 20]


@pytest.mark.parametrize("n", SIZES)
def test_own_crc32c_equals_google_crc32c(n):
    data = _payload(n, seed=n + 1)
    assert tint.crc32c_numpy(data) == google_crc32c.value(data)
    assert tint.crc32c_numpy(memoryview(data)) == google_crc32c.value(data)
    arr = np.frombuffer(data, np.uint8)
    assert tint.crc32c_numpy(arr[1:]) == google_crc32c.value(data[1:])


def test_own_crc32c_check_value_and_choice():
    assert tint.crc32c_numpy(b"123456789") == 0xE3069283
    # google_crc32c imports here, so the seals use it; where it does
    # not, the module falls back to its own, the same checksum
    assert tint.CRC32C_IMPL == "google_crc32c"
    assert tint.crc32c(b"123456789") == 0xE3069283
