"""Card-only checks of K7 (``csrc/xxhash64.cu``) and K8
(``csrc/regex_spans.cu``): each against its plain version bit for bit on
``kernel_checks``' cases (K7 also against the numpy host copy, K8 with
``first_only`` off and on), each wrapper counting one launch a call, and
``df_hash`` and ``df_regex`` (``tools/nds_dataframe``) on the card equal
to their oracles. Run on a machine with a CUDA device: ``python -m
pytest --noconftest tests/test_torch_gpu_hash_spans.py``; elsewhere they
skip (the kernels have no CPU mode)."""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda", 0)


def test_k7_matches_its_plain_version(cuda_device):
    from spark_rapids_tpu_torch.ops import hash as h
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    cases = kc.k7_cases(cuda_device, rows=1 << 16)
    before = h.xxhash64_strings.launches
    recs = kc.check_k7(cuda_device, cases)
    assert all(r["equal"] and r["equal_host"] for r in recs)
    assert h.xxhash64_strings.launches - before == len(cases)


def test_k8_matches_its_plain_version(cuda_device):
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    from spark_rapids_tpu_torch.ops import regex
    cases = kc.k8_cases(cuda_device, text_rows=1 << 14)
    before = regex.find_spans.launches
    recs = kc.check_k8(cuda_device, cases)
    assert all(r["equal"] for r in recs)
    assert regex.find_spans.launches - before == 2 * len(cases)


@pytest.mark.parametrize("name", ["df_hash", "df_regex"])
def test_dataframe_text_on_the_card(cuda_device, name, tmp_path):
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_dataframe as ndf
    tables = nds.gen_tables(1 << 14)
    paths = nds.write_tables(tables, str(tmp_path))
    for parts in ("1", "16"):
        s = nds.session_over_files(
            paths, {"spark.sql.shuffle.partitions": parts}, cuda_device)
        got = ndf.BUILDERS[name](s, ndf.port_namespace()).collect()
        ndf.check(name, got, ndf.oracle(name, tables))
