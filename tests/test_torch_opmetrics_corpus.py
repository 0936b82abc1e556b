"""The second half of ``tests/test_torch_opmetrics.py``'s runs over the
plan verifier's corpus: each text at its partition count, its rows equal
to the reference's everywhere and its batches node for node but for
``DIFFERENCES`` (``_rows_and_batches``). The runs are split over two
files so that the tier-1 run's workers take them side by side."""
import pytest

from test_torch_opmetrics import HALVES, _rows_and_batches, paths  # noqa: F401


@pytest.mark.parametrize("q,sql,conf,parts", HALVES[1],
                         ids=[f"{q}-p{p}" for q, _, _, p in HALVES[1]])
def test_batches_over_the_verifier_corpus(paths, q, sql, conf, parts):  # noqa: F811
    """The 44 texts of the verifier's corpus at 1 and 16 partitions, the
    second half of the runs."""
    _rows_and_batches(paths, q, sql, conf, parts)
