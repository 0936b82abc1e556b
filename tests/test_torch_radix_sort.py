"""K3's plain version, the LSD radix sort's digit passes, against
``torch.sort(stable=True)``, numpy and the JAX package's ``sort_xla`` and
``sort_pallas`` (interpret mode) on the CPU: keys whose only varying bit
is the sign bit or whose only varying digit is the top one, 1-bit
compaction keys, the engine's packed month words with padding rows,
all-equal keys at short and ragged lengths, and negative and duplicate
payloads; the skip rule against the digits that numpy finds constant;
and the words ``kernel_checks`` times against the words the join +
group-by path really sorts. The CUDA edition runs only on the card
(``test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.ops.pallas_kernels import sort_pallas, sort_xla
from spark_rapids_tpu_torch.ops import cuda_kernels as ck
from spark_rapids_tpu_torch.ops import kernel_checks as kc

I64_MIN = -(1 << 63)
EDGE_LENGTHS = [1, 2, 3, 255, 257, 4097]


def _shifted(rng, bits, shift, n):
    """Keys whose only varying bits are ``bits`` random bits at
    ``shift``, over a constant low pattern."""
    v = rng.integers(0, 1 << bits, n).astype(np.uint64) << np.uint64(shift)
    return (v | np.uint64(0x5A5A)).view(np.int64)


def _keys(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "sign_bit_only":
        return _shifted(rng, 1, 63, n)
    if kind == "top_digit_only":
        return _shifted(rng, 8, 56, n)
    if kind == "compaction_1bit":
        return (rng.random(n) < 0.3).astype(np.int64)
    if kind == "month_words_with_padding":
        live = np.arange(n) < n - n // 3
        months = rng.integers(1, 13, n).astype(np.int32)
        return kc._month_words(months, live, "cpu").numpy()
    if kind == "random64":
        return rng.integers(I64_MIN, (1 << 63) - 1, n, dtype=np.int64,
                            endpoint=True)
    if kind == "all_equal":
        return np.full(n, -7, np.int64)
    raise ValueError(kind)


KEY_CASES = ([(k, 4096) for k in ("sign_bit_only", "top_digit_only",
                                   "compaction_1bit",
                                   "month_words_with_padding", "random64")]
             + [("month_words_with_padding", 3001), ("sign_bit_only", 777)]
             + [("all_equal", n) for n in EDGE_LENGTHS])


@pytest.mark.parametrize("kind,n", KEY_CASES)
def test_plain_sort_matches_torch_sort_and_the_reference(kind, n):
    keys = _keys(kind, n)
    got_k, got_p = ck.sort_pairs_torch(torch.from_numpy(keys))
    want_k, want_p = torch.sort(torch.from_numpy(keys) ^ I64_MIN,
                                stable=True)
    assert torch.equal(got_k, want_k ^ I64_MIN)
    assert torch.equal(got_p.long(), want_p)
    u = keys.view(np.uint64)
    got_u = got_k.numpy().view(np.uint64)
    assert np.array_equal(got_u, np.asarray(sort_xla(jnp.asarray(u))))
    if n >= 256 and n & (n - 1) == 0:
        assert np.array_equal(got_u,
                              np.asarray(sort_pallas(jnp.asarray(u), True)))


PAYLOAD_CASES = [
    ("dup_keys_negative_dup_payload", 4097),
    ("random_keys_full_range_payload", 1000),
    ("equal_keys_negative_payload", 257),
    ("equal_keys_negative_payload", 1),
    ("top_digit_keys_negative_payload", 2048),
]


def _payload_case(kind, n, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "dup_keys_negative_dup_payload":
        return (rng.integers(0, 5, n),
                rng.integers(-40, 40, n).astype(np.int32))
    if kind == "random_keys_full_range_payload":
        return (_keys("random64", n, seed),
                rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32))
    if kind == "equal_keys_negative_payload":
        return (np.full(n, 5, np.int64),
                rng.integers(-1000, 0, n).astype(np.int32))
    return (_keys("top_digit_only", n, seed),
            rng.integers(-3, 3, n).astype(np.int32))


@pytest.mark.parametrize("kind,n", PAYLOAD_CASES)
def test_plain_sort_orders_key_unsigned_then_payload_signed(kind, n):
    keys, pay = _payload_case(kind, n)
    got_k, got_p = ck.sort_pairs_torch(torch.from_numpy(keys),
                                       torch.from_numpy(pay))
    order = np.lexsort((pay, keys.view(np.uint64)))
    assert np.array_equal(got_k.numpy(), keys[order])
    assert np.array_equal(got_p.numpy(), pay[order])
    lib_k, lib_p = kc.library_sort_pairs(torch.from_numpy(keys),
                                         torch.from_numpy(pay))
    assert torch.equal(got_k, lib_k) and torch.equal(got_p, lib_p)


def _varying_slots(keys, pay):
    """Digit slots (0..3 the payload's, sign-flipped; 4..11 the key's)
    in which not every pair agrees, by numpy on unsigned views."""
    slots = []
    if pay is not None:
        up = pay.view(np.uint32) ^ np.uint32(0x80000000)
        slots += [s for s in range(4)
                  if np.unique((up >> np.uint32(8 * s)) & 0xFF).size > 1]
    uk = keys.view(np.uint64)
    slots += [4 + s for s in range(8)
              if np.unique((uk >> np.uint64(8 * s)) & np.uint64(0xFF)).size
              > 1]
    return slots


@pytest.mark.parametrize("kind,n", KEY_CASES + PAYLOAD_CASES)
def test_skip_rule_marks_exactly_the_constant_digits(kind, n):
    if (kind, n) in PAYLOAD_CASES:
        keys, pay = _payload_case(kind, n)
    else:
        keys, pay = _keys(kind, n), None
    got = ck.sort_passes_torch(torch.from_numpy(keys),
                               None if pay is None else torch.from_numpy(pay))
    assert got == _varying_slots(keys, pay)
    if kind == "sign_bit_only":
        assert got == [11]
    elif kind == "top_digit_only":
        assert got == [11]
    elif kind in ("compaction_1bit", "month_words_with_padding") \
            and n == 4096:
        # the month's digit, and the padding rows' null lane and live bit
        assert got == ([4] if kind == "compaction_1bit" else [4, 7, 8])
    elif kind == "all_equal":
        assert got == []


@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_sort_keys_plain_matches_sort_xla_at_edge_lengths(n):
    rng = np.random.default_rng(n)
    k = rng.uniform(-3, 3, n).astype(np.float32)
    k[::5] = np.nan
    k[1::7] = -0.0
    got = ck.sort_keys(torch.from_numpy(k)).numpy()
    want = np.asarray(sort_xla(jnp.asarray(k)))
    # the contract edition returns -0.0 as 0.0 and NaNs canonical
    assert np.array_equal(got, want, equal_nan=True)


def test_timed_path_words_are_the_words_the_path_sorts():
    from spark_rapids_tpu_torch import join_groupby as jg
    from spark_rapids_tpu_torch.exec.base import ExecCtx, collect_arrow
    n_ord, batch, batches = 1 << 9, 1 << 11, 4
    seen = []
    plain = ck.sort_pairs_torch

    def capture(keys, payload=None):
        seen.append(keys.clone())
        return plain(keys, payload)

    plan, _, _ = jg.build_plan(batch * batches, n_ord, batch, device="cpu")
    ck.sort_pairs_torch = capture
    try:
        collect_arrow(plan, ExecCtx(device="cpu"))
    finally:
        ck.sort_pairs_torch = plain
    timed = kc.path_words("cpu", n_ord, batch, batches)
    presort, partial, final = timed.values()
    assert len(seen) == 1 + batches + 1
    assert torch.equal(seen[0], presort)
    for words, want in [(w, partial) for w in seen[1:-1]] \
            + [(seen[-1], final)]:
        assert words.shape == want.shape
        assert torch.equal(words.unique(), want.unique())
        assert ck.sort_passes_torch(words) == ck.sort_passes_torch(want)
