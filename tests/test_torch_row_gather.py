"""K6 row_gather's plain version (the CPU path of ``kernels/row_gather.py``)
against numpy indexing and ``jnp.take`` on the same inputs.

The function is exp_gather's ``dma_gather`` (``out[i] = table[slots[i]]``)
with the rebase's two additions: a zero row where a slot is negative (an
empty slot of the rebuilt map) and an optional float32 row ``sub``
subtracted from every gathered row (the shift). Identical results: a
gather moves bits, and the subtraction is one float32 operation, the same
in numpy and torch. N is not a multiple of the Pallas kernel's 512-row
blocks: every row must be written.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_icp_torch.kernels import row_gather as k6


def _case(w, dtype, n, seed):
    rng = np.random.default_rng(seed)
    c = 1000
    if dtype == np.float32:
        table = rng.standard_normal((c, w)).astype(np.float32) * 50.0
    else:
        table = rng.integers(-2 ** 31, 2 ** 31 - 1, (c, w)).astype(np.int32)
    slots = rng.integers(0, c, n).astype(np.int32)
    slots[rng.uniform(size=n) < 0.25] = -1
    slots[:3] = (-7, c - 1, 0)
    return table, slots


def _reference(table, slots, sub):
    ok = slots >= 0
    want = np.zeros((slots.shape[0], table.shape[1]), table.dtype)
    want[ok] = table[slots[ok]]
    if sub is not None:
        want[ok] = want[ok] - sub
    taken = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(slots[ok]),
                                axis=0))
    return want, taken, ok


@pytest.mark.parametrize("w", [1, 3, 90, 128])
@pytest.mark.parametrize("dtype, with_sub", [(np.float32, False),
                                             (np.float32, True),
                                             (np.int32, False)])
def test_row_gather_plain_matches_numpy_and_take(w, dtype, with_sub):
    n = 1700
    table, slots = _case(w, dtype, n, seed=w)
    sub = (np.random.default_rng(1).standard_normal(w).astype(np.float32)
           if with_sub else None)
    want, taken, ok = _reference(table, slots, sub)
    got = k6.row_gather(torch.from_numpy(table), torch.from_numpy(slots),
                        None if sub is None else torch.from_numpy(sub))
    assert got.dtype == torch.from_numpy(table).dtype
    assert tuple(got.shape) == (n, w)
    np.testing.assert_array_equal(got.numpy(), want)
    if sub is None:
        np.testing.assert_array_equal(got.numpy()[ok], taken)
    else:
        np.testing.assert_array_equal(got.numpy()[ok], taken - sub)
    # empty slots are zero rows (not -sub), every row written
    assert not got.numpy()[~ok].any()
    assert n % 512 and ok[n - n % 512:].any()


def test_row_gather_is_exp_gather_at_its_shape():
    """exp_gather's Pallas configuration, cut in C: 128 f32 columns, random
    slots in [0, C), no sub: out == table[slots]."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((1 << 12, 128)).astype(np.float32)
    slots = rng.integers(0, table.shape[0], 16384).astype(np.int32)
    got = k6.row_gather(torch.from_numpy(table), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), table[slots])


def test_row_gather_bound_counts_distinct_rows():
    """The bytes K6's bound charges (one count, used by chip_smoke.py and
    tools/exp_gather.py): each distinct row read once, the slots, ``sub``
    and every output row."""
    from ct_icp_torch.tools import exp_gather, timing

    table = torch.zeros((8, 3))
    slots = torch.tensor([1, 1, -1, 4, 1], dtype=torch.int32)
    assert exp_gather.k6_bytes(table, slots) == 2 * 12 + 5 * 4 + 5 * 12
    assert exp_gather.k6_bytes(table, slots, torch.zeros(3)) == \
        2 * 12 + 5 * 4 + 5 * 12 + 12
    assert timing.bound(timing.HBM_BYTES_PER_S * 1e-3, 0.0) == (1.0, "bytes")
    assert timing.bound(0.0, timing.FP32_OPS_PER_S * 1e-3) == \
        (1.0, "operations")
