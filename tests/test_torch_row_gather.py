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


def _rebase_fields(rng, c, n, p):
    """The rebase's four fields (points [C, 3P] f32, normals [C, 3] f32,
    counts and flags [C, 1] int32), the shift and slots with empty (-1),
    out-of-range (C, C + 9) and repeated rows."""
    tables = (rng.standard_normal((c, 3 * p)).astype(np.float32) * 50.0,
              rng.standard_normal((c, 3)).astype(np.float32),
              rng.integers(0, p + 1, (c, 1)).astype(np.int32),
              rng.integers(0, 4, (c, 1)).astype(np.int32))
    shift = rng.standard_normal(3).astype(np.float32) * 100.0
    slots = rng.integers(0, c, n)
    slots[rng.uniform(size=n) < 0.6] = -1
    slots[:6] = (-1, c, c + 9, 7, 7, 7)
    return tables, shift, slots.astype(np.int32)


@pytest.mark.parametrize("n", [7, 301, 1700])
def test_row_gather_fields_is_one_plain_gather_a_field(n):
    """The rebase's one-launch form (points minus the shift per plane,
    normals, counts, flags) equals four ``row_gather_plain`` calls, at
    W = 90 / 3 / 1 / 1, and numpy's indexing; the counts' sum is K7's
    num_points."""
    rng = np.random.default_rng(n)
    p, c = 30, 500
    tables, shift, slots = _rebase_fields(rng, c, n, p)
    tt = tuple(torch.from_numpy(t) for t in tables)
    ts = torch.from_numpy(slots)
    sub = torch.from_numpy(shift)
    outs = k6.row_gather_fields(tt, ts, (sub, None, None, None))
    want = (k6.row_gather_plain(tt[0], ts, sub.repeat_interleave(p)),
            *(k6.row_gather_plain(t, ts) for t in tt[1:]))
    assert [o.shape[1] for o in outs] == [90, 3, 1, 1]
    ok = (slots >= 0) & (slots < c)
    for got, w, t in zip(outs, want, tables):
        assert got.dtype == w.dtype
        assert torch.equal(got, w)
        ref = np.zeros((n, t.shape[1]), t.dtype)
        ref[ok] = t[slots[ok]]
        if t.shape[1] == 3 * p:
            ref[ok] -= np.repeat(shift, p)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert int(outs[2].sum()) == int(tables[2][slots[ok]].sum())
    # the repeated row, and zero rows for -1, C, C + 9
    assert torch.equal(outs[0][3], outs[0][5])
    assert not outs[0][:3].any() and not outs[2][:3].any()


def test_row_gather_sub_by_plane_is_its_repeat():
    """A sub of S entries (S dividing W) is the same as its W-entry repeat:
    entry j // (W / S) on column j."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((64, 12)).astype(
        np.float32))
    slots = torch.from_numpy(rng.integers(-2, 70, 200).astype(np.int32))
    sub = torch.tensor([1.5, -2.0, 3.25])
    assert torch.equal(k6.row_gather(table, slots, sub),
                       k6.row_gather(table, slots, sub.repeat_interleave(4)))
    (out,) = k6.row_gather_fields((table,), slots)
    assert torch.equal(out, k6.row_gather_plain(table, slots))
