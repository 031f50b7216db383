"""Port vs JAX package: the row scatter-add and the table gather whose
gradient it is (``ops/scatter.py`` against ``ops/pallas_scatter.py``).

On the CPU the port's wrapper runs its plain ``index_add_`` version; the JAX
kernel runs in interpret mode. Both sum float32 rows in different orders:
rtol 1e-5, atol 1e-5 for Gaussian rows (as tests/test_pallas.py holds the JAX
kernel against XLA), bit-equal for rows that are small multiples of 1/8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.ops import pallas_scatter as jps
from furusato_recommend_tpu_torch.ops import scatter as ts

torch.set_num_threads(1)


def _case(n, d, r, seed, exact=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, r).astype(np.int32)
    if exact:
        rows = (rng.integers(-8, 9, (r, d)) / 8).astype(np.float32)
    else:
        rows = rng.standard_normal((r, d)).astype(np.float32)
    return ids, rows


@pytest.mark.parametrize(
    "n,d,r,exact",
    [
        (300, 32, 5000, False),  # r not a chunk multiple: the JAX kernel pads
        (64, 64, 2048, True),
        (20, 8, 4096, True),  # d < 128: the JAX kernel packs 16 rows per lane row
    ],
)
def test_scatter_add_rows_matches_jax_kernel(n, d, r, exact):
    ids, rows = _case(n, d, r, seed=n + d, exact=exact)
    want = np.asarray(jps.scatter_add_rows(jnp.asarray(ids), jnp.asarray(rows), n, interpret=True))
    got = ts.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), n).numpy()
    assert got.shape == (n, d) and got.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "n,d,r",
    [
        (50, 64, 0),  # no rows: a zero table
        (1, 16, 300),  # one row takes every update
        (5000, 64, 999),  # R not a multiple of 32
    ],
)
def test_scatter_add_rows_matches_xla_scatter(n, d, r):
    ids, rows = _case(n, d, r, seed=r + 1)
    want = np.asarray(jnp.zeros((n, d), jnp.float32).at[jnp.asarray(ids)].add(jnp.asarray(rows)))
    got = ts.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_scatter_repeated_id_and_clamped_ids():
    # one id 5,000 times (a hub item); ids outside [0, n) clamp into the
    # table, as the JAX kernel's callers clip them
    n, d = 40, 16
    rng = np.random.default_rng(9)
    ids = np.concatenate([np.full(5000, 7), [-3, n, n + 100, 0]]).astype(np.int32)
    rows = (rng.integers(-4, 5, (len(ids), d)) / 8).astype(np.float32)
    want = np.asarray(
        jnp.zeros((n, d)).at[jnp.clip(jnp.asarray(ids), 0, n - 1)].add(jnp.asarray(rows))
    )
    got = ts.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), n).numpy()
    np.testing.assert_array_equal(got, want)
    ref = ts.scatter_add_rows_reference(torch.from_numpy(ids).long(), torch.from_numpy(rows), n)
    np.testing.assert_array_equal(ref.numpy(), want)


def test_scatter_rejects_bad_input_and_never_launches_on_cpu():
    ts.launches = 0
    with pytest.raises(ValueError):
        ts.scatter_add_rows(torch.zeros(3, dtype=torch.int32), torch.zeros(4, 2), 5)
    with pytest.raises(ValueError):
        ts.scatter_add_rows(torch.zeros(3), torch.zeros(3, 2), 5)
    with pytest.raises(ValueError):
        ts.scatter_add_rows(torch.zeros(3, dtype=torch.int32), torch.zeros(3, 2), 0)
    ids, rows = _case(10, 4, 50, seed=0)
    ts.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), 10)
    assert ts.launches == 0


@pytest.mark.parametrize("shape", [(7, 9), (64,)])
def test_table_gather_value_and_grad_match_jax(shape):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, shape).astype(np.int32)
    weight = rng.standard_normal(shape + (8,)).astype(np.float32)

    def f(t):
        return jnp.sum(jps.table_gather(t, jnp.asarray(ids)) ** 2 * weight)

    want_v, want_g = jax.value_and_grad(f)(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = ts.table_gather(t, torch.from_numpy(ids))
    assert out.shape == shape + (8,)
    got_v = torch.sum(out**2 * torch.from_numpy(weight))
    got_v.backward()
    np.testing.assert_allclose(float(got_v.detach()), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
