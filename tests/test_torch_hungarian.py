"""The port's batched Jonker-Volgenant solver against the JAX package's
``hungarian_assign`` (bit-equal ``col4row``, invalid rows included) and
against ``scipy.optimize.linear_sum_assignment`` (the valid rows' total
cost)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from phnet_torch.ops.hungarian import hungarian_assign
from phnet_tpu.ops.hungarian import hungarian_assign as jax_hungarian


@pytest.fixture(scope="module")
def jax_solve():
    return jax.jit(jax.vmap(jax_hungarian))


def problems(seed, n, r, c, kind):
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(n, r, c)).astype(np.float32)
    valid = rng.uniform(size=(n, r)) < 0.7
    if kind == "tied":  # costs on a grid of 1/2: many exact ties
        cost = np.round(cost * 2) / 2
    elif kind == "constant":  # every column costs the same
        cost[:] = 1.0
    elif kind == "all_valid":
        valid[:] = True
    elif kind == "none_valid":
        valid[:] = False
    elif kind == "large":  # the criterion's scale: costs of a few units
        cost = cost * 3.0 - 1.0
    return cost, valid


KINDS = ("seeded", "tied", "constant", "all_valid", "none_valid", "large")


@pytest.mark.parametrize("shape", [(16, 8, 240), (16, 4, 32), (8, 8, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_col4row_bit_equal_to_jax(jax_solve, shape, kind):
    cost, valid = problems(10 * KINDS.index(kind) + shape[1], *shape, kind)
    ref = np.asarray(jax_solve(jnp.asarray(cost), jnp.asarray(valid)))
    got = hungarian_assign(torch.from_numpy(cost),
                           torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ("seeded", "tied", "all_valid", "large"))
def test_optimal_and_distinct(kind):
    """Distinct columns for every row; the valid rows' total cost equals
    scipy's optimum."""
    cost, valid = problems(7, 24, 8, 240, kind)
    got = hungarian_assign(torch.from_numpy(cost),
                           torch.from_numpy(valid)).numpy()
    for k in range(cost.shape[0]):
        assert len(set(got[k].tolist())) == cost.shape[1]
        rows = np.nonzero(valid[k])[0]
        if len(rows) == 0:
            continue
        r, c = linear_sum_assignment(cost[k][rows])
        np.testing.assert_allclose(cost[k][rows, got[k][rows]].sum(),
                                   cost[k][rows][r, c].sum(), rtol=0,
                                   atol=1e-4)


def test_more_rows_than_columns_raises():
    with pytest.raises(ValueError, match="rows"):
        hungarian_assign(torch.zeros(1, 5, 4), torch.ones(1, 5, dtype=bool))
