"""vitta_tpu_torch/ops/relation.py against vitta_tpu/ops/relation.py on
seeded inputs, on the CPU.

Tolerances: the pair order exactly; cosines, maps and losses rtol 1e-4 /
atol 1e-6.  The port takes the cosine from the Gram matrix of the rows and
the rows' norms, the JAX package from the two gathered operands: the same
products summed in another order over up to D = 360 terms here, float32.
``"spatial"`` goes through an SVD whose component signs are free (a
component and its negative are the same principal axis), so there the
rearranged feature is compared up to the sign of each row, and the cosine
vector (a ratio that flips with either row's sign) by magnitude; the
tolerance is rtol 1e-3 / atol 1e-4, LAPACK's and XLA's SVD differ beyond
rounding in the small components.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops import relation as jrel
from vitta_tpu_torch.ops import relation as rel

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
SIGN_FREE = ("spatial",)


def _feature(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n", [2, 3, 8, 16])
def test_pair_order_is_the_reference_s(n):
    i1, i2 = rel.upper_triangle_idx(n)
    j1, j2 = jrel.upper_triangle_idx(n)
    assert i1.tolist() == np.asarray(j1).tolist()
    assert i2.tolist() == np.asarray(j2).tolist()
    assert len(i1) == n * (n - 1) // 2 and all(a < b for a, b in zip(i1, i2))


@pytest.mark.parametrize("shape", [(3, 4, 360), (1, 16, 50), (2, 2, 7)],
                         ids=str)
def test_upper_triangle_cosine(shape):
    f = _feature(shape)
    got = rel.upper_triangle_cosine(torch.from_numpy(f))
    want = jrel.upper_triangle_cosine(jnp.asarray(f))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cosine_of_a_zero_row_is_clamped_not_nan():
    f = _feature((2, 3, 5))
    f[0, 1] = 0.0
    got = rel.upper_triangle_cosine(torch.from_numpy(f))
    want = jrel.upper_triangle_cosine(jnp.asarray(f))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_exp_norm_relation_map():
    sym = _feature((2, 5, 5), seed=1)
    got = rel.exp_norm_relation_map(torch.from_numpy(sym))
    want = jrel.exp_norm_relation_map(jnp.asarray(sym))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.sum(2).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("stat_type", ["temp", "spatiotemp", "channel",
                                       "spatial"])
def test_rearrangements(stat_type):
    x = _feature((2, 3, 4, 5, 6), seed=2)
    got = rel._rearrange_ncthw(torch.from_numpy(x), stat_type).numpy()
    want = np.asarray(jrel._rearrange_ncthw(jnp.asarray(x), stat_type))
    assert got.shape == want.shape
    if stat_type in SIGN_FREE:
        # (1, T, HW): each row is a principal component, sign free
        sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
        np.testing.assert_allclose(got * sign, want, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stat_type", ["temp", "spatiotemp", "channel",
                                       "spatial"])
def test_pairwise_similarity(stat_type):
    x = _feature((2, 3, 4, 5, 6), seed=3)
    got = rel.pairwise_similarity(torch.from_numpy(x), stat_type).numpy()
    want = np.asarray(jrel.pairwise_similarity(jnp.asarray(x), stat_type))
    assert got.shape == want.shape
    if stat_type in SIGN_FREE:
        np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-3,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stat_type", ["temp", "channel"])
def test_relation_map(stat_type):
    # small values: exp of a Gram matrix's entries overflows quickly
    x = 0.1 * _feature((2, 3, 4, 5, 6), seed=4)
    got = rel.relation_map(torch.from_numpy(x), stat_type).numpy()
    want = np.asarray(jrel.relation_map(jnp.asarray(x), stat_type))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reg_type", ["l1_loss", "mse_loss"])
def test_cossim_regularization(reg_type):
    a, b = _feature((6,), seed=5), _feature((6,), seed=6)
    got = rel.cossim_regularization(torch.from_numpy(a), torch.from_numpy(b),
                                    reg_type)
    want = jrel.cossim_regularization(jnp.asarray(a), jnp.asarray(b), reg_type)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        rel.cossim_regularization(torch.from_numpy(a), torch.from_numpy(b),
                                  "kld")


def test_cosine_gradient_matches_jax():
    """The cossim loss differentiates through the Gram form as through the
    gathered form."""
    import jax
    f = _feature((2, 4, 30), seed=7)
    w = _feature((2, 6), seed=8)
    want = jax.grad(lambda a: jnp.sum(jrel.upper_triangle_cosine(a) * w))(
        jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_()
    (rel.upper_triangle_cosine(ft) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
