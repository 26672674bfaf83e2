"""Unit tests: pure-JAX ops vs the numpy golden model, plus the algebraic
property tests from SURVEY.md §4.1 (clip bound, JZ zero-slab invariant,
FISTA degenerating to plain at tk_ratio=0, BC behaviors)."""

import numpy as np
import jax.numpy as jnp
import pytest

import golden
from cytvdn_tpu import ops
from cytvdn_tpu.config import BCMode

RNG = np.random.default_rng(42)
SHAPES = {3: (5, 6, 7), 4: (4, 5, 6, 7)}


def rand(shape, dtype=np.float64, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(dtype)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("bc", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_accumulator_update_matches_golden(ndim, bc, dtype):
    tol = 1e-6 if dtype == np.float32 else 1e-13
    for ax in range(ndim):
        a = rand(SHAPES[ndim], dtype)
        b = rand(SHAPES[ndim], dtype, scale=0.1)
        clip = dtype(0.3)
        want_b, want_n = golden.accumulator_update(a, b, ax, clip, bc)
        got_b, got_n = ops.accumulator_update(
            jnp.asarray(a), jnp.asarray(b), ax, clip, BCMode(bc)
        )
        np.testing.assert_allclose(got_b, want_b, atol=tol)
        np.testing.assert_allclose(got_n, want_n, rtol=1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("bc", [0, 1, 2])
def test_accumulator_update_fista_matches_golden(ndim, bc):
    for ax in range(ndim):
        a = rand(SHAPES[ndim])
        b = rand(SHAPES[ndim], scale=0.1)
        d = rand(SHAPES[ndim], scale=0.1)
        clip, tk = 0.3, 0.7
        want_b, want_d, want_n = golden.accumulator_update_fista(
            a, b, d, tk, ax, clip, bc
        )
        got_b, got_d, got_n = ops.accumulator_update_fista(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(d), tk, ax, clip,
            BCMode(bc),
        )
        np.testing.assert_allclose(got_b, want_b, atol=1e-13)
        np.testing.assert_allclose(got_d, want_d, atol=1e-13)
        np.testing.assert_allclose(got_n, want_n, rtol=1e-12)


def test_iso_accumulator_update_matches_golden():
    a = rand(SHAPES[4])
    b1 = rand(SHAPES[4], scale=0.1)
    b2 = rand(SHAPES[4], scale=0.1)
    for ax1, ax2 in [(0, 1), (2, 3)]:
        want = golden.iso_accumulator_update(a, b1, b2, ax1, ax2, 0.2)
        got = ops.iso_accumulator_update(
            jnp.asarray(a), jnp.asarray(b1), jnp.asarray(b2), ax1, ax2, 0.2
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-13)


def test_iso_accumulator_update_fista_matches_golden():
    a = rand(SHAPES[4])
    b1, b2 = rand(SHAPES[4], scale=0.1), rand(SHAPES[4], scale=0.1)
    d1, d2 = rand(SHAPES[4], scale=0.1), rand(SHAPES[4], scale=0.1)
    want = golden.iso_accumulator_update_fista(a, b1, b2, d1, d2, 0.6, 2, 3, 0.2)
    got = ops.iso_accumulator_update_fista(
        jnp.asarray(a), jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(d1),
        jnp.asarray(d2), 0.6, 2, 3, 0.2,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-13)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("bc", [0, 1, 2])
def test_datacube_update_matches_golden(ndim, bc):
    orig = rand(SHAPES[ndim])
    recon = rand(SHAPES[ndim])
    bs = [rand(SHAPES[ndim], scale=0.2) for _ in range(ndim)]
    lam_mu = np.full(ndim, 1.0 / 32, dtype=np.float64)
    want_recon, want_delta = golden.datacube_update(orig, recon, bs, lam_mu, bc)
    got_recon, dnum, dden = ops.datacube_update(
        jnp.asarray(orig), jnp.asarray(recon), [jnp.asarray(b) for b in bs],
        jnp.asarray(lam_mu), BCMode(bc),
    )
    np.testing.assert_allclose(got_recon, want_recon, atol=1e-13)
    np.testing.assert_allclose(float(dnum) / float(dden), want_delta, rtol=1e-12)


def test_sum_square_error():
    a, b = rand(SHAPES[4]), rand(SHAPES[4])
    np.testing.assert_allclose(
        ops.sum_square_error(jnp.asarray(a), jnp.asarray(b)),
        golden.sum_square_error(a, b),
        rtol=1e-12,
    )


# ---- property tests -------------------------------------------------------


def test_clip_bound_property():
    """|b| <= clip always holds after an unaccelerated update."""
    a, b = rand(SHAPES[4], scale=10), rand(SHAPES[4], scale=10)
    for ax in range(4):
        bn, _ = ops.accumulator_update(jnp.asarray(a), jnp.asarray(b), ax, 0.25)
        assert float(jnp.max(jnp.abs(bn))) <= 0.25 + 1e-15


def test_jz_zero_slab_invariant():
    """Under Jia-Zhao BCs the accumulator slab at index 0 along its axis
    stays identically zero through repeated updates (SURVEY.md §8.1) — the
    invariant that makes the periodic wraparound in the reconstruction
    update exact."""
    a = jnp.asarray(rand(SHAPES[3]))
    b = jnp.zeros_like(a)
    d = jnp.zeros_like(a)
    for ax in range(3):
        bb, dd = b, d
        for _ in range(5):
            bb, dd, _ = ops.accumulator_update_fista(
                a, bb, dd, 0.8, ax, 0.3, BCMode.JIA_ZHAO
            )
        slab = jnp.take(bb, jnp.array([0]), axis=ax)
        assert float(jnp.max(jnp.abs(slab))) == 0.0


def test_fista_zero_momentum_equals_plain():
    """With tk_ratio=0, the FISTA update's b equals the plain update's b."""
    a, b = rand(SHAPES[3]), rand(SHAPES[3], scale=0.1)
    d = rand(SHAPES[3], scale=0.1)
    for ax in range(3):
        plain_b, _ = ops.accumulator_update(jnp.asarray(a), jnp.asarray(b), ax, 0.3)
        f_b, f_d, _ = ops.accumulator_update_fista(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(d), 0.0, ax, 0.3
        )
        np.testing.assert_array_equal(np.asarray(plain_b), np.asarray(f_b))
        np.testing.assert_array_equal(np.asarray(plain_b), np.asarray(f_d))


def test_halo_operand_equals_full_array_slice():
    """Computing an accumulator update on the right half of an array with
    the left half's last slab passed as halo must equal the full-array
    update restricted to the right half — the exactness property the
    sharded solver is built on (SURVEY.md §8.3)."""
    a = rand((8, 6, 4))
    b = rand((8, 6, 4), scale=0.1)
    full_b, _ = golden.accumulator_update(a, b, 0, 0.3, 2)
    halo = a[3:4]  # last slab of the left shard
    got_b, _ = ops.accumulator_update(
        jnp.asarray(a[4:]), jnp.asarray(b[4:]), 0, 0.3, BCMode.JIA_ZHAO,
        halo_prev=jnp.asarray(halo),
    )
    np.testing.assert_allclose(got_b, full_b[4:], atol=1e-14)


def test_forward_halo_operand_equals_full_array_slice():
    """Same exactness property for the reconstruction update's forward
    difference: left shard receives the right shard's first slab."""
    orig, recon = rand((8, 6, 4)), rand((8, 6, 4))
    bs = [rand((8, 6, 4), scale=0.2) for _ in range(3)]
    lam_mu = np.full(3, 1.0 / 32)
    want, _ = golden.datacube_update(orig, recon, bs, lam_mu, 2)
    halos = [jnp.asarray(bs[0][4:5]), None, None]
    got, _, _ = ops.datacube_update(
        jnp.asarray(orig[:4]), jnp.asarray(recon[:4]),
        [jnp.asarray(b[:4]) for b in bs], jnp.asarray(lam_mu),
        BCMode.JIA_ZHAO, halos,
    )
    np.testing.assert_allclose(got, want[:4], atol=1e-14)


def test_tv_energy_improves_and_stabilizes():
    """The converged solution has lower ROF energy than the noisy input,
    and the energy stabilizes (the dual iteration is not monotone in the
    primal objective while the accumulators ramp up — only the limit is
    the minimizer)."""
    from cytvdn_tpu.ops import stencil
    from cytvdn_tpu import denoise3D

    rng = np.random.default_rng(9)
    f = (rng.standard_normal((8, 8, 32)) * 0.3 + 1.0)
    mu = np.full(3, 1.0)
    lam = mu / 16.0

    def energy(u):
        return float(stencil.tv_energy(jnp.asarray(u), jnp.asarray(f),
                                       jnp.asarray(lam), jnp.asarray(mu)))

    e_noisy = energy(f)
    r60, _, _ = denoise3D(f, mu, iterations=60, FISTA=False, quiet=True)
    r200, _, _ = denoise3D(f, mu, iterations=200, FISTA=False, quiet=True)
    assert energy(r200) < e_noisy * 0.9
    assert abs(energy(r200) - energy(r60)) < 0.01 * e_noisy


def test_perf_model():
    from cytvdn_tpu.utils.perf import (efficiency, speed_of_light,
                                       traversals_per_iteration)

    assert traversals_per_iteration(4, True, "one_pass") == 19
    assert traversals_per_iteration(4, False, "one_pass") == 11
    assert traversals_per_iteration(4, True, "two_pass") == 24
    assert traversals_per_iteration(3, True, "two_pass") == 19
    assert traversals_per_iteration(4, True, "reference") == 22
    h100 = "NVIDIA H100 80GB HBM3"
    sol = speed_of_light((128, 128, 128, 128), h100)
    assert sol == 3.35e12 / (19 * 4)
    assert 0 < efficiency(5.1e9, (128,) * 4, h100) < 1
