"""The two-pass GPU step (``kernels/step.py``) in interpret mode against the
XLA ops path it replaces on the card.

Shapes are odd and non-power-of-two, and the block and chunk sizes are
chosen so that a slab's flat index ends mid-block (masked lanes) and the
last program's axis-0 chunk is short. The neighbour reads are what can go
wrong: backward neighbours of ``recon`` across block edges, forward
neighbours of the updated accumulators across block edges and, along
axis 0, across chunk edges and from the last slab back to the first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cytvdn_tpu import ops
from cytvdn_tpu.config import BCMode, SolverOptions
from cytvdn_tpu.kernels import step as gstep
from cytvdn_tpu.solver.engine import NullComm, step_partials

SHAPES = [(5, 6, 7), (7, 5, 33), (2, 3, 50), (4, 3, 5, 6), (3, 7, 1, 9),
          (6, 2, 3, 11)]
#: (block, chunk): small blocks split every slab into several programs;
#: (1024, 64) is one program per slab row; (1024, None) the default choice
GEOMETRY = [(16, 2), (64, 3), (1024, 64), (1024, None)]


def _state(shape, seed, fista):
    rng = np.random.default_rng(seed)
    n = len(shape)

    def arr(scale, offset=0.0):
        return jnp.asarray(rng.standard_normal(shape) * scale + offset,
                           jnp.float32)

    orig = arr(0.3, 1.0)
    recon = orig + arr(0.05)
    accs = tuple(arr(0.02) for _ in range(n))
    ds = tuple(arr(0.02) for _ in range(n)) if fista else None
    li = jnp.asarray(np.linspace(20.0, 40.0, n), jnp.float32)
    return orig, recon, accs, ds, li, 1.0 / li


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("block,chunk", GEOMETRY)
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_accumulator_pass_matches_ops(shape, fista, block, chunk):
    orig, recon, accs, ds, li, _ = _state(shape, 1, fista)
    tk = jnp.float32(0.37) if fista else None
    got_b, got_d, got_n = jax.jit(lambda r, a, d: gstep.accumulator_pass(
        r, a, d, tk, li, block=block, chunk=chunk, interpret=True))(
            recon, accs, ds)
    norm = 0.0
    for k in range(len(shape)):
        if fista:
            b, d, nk = ops.accumulator_update_fista(
                recon, accs[k], ds[k], tk, k, li[k], BCMode.JIA_ZHAO)
            _close(got_d[k], d)
        else:
            b, nk = ops.accumulator_update(recon, accs[k], k, li[k],
                                           BCMode.JIA_ZHAO)
        _close(got_b[k], b)
        norm += float(nk)
    assert (got_d is None) == (not fista)
    np.testing.assert_allclose(float(got_n), norm, rtol=1e-5)


@pytest.mark.parametrize("block,chunk", GEOMETRY)
@pytest.mark.parametrize("shape", SHAPES)
def test_recon_pass_matches_ops(shape, block, chunk):
    orig, recon, accs, _, _, lm = _state(shape, 2, False)
    got_r, got_dn, got_rn = jax.jit(lambda o, r, a: gstep.recon_pass(
        o, r, a, lm, block=block, chunk=chunk, interpret=True))(
            orig, recon, accs)
    r, dn, rn = ops.datacube_update(orig, recon, accs, lm, BCMode.JIA_ZHAO)
    _close(got_r, r)
    np.testing.assert_allclose(float(got_dn), float(dn), rtol=1e-5)
    np.testing.assert_allclose(float(got_rn), float(rn), rtol=1e-5)


@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_gpu_step_matches_step_partials(shape, fista):
    """The whole step under the engine's ``step_partials`` contract."""
    orig, recon, accs, ds, li, lm = _state(shape, 3, fista)
    tk = jnp.float32(0.5) if fista else None
    opts = SolverOptions(ndim=len(shape), iterations_fista=int(fista),
                         iterations_unacc=int(not fista))
    want = step_partials(orig, recon, accs, ds, tk, li, lm, opts, NullComm())
    got = jax.jit(lambda *a: gstep.gpu_step(*a, block=32, chunk=2,
                                            interpret=True))(
        orig, recon, accs, ds, tk, li, lm)
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close(g, w)
    if fista:
        for g, w in zip(got[2], want[2]):
            _close(g, w)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_jz_zero_slab_invariant_survives_the_step():
    """Starting from zero duals, every accumulator stays zero at
    coordinate 0 along its own axis — the invariant the recon pass relies
    on when it reads coordinate 0 as the last coordinate's forward
    neighbour."""
    shape = (5, 4, 6, 7)
    orig = jnp.asarray(np.random.default_rng(4).standard_normal(shape),
                       jnp.float32)
    zeros = tuple(jnp.zeros(shape, jnp.float32) for _ in range(4))
    li = jnp.full((4,), 3.0, jnp.float32)
    state = (orig, zeros, zeros)
    for i in range(3):
        r, a, d, *_ = gstep.gpu_step(orig, state[0], state[1], state[2],
                                     jnp.float32(0.2 * i), li, 1.0 / li,
                                     block=16, chunk=2, interpret=True)
        state = (r, a, d)
    for k in range(4):
        for arr in (state[1][k], state[2][k]):
            np.testing.assert_array_equal(
                np.take(np.asarray(arr), 0, axis=k), 0.0)


def test_in_place_under_donation():
    """Donated state: the passes alias their state inputs to outputs and
    the result is unchanged."""
    shape = (6, 5, 9)
    orig, recon, accs, ds, li, lm = _state(shape, 5, True)

    def step(o, r, a, d):
        return gstep.gpu_step(o, r, a, d, jnp.float32(0.3), li, lm,
                              block=16, chunk=2, interpret=True)

    want = jax.jit(step)(orig, recon, accs, ds)
    got = jax.jit(step, donate_argnums=(1, 2, 3))(
        orig, recon + 0.0, tuple(a + 0.0 for a in accs),
        tuple(d + 0.0 for d in ds))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("shape,block,chunk,want_chunk,grid", [
    ((256, 256, 72, 72), 1024, None, 32, (1296, 8)),
    ((256, 256, 128, 128), 1024, None, 32, (4096, 8)),
    ((256, 256, 2048), 1024, None, 32, (512, 8)),
    # small cubes split axis 0 finer so the launch keeps >= MIN_PROGRAMS
    ((64, 64, 512), 1024, None, 2, (32, 32)),
    ((64, 64, 32, 32), 1024, None, 4, (64, 16)),
    ((8, 8, 8), 1024, None, 1, (1, 8)),
    ((5, 6, 7), 16, 2, 2, (3, 3)),
    ((1, 1, 1), 16, 2, 2, (1, 1)),
])
def test_geometry(shape, block, chunk, want_chunk, grid):
    inner, got_chunk, got = gstep._geometry(shape, block, chunk)
    assert inner == int(np.prod(shape[1:]))
    assert got_chunk == want_chunk
    assert got == grid


@pytest.mark.parametrize("kw,dtype,ok", [
    ({}, jnp.float32, True),
    ({"iterations_fista": 0, "iterations_unacc": 3}, jnp.float32, True),
    ({}, jnp.float64, False),
    ({"bc_mode": BCMode.MIRROR}, jnp.float32, False),
    ({"bc_mode": BCMode.PERIODIC}, jnp.float32, False),
    ({"isotropic_R": True}, jnp.float32, False),
    ({"isotropic_Q": True}, jnp.float32, False),
    ({"lossy_duals": True}, jnp.float32, False),
    ({"calculate_mse": True, "stopping_relative_change": 1e-3},
     jnp.float32, True),
])
def test_covers(kw, dtype, ok):
    base = dict(ndim=4, iterations_fista=3, iterations_unacc=0)
    base.update(kw)
    assert gstep.covers(SolverOptions(**base), dtype, 4096) is ok


@pytest.mark.parametrize("size,ok", [
    (1, True),
    (gstep.MAX_SIZE, True),
    (gstep.MAX_SIZE + 1, False),
    (2**31, False),
    (256 * 256 * 128 * 128, True),
])
def test_covers_only_int32_indexable_cubes(size, ok):
    """Every flat offset the kernels compute, the masked tail of the last
    block included, stays below 2**31."""
    opts = SolverOptions(ndim=4, iterations_fista=3, iterations_unacc=0)
    assert gstep.covers(opts, jnp.float32, size) is ok
    if ok:
        assert size + gstep.BLOCK - 1 <= 2**31 - 1


def test_every_call_names_the_triton_route():
    """Each pallas_call lowers for CUDA as a Triton kernel (checked on the
    host: lowering stops before PTX)."""
    shape = (9, 5, 7)
    s = jax.ShapeDtypeStruct(shape, jnp.float32)
    v = jax.ShapeDtypeStruct((3,), jnp.float32)
    t = jax.ShapeDtypeStruct((), jnp.float32)
    text = jax.jit(gstep.gpu_step).trace(
        s, s, (s,) * 3, (s,) * 3, t, v, v).lower(
            lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 2


@pytest.mark.gpu
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", [(64, 64, 32, 32), (33, 65, 257)])
def test_compiled_step_matches_ops_on_card(shape, fista):
    """The compiled kernels (no interpreter) against the ops path on the
    card, at the default block and chunk."""
    orig, recon, accs, ds, li, lm = _state(shape, 6, fista)
    tk = jnp.float32(0.4) if fista else None
    opts = SolverOptions(ndim=len(shape), iterations_fista=int(fista),
                         iterations_unacc=int(not fista))
    want = jax.jit(lambda *a: step_partials(*a, opts, NullComm()))(
        orig, recon, accs, ds, tk, li, lm)
    got = jax.jit(gstep.gpu_step)(orig, recon, accs, ds, tk, li, lm)
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close(g, w)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
