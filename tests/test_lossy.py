"""Opt-in lossy bf16-duals mode (SolverOptions.lossy_duals).

The mode stores the FISTA shadow duals (``d``) in bfloat16 while all
compute stays float32; these tests pin the shipped mode's semantics:

- the rounding cadence is per-iteration in EVERY execution path
  (single device, mesh, chunked, out-of-core), so the state invariant
  (state bit-exact across chunking/checkpoint choices) holds for lossy
  runs too. The engine is pinned against an explicit eager ops-path
  emulation at ulp tolerance (eager emulation vs the jitted engine
  differ by fusion contraction, so bit-equality is not expected there)
  while the WRONG cadence sits 3 orders of magnitude away;
- the end-to-end drift is nonzero (the mode really is lossy) and
  bounded;
- invalid combinations are rejected loudly (f64/iso/non-JZ).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cytvdn_tpu import ops
from cytvdn_tpu.config import Backend, BCMode, SolverOptions
from cytvdn_tpu.solver.engine import fista_tk_ratios, run_solver


def _cube(shape, seed=0):
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    orig = jnp.asarray(rng.standard_normal(shape) * 0.4 + 1.0,
                       dtype=jnp.float32)
    li = jnp.asarray(np.full(ndim, 32.0, np.float32))
    lm = jnp.asarray(np.full(ndim, 1 / 32.0, np.float32))
    return orig, li, lm


def _emulate(orig, li, lm, n_iter, round_every):
    """Explicit eager ops-path FISTA run with ``d`` rounded to bf16 at
    every ``round_every``-th iteration writeback (1 = the shipped
    semantics)."""
    ndim = orig.ndim
    tks = fista_tk_ratios(n_iter).astype(np.float32)
    recon = orig
    accs = [jnp.zeros(orig.shape, jnp.float32) for _ in range(ndim)]
    ds = [jnp.zeros(orig.shape, jnp.float32) for _ in range(ndim)]
    for i in range(n_iter):
        accs_n, ds_n = [], []
        for ax in range(ndim):
            b, d, _ = ops.accumulator_update_fista(
                recon, accs[ax], ds[ax], jnp.float32(tks[i]), ax,
                li[ax], BCMode.JIA_ZHAO, None)
            accs_n.append(b)
            ds_n.append(d)
        recon, _, _ = ops.datacube_update(
            orig, recon, accs_n, lm, BCMode.JIA_ZHAO, [None] * ndim)
        accs = accs_n
        if (i + 1) % round_every == 0:
            ds = [d.astype(jnp.bfloat16).astype(jnp.float32)
                  for d in ds_n]
        else:
            ds = ds_n
    return np.asarray(recon)


@pytest.mark.parametrize("shape", [(8, 6, 64), (6, 4, 6, 16)])
def test_k1_lossy_cadence_vs_emulation(shape):
    """The engine with bf16 ds == ops emulation rounding every
    iteration, to ulps — and 3+ orders of magnitude away from rounding
    every other iteration (so the test discriminates the writeback
    boundary, not just 'roughly lossy')."""
    orig, li, lm = _cube(shape)
    n = 5
    opts = SolverOptions(ndim=len(shape), iterations_fista=n,
                         iterations_unacc=0, backend=Backend.JAX,
                         lossy_duals=True)
    got = np.asarray(run_solver(orig, li, lm, opts)["recon"])
    want = _emulate(orig, li, lm, n, round_every=1)
    other = _emulate(orig, li, lm, n, round_every=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    assert float(np.max(np.abs(got - other))) > 1e-4


def test_lossy_drift_envelope_and_denoising():
    """End-to-end: the mode is really lossy (nonzero drift) but the
    drift stays bounded (~4e-3 rel-L2 on this small, noisy cube — drift
    is problem-dependent), and denoising still denoises."""
    shape = (16, 12, 10, 10)
    rng = np.random.default_rng(3)
    clean = np.zeros(shape, np.float32)
    clean[:, :, 5:] = 1.0
    noisy = (clean + rng.standard_normal(shape) * 0.25).astype(np.float32)
    li = jnp.asarray(np.full(4, 32.0, np.float32))
    lm = jnp.asarray(np.full(4, 1 / 32.0, np.float32))
    base = dict(ndim=4, iterations_fista=60, iterations_unacc=0,
                backend=Backend.JAX, calculate_mse=True)
    exact = run_solver(jnp.asarray(noisy), li, lm,
                       SolverOptions(**base),
                       reference_data=jnp.asarray(clean))
    lossy = run_solver(jnp.asarray(noisy), li, lm,
                       SolverOptions(**base, lossy_duals=True),
                       reference_data=jnp.asarray(clean))
    a = np.asarray(exact["recon"], np.float64)
    b = np.asarray(lossy["recon"], np.float64)
    drift = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert 1e-5 < drift < 1e-2
    mse = np.asarray(lossy["mse"])
    assert mse[-1] < mse[0] * 0.75  # ~35% MSE cut at this mild mu


def test_lossy_chunk_invariance_and_checkpoint_roundtrip(tmp_path):
    """The CLAUDE.md state invariant under lossy mode: an ODD chunk
    boundary must not change the state, since the rounding cadence is
    per-iteration. The mid-run state round-trips through an .npz
    checkpoint (bf16 ds stored as uint16 bit patterns — np.savez alone
    would return unusable '|V2' voids)."""
    orig, li, lm = _cube((8, 6, 64), seed=7)
    n = 9
    base = dict(ndim=3, iterations_fista=n, iterations_unacc=0,
                backend=Backend.JAX, lossy_duals=True)
    straight = run_solver(orig, li, lm, SolverOptions(**base))

    part = run_solver(orig, li, lm, SolverOptions(**base),
                      i_stop=5, keep_state=True)
    assert np.asarray(part["ds"][0]).dtype == jnp.bfloat16

    from cytvdn_tpu.utils.checkpoint import load_state, save_state

    ck = str(tmp_path / "lossy.ckpt")
    save_state(ck, part, {"ndim": 3})
    state, _meta = load_state(ck)
    assert state["ds"][0].dtype == jnp.bfloat16  # not raw void16
    resumed = run_solver(orig, li, lm, SolverOptions(**base), state=state)
    np.testing.assert_array_equal(np.asarray(resumed["recon"]),
                                  np.asarray(straight["recon"]))


def test_lossy_stop_aware_runs():
    """Stop-aware lossy runs stop at a sane iteration."""
    orig, li, lm = _cube((8, 6, 64), seed=5)
    opts = SolverOptions(ndim=3, iterations_fista=40, iterations_unacc=0,
                         backend=Backend.JAX, lossy_duals=True,
                         stopping_relative_change=3e-3)
    out = run_solver(orig, li, lm, opts)
    it = int(out["iterations_run"])
    assert 2 < it <= 40
    assert np.all(np.isfinite(np.asarray(out["recon"])))


def test_lossy_validation():
    with pytest.raises(ValueError, match="half-isotropic"):
        SolverOptions(ndim=4, iterations_fista=4, iterations_unacc=0,
                      isotropic_R=True, lossy_duals=True)
    with pytest.raises(ValueError, match="Jia-Zhao"):
        SolverOptions(ndim=3, iterations_fista=4, iterations_unacc=0,
                      bc_mode=BCMode.MIRROR, lossy_duals=True)
    # sharded lossy is supported (mesh ≡ single device; see the sharded
    # tests below) — no mesh_axes rejection
    SolverOptions(ndim=3, iterations_fista=4, iterations_unacc=0,
                  mesh_axes=(0,), lossy_duals=True)
    # f64 data rejected at run time
    orig = jnp.asarray(np.ones((4, 4, 8)), jnp.float32)
    li = jnp.asarray(np.full(3, 32.0, np.float32))
    lm = jnp.asarray(np.full(3, 1 / 32.0, np.float32))
    opts = SolverOptions(ndim=3, iterations_fista=2, iterations_unacc=0,
                         lossy_duals=True)
    x64_before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.raises(ValueError, match="float32"):
            run_solver(orig.astype(jnp.float64),
                       li.astype(jnp.float64), lm.astype(jnp.float64),
                       opts)
    finally:
        jax.config.update("jax_enable_x64", x64_before)


@pytest.mark.parametrize("shard,shape,iters", [
    ((4, 1, 1), (16, 6, 64), (6, 0)),       # axis-0 mesh
    ((4, 1, 1), (16, 6, 64), (5, 0)),       # odd iteration count
    ((1, 4, 1), (6, 12, 64), (4, 0)),       # axis-1 mesh
    ((2, 2, 1, 1), (8, 8, 6, 16), (4, 0)),  # 2D scan grid
    ((1, 1, 2, 2), (6, 6, 8, 8), (4, 0)),   # Q split
])
def test_sharded_lossy_matches_single_device(shard, shape, iters):
    """Lossy mesh ≡ lossy single device at the exact-mode seam tolerance
    (ulp-level: every shard rounds its own d on the same cadence)."""
    from cytvdn_tpu.parallel.sharded import run_sharded

    orig, li, lm = _cube(shape, seed=11)
    opts = SolverOptions(ndim=len(shape), iterations_fista=iters[0],
                         iterations_unacc=iters[1],
                         backend=Backend.JAX, lossy_duals=True)
    single = run_solver(orig, li, lm, opts)
    got = run_sharded(np.asarray(orig), np.asarray(li), np.asarray(lm),
                      opts, shard=shard, keep_state=True)
    # the sharded state really is bf16 (the traffic saving is real)
    assert np.asarray(got["ds"][0]).dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(got["recon"]),
                               np.asarray(single["recon"]),
                               rtol=5e-7, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got["b_norm"]),
                               np.asarray(single["b_norm"]), rtol=2e-5)
    # and it is really LOSSY sharded too: far from the exact run
    exact = run_solver(orig, li, lm,
                       SolverOptions(ndim=len(shape),
                                     iterations_fista=iters[0],
                                     iterations_unacc=iters[1],
                                     backend=Backend.JAX))
    if iters[0] >= 4:
        assert float(np.max(np.abs(np.asarray(got["recon"])
                                   - np.asarray(exact["recon"])))) > 1e-6


def test_sharded_lossy_k1_matches_single_device():
    """A 5-iteration axis-0 mesh run under lossy mode reproduces the
    single-device lossy run."""
    from cytvdn_tpu.parallel.sharded import run_sharded

    orig, li, lm = _cube((16, 6, 64), seed=13)
    opts = SolverOptions(ndim=3, iterations_fista=5, iterations_unacc=0,
                         backend=Backend.JAX, lossy_duals=True)
    single = run_solver(orig, li, lm, opts)
    got = run_sharded(np.asarray(orig), np.asarray(li), np.asarray(lm),
                      opts, shard=(4, 1, 1))
    np.testing.assert_allclose(np.asarray(got["recon"]),
                               np.asarray(single["recon"]),
                               rtol=5e-7, atol=1e-7)


def test_sharded_lossy_checkpoint_resume(tmp_path):
    """Sharded lossy chunked execution + checkpoint resume: the bf16
    shard blocks round-trip through the uint16 encoding (the
    ShardedBlocks branch) and the resumed run equals the straight one."""
    from cytvdn_tpu.parallel.sharded import run_sharded

    orig, li, lm = _cube((16, 6, 64), seed=17)
    opts = SolverOptions(ndim=3, iterations_fista=8, iterations_unacc=0,
                         backend=Backend.JAX, lossy_duals=True)
    straight = run_sharded(np.asarray(orig), np.asarray(li),
                           np.asarray(lm), opts, shard=(4, 1, 1))
    part = run_sharded(np.asarray(orig), np.asarray(li), np.asarray(lm),
                       opts, shard=(4, 1, 1), i_stop=5, keep_state=True)
    from cytvdn_tpu.utils.checkpoint import load_state, save_state

    ck = str(tmp_path / "lossy_sharded.ckpt")
    save_state(ck, part, {"ndim": 3})
    state, _ = load_state(ck)
    state = {k: v for k, v in state.items() if k != "early_stopped"}
    assert np.asarray(state["ds"][0]).dtype == jnp.bfloat16
    resumed = run_sharded(np.asarray(orig), np.asarray(li),
                          np.asarray(lm), opts, shard=(4, 1, 1),
                          state=state)
    np.testing.assert_array_equal(np.asarray(resumed["recon"]),
                                  np.asarray(straight["recon"]))


@pytest.mark.parametrize("temporal_k,shard_w", [(1, 1), (3, 1), (2, 2)])
def test_outofcore_lossy_matches_incore(temporal_k, shard_w):
    """Out-of-core lossy runs (streaming, temporal-blocked, and
    slab-sharded) equal the in-core lossy run — the same equivalence the
    exact mode carries, now with bf16 host-resident duals (half the d
    arrays' host RAM and transfer bytes)."""
    from cytvdn_tpu.solver.outofcore import denoise_outofcore

    shape = (12, 8, 64)
    rng = np.random.default_rng(23)
    cube = (rng.standard_normal(shape) * 0.4 + 1.0).astype(np.float32)
    mu = np.full(3, 1.0, np.float32)
    n = 6
    recon, _, _ = denoise_outofcore(
        cube, mu, iterations=n, FISTA=True, n_slabs=3,
        temporal_k=temporal_k, shard_w=shard_w, lossy_duals=True)
    li = jnp.asarray(16.0 / mu)
    lm = jnp.asarray((mu / 16.0) / mu)
    opts = SolverOptions(ndim=3, iterations_fista=n, iterations_unacc=0,
                         backend=Backend.JAX, lossy_duals=True)
    want = run_solver(jnp.asarray(cube), li, lm, opts)
    tol = dict(rtol=0, atol=0) if shard_w == 1 \
        else dict(rtol=5e-7, atol=1e-7)  # sharded seam-recompute ulps
    np.testing.assert_allclose(recon, np.asarray(want["recon"]), **tol)
    # the lossy OOC run drifts from the exact OOC run (really lossy)
    recon_exact, _, _ = denoise_outofcore(
        cube, mu, iterations=n, FISTA=True, n_slabs=3,
        temporal_k=temporal_k, shard_w=shard_w)
    assert float(np.max(np.abs(recon - recon_exact))) > 1e-6


def test_outofcore_lossy_checkpoint_resume(tmp_path, monkeypatch):
    """Out-of-core lossy checkpoint: bf16 host duals round-trip (uint16
    encoding) and a resumed run bit-matches the straight one; an exact
    resume of a lossy checkpoint is rejected loudly (cadence
    fingerprint)."""
    import cytvdn_tpu.solver.outofcore as O
    from cytvdn_tpu.solver.outofcore import denoise_outofcore

    shape = (12, 8, 64)
    rng = np.random.default_rng(29)
    cube = (rng.standard_normal(shape) * 0.4 + 1.0).astype(np.float32)
    mu = np.full(3, 1.0, np.float32)
    straight, _, _ = denoise_outofcore(
        cube, mu, iterations=6, FISTA=True, n_slabs=3, lossy_duals=True)

    ck = str(tmp_path / "ooc_lossy.ckpt")
    real = O._ckpt_save
    calls = []

    def killing(*a, **kw):
        real(*a, **kw)
        calls.append(1)
        if len(calls) == 1:
            raise KeyboardInterrupt  # kill right after the save lands

    monkeypatch.setattr(O, "_ckpt_save", killing)
    with pytest.raises(KeyboardInterrupt):
        denoise_outofcore(cube, mu, iterations=6, FISTA=True, n_slabs=3,
                          lossy_duals=True, checkpoint_path=ck,
                          checkpoint_every=3)
    monkeypatch.setattr(O, "_ckpt_save", real)
    resumed, _, _ = denoise_outofcore(
        cube, mu, iterations=6, FISTA=True, n_slabs=3, lossy_duals=True,
        checkpoint_path=ck, checkpoint_every=3, resume=True)
    np.testing.assert_array_equal(resumed, straight)
    # exact resume of a lossy checkpoint fails loudly
    with pytest.raises(ValueError, match="lossy"):
        denoise_outofcore(cube, mu, iterations=6, FISTA=True, n_slabs=3,
                          checkpoint_path=ck, checkpoint_every=3,
                          resume=True)


def test_lossy_api_surface():
    """denoise3D grows the lossy_duals kwarg and warns (non-quiet)."""
    import warnings

    import cytvdn_tpu as tv

    rng = np.random.default_rng(0)
    noisy = (rng.standard_normal((8, 8, 32)) * 0.2 + 1.0).astype(np.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        recon, b_norm, delta = tv.denoise3D(
            noisy, mu=np.full(3, 2.0, np.float32), iterations=6,
            FISTA=True, lossy_duals=True, quiet=False)
    assert any("lossy_duals" in str(x.message) for x in w)
    assert np.all(np.isfinite(recon))
