"""Out-of-core solver: slab-streamed runs must equal the in-core fused
run exactly (same arithmetic via operand halos)."""

import numpy as np
import pytest

from cytvdn_tpu import denoise3D, denoise4D
from cytvdn_tpu.solver.outofcore import denoise_outofcore, _slab_bounds

RNG = np.random.default_rng(17)


def _cube(shape):
    return (RNG.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)


def test_slab_bounds_uneven():
    assert _slab_bounds(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert _slab_bounds(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    # balanced: no undersized tail slab (a ceil split would give 3,3,3,1)
    assert _slab_bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]


@pytest.mark.parametrize("n_slabs", [2, 3])
@pytest.mark.parametrize("fista", [True, False])
def test_outofcore_matches_incore_4d(n_slabs, fista):
    cube = _cube((10, 6, 8, 16))
    mu = np.full(4, 1.0, np.float32)
    want = denoise4D(cube, mu, iterations=5, FISTA=fista, quiet=True,
                     backend="jax")
    got = denoise_outofcore(cube, mu, iterations=5, FISTA=fista,
                            n_slabs=n_slabs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6)


def test_outofcore_matches_incore_3d_early_stop():
    cube = _cube((12, 8, 16))
    mu = np.full(3, 1.0, np.float32)
    kw = dict(iterations=60, FISTA=False, stopping_relative_change=0.05,
              quiet=True)
    want = denoise3D(cube, mu, backend="jax", **kw)
    got = denoise_outofcore(cube, mu, iterations=60, FISTA=False,
                            stopping_relative_change=0.05, n_slabs=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("fista", [True, False])
def test_outofcore_mse_matches_incore(fista):
    """Per-iteration MSE in the streaming out-of-core mode must match
    the in-core trace (host float64-chunk accumulation vs the engine's
    on-device float32 sums — trace tolerance)."""
    cube = _cube((10, 6, 8, 16))
    ref = _cube((10, 6, 8, 16))
    mu = np.full(4, 1.0, np.float32)
    want = denoise4D(cube, mu, iterations=5, FISTA=fista, quiet=True,
                     backend="jax", reference_data=ref)
    got = denoise_outofcore(cube, mu, iterations=5, FISTA=fista,
                            n_slabs=3, reference_data=ref)
    assert len(got) == 4
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-6, atol=2e-6)


def test_outofcore_mse_temporal_sweep_final():
    """Temporal blocking records SSE at sweep-final iterations only
    (zeros between), matching the in-core per-iteration trace at those
    indices — the same cadence as the b_norm/delta traces."""
    cube = _cube((12, 8, 16))
    ref = _cube((12, 8, 16))
    mu = np.full(3, 1.0, np.float32)
    want = denoise3D(cube, mu, iterations=6, FISTA=False, quiet=True,
                     backend="jax", reference_data=ref)
    got = denoise_outofcore(cube, mu, iterations=6, FISTA=False,
                            n_slabs=2, temporal_k=3, reference_data=ref)
    assert len(got) == 4
    np.testing.assert_allclose(got[3][0], want[3][0], rtol=1e-5)
    for i in (3, 6):  # sweep-final indices
        np.testing.assert_allclose(got[3][i], want[3][i], rtol=1e-5)
    assert got[3][1] == 0.0 and got[3][2] == 0.0  # between sweeps
    np.testing.assert_allclose(got[0], want[0], rtol=2e-6, atol=2e-6)


def test_outofcore_mse_sharded_temporal():
    """The sharded out-of-core mode's sweep-final MSE matches the
    in-core trace at sweep boundaries."""
    cube = _cube((12, 8, 16))
    ref = _cube((12, 8, 16))
    mu = np.full(3, 1.0, np.float32)
    want = denoise3D(cube, mu, iterations=4, FISTA=True, quiet=True,
                     backend="jax", reference_data=ref)
    got = denoise_outofcore(cube, mu, iterations=4, FISTA=True,
                            n_slabs=2, temporal_k=2, shard_w=2,
                            reference_data=ref)
    assert len(got) == 4
    for i in (0, 2, 4):
        np.testing.assert_allclose(got[3][i], want[3][i], rtol=1e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-6, atol=2e-6)


class TestOutOfCoreCheckpoint:
    """Failure recovery for the longest-running execution mode: atomic
    full-state saves + bit-exact resume (reference has none, SURVEY §5)."""

    def _kill_after_first_save(self, monkeypatch):
        import cytvdn_tpu.solver.outofcore as O

        real = O._ckpt_save
        calls = []

        def killing(*a, **kw):
            real(*a, **kw)
            calls.append(1)
            if len(calls) == 1:
                raise KeyboardInterrupt  # kill right after the save lands

        monkeypatch.setattr(O, "_ckpt_save", killing)
        return lambda: monkeypatch.setattr(O, "_ckpt_save", real)

    def test_stream_kill_resume_bitexact(self, tmp_path, monkeypatch):
        cube = _cube((10, 6, 8, 16))
        mu = np.full(4, 1.0, np.float32)
        want = denoise_outofcore(cube, mu, iterations=(4, 3), n_slabs=2)
        ck = str(tmp_path / "ooc.npz")
        restore = self._kill_after_first_save(monkeypatch)
        with pytest.raises(KeyboardInterrupt):
            denoise_outofcore(cube, mu, iterations=(4, 3), n_slabs=2,
                              checkpoint_path=ck, checkpoint_every=2)
        restore()
        got = denoise_outofcore(cube, mu, iterations=(4, 3), n_slabs=2,
                                checkpoint_path=ck, checkpoint_every=2,
                                resume=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_temporal_kill_resume_bitexact(self, tmp_path, monkeypatch):
        cube = _cube((12, 8, 16))
        mu = np.full(3, 1.0, np.float32)
        want = denoise_outofcore(cube, mu, iterations=8, FISTA=False,
                                 n_slabs=2, temporal_k=2)
        ck = str(tmp_path / "ooct.npz")
        restore = self._kill_after_first_save(monkeypatch)
        with pytest.raises(KeyboardInterrupt):
            denoise_outofcore(cube, mu, iterations=8, FISTA=False,
                              n_slabs=2, temporal_k=2,
                              checkpoint_path=ck, checkpoint_every=2)
        restore()
        got = denoise_outofcore(cube, mu, iterations=8, FISTA=False,
                                n_slabs=2, temporal_k=2,
                                checkpoint_path=ck, checkpoint_every=2,
                                resume=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_sharded_temporal_checkpointed_matches(self, tmp_path):
        cube = _cube((12, 8, 16))
        mu = np.full(3, 1.0, np.float32)
        want = denoise_outofcore(cube, mu, iterations=(4, 2), n_slabs=2,
                                 temporal_k=2, shard_w=2)
        ck = str(tmp_path / "oocs.npz")
        got = denoise_outofcore(cube, mu, iterations=(4, 2), n_slabs=2,
                                temporal_k=2, shard_w=2,
                                checkpoint_path=ck, checkpoint_every=2)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6)
        # resuming a completed run is an idempotent no-op
        again = denoise_outofcore(cube, mu, iterations=(4, 2), n_slabs=2,
                                  temporal_k=2, shard_w=2,
                                  checkpoint_path=ck, checkpoint_every=2,
                                  resume=True)
        for g, a in zip(got, again):
            np.testing.assert_array_equal(g, a)

    def test_temporal_hybrid_kill_in_phase2_resume(self, tmp_path,
                                                   monkeypatch):
        """Kill after a PHASE-2 checkpoint save: the resume mapping must
        land in the unaccelerated phase at the right absolute position
        (the review-caught phase-mapping bug: a cumulative iteration
        counter would replay FISTA sweeps onto unaccelerated state)."""
        import cytvdn_tpu.solver.outofcore as O

        cube = _cube((12, 8, 16))
        mu = np.full(3, 1.0, np.float32)
        want = denoise_outofcore(cube, mu, iterations=(4, 4), n_slabs=2,
                                 temporal_k=2)
        ck = str(tmp_path / "ooch2.npz")
        real = O._ckpt_save
        calls = []

        def killing(*a, **kw):
            real(*a, **kw)
            calls.append(a[2])  # it_run
            if len(calls) == 2:  # second save: it_run=6, inside phase 2
                raise KeyboardInterrupt

        monkeypatch.setattr(O, "_ckpt_save", killing)
        with pytest.raises(KeyboardInterrupt):
            denoise_outofcore(cube, mu, iterations=(4, 4), n_slabs=2,
                              temporal_k=2, checkpoint_path=ck,
                              checkpoint_every=3)
        assert calls == [4, 6], calls  # 2nd save: abs iter 6 = phase 2
        monkeypatch.setattr(O, "_ckpt_save", real)
        got = denoise_outofcore(cube, mu, iterations=(4, 4), n_slabs=2,
                                temporal_k=2, checkpoint_path=ck,
                                checkpoint_every=3, resume=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_temporal_phase2_trace_slots_absolute(self):
        """A phase-1 early stop must not shift the unaccelerated phase's
        trace slots: phase 2 records at absolute indices n_f + j
        (reference cyTVDN.py:205) and runs exactly n_u iterations."""
        from cytvdn_tpu.config import SolverOptions
        from cytvdn_tpu.solver.outofcore import solve_outofcore_temporal

        cube = _cube((12, 8, 16))
        li = np.full(3, 16.0, np.float32)
        lm = np.full(3, 1 / 16.0, np.float32)
        probe = solve_outofcore_temporal(
            cube, li, lm,
            SolverOptions(ndim=3, iterations_fista=4, iterations_unacc=4),
            2, 2)
        stop_at = float(probe["delta"][1]) * 1.01  # first sweep crosses
        out = solve_outofcore_temporal(
            cube, li, lm,
            SolverOptions(ndim=3, iterations_fista=4, iterations_unacc=4,
                          stopping_relative_change=stop_at),
            2, 2)
        d = np.asarray(out["delta"])
        assert d[1] > 0 and d[1] < stop_at          # phase-1 sweep 1
        assert d[2] == 0 and d[3] == 0              # phase-1 tail skipped
        # phase 2 records at ABSOLUTE slot n_f + j (not cumulative);
        # its first sweep's delta also crosses the threshold, so it
        # stops there — the stop check applies in the unaccelerated
        # loop too (reference cyTVDN.py:235-241)
        assert d[4] == 0 and d[5] > 0
        assert int(out["iterations_run"]) == 6
        assert bool(out["early_stopped"])

    def test_schedule_mismatch_rejected(self, tmp_path):
        cube = _cube((10, 6, 16))
        mu = np.full(3, 1.0, np.float32)
        ck = str(tmp_path / "oocm.npz")
        denoise_outofcore(cube, mu, iterations=4, FISTA=False, n_slabs=2,
                          checkpoint_path=ck, checkpoint_every=2)
        with pytest.raises(ValueError, match="does not match"):
            denoise_outofcore(cube, mu, iterations=6, FISTA=False,
                              n_slabs=2, checkpoint_path=ck,
                              checkpoint_every=2, resume=True)

    def test_mse_survives_resume(self, tmp_path, monkeypatch):
        cube = _cube((10, 6, 16))
        ref = _cube((10, 6, 16))
        mu = np.full(3, 1.0, np.float32)
        want = denoise_outofcore(cube, mu, iterations=6, FISTA=False,
                                 n_slabs=2, reference_data=ref)
        ck = str(tmp_path / "oocmse.npz")
        restore = self._kill_after_first_save(monkeypatch)
        with pytest.raises(KeyboardInterrupt):
            denoise_outofcore(cube, mu, iterations=6, FISTA=False,
                              n_slabs=2, reference_data=ref,
                              checkpoint_path=ck, checkpoint_every=2)
        restore()
        got = denoise_outofcore(cube, mu, iterations=6, FISTA=False,
                                n_slabs=2, reference_data=ref,
                                checkpoint_path=ck, checkpoint_every=2,
                                resume=True)
        assert len(got) == 4
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[0], want[0])


def test_multihost_single_process_degenerates():
    """solve_outofcore_multihost with one process owning the whole range
    must equal solve_outofcore_sharded_temporal bit-for-bit (no ghosts,
    exchange is a no-op). The true 2-process path is covered by
    tests/test_multiproc.py + tools/multiproc_outofcore.py."""
    from cytvdn_tpu.config import SolverOptions
    from cytvdn_tpu.solver.outofcore import (
        solve_outofcore_multihost, solve_outofcore_sharded_temporal)

    cube = _cube((12, 8, 32))
    li = np.full(3, 16.0, np.float32)
    lm = np.full(3, 1 / 16.0, np.float32)
    opts = SolverOptions(ndim=3, iterations_fista=4, iterations_unacc=2)
    want = solve_outofcore_sharded_temporal(cube, li, lm, opts, 2, 2,
                                            shard_w=2)
    got = solve_outofcore_multihost(cube, li, lm, opts, 2, 2,
                                    global_rows=(0, 12, 12), shard_w=2)
    np.testing.assert_array_equal(got["recon"], want["recon"])
    np.testing.assert_allclose(got["b_norm"], want["b_norm"], rtol=1e-6)
    np.testing.assert_allclose(got["delta"], want["delta"], rtol=1e-6,
                               atol=1e-9)


def test_multihost_bad_row_ranges_rejected():
    from cytvdn_tpu.config import SolverOptions
    from cytvdn_tpu.solver.outofcore import solve_outofcore_multihost

    cube = _cube((12, 8, 32))
    li = np.full(3, 16.0, np.float32)
    lm = np.full(3, 1 / 16.0, np.float32)
    opts = SolverOptions(ndim=3, iterations_fista=2, iterations_unacc=0)
    with pytest.raises(ValueError, match="do not cover"):
        solve_outofcore_multihost(cube, li, lm, opts, 2, 2,
                                  global_rows=(0, 12, 16), shard_w=2)
    with pytest.raises(ValueError, match="rows"):
        solve_outofcore_multihost(cube, li, lm, opts, 2, 2,
                                  global_rows=(0, 10, 12), shard_w=2)


def test_outofcore_rejects_unsupported():
    cube = _cube((8, 6, 8))
    with pytest.raises(ValueError):
        denoise_outofcore(cube, np.full(3, 1.0, np.float32), n_slabs=8)


@pytest.mark.parametrize("n_slabs,k", [(2, 2), (3, 3), (2, 5)])
@pytest.mark.parametrize("fista", [True, False])
def test_temporal_blocking_matches_incore(n_slabs, k, fista):
    """K iterations per slab residency: core results must equal the
    in-core run (margin contamination fully absorbed), and traces carry
    true values at sweep-final iterations."""
    cube = _cube((10, 6, 8, 16))
    mu = np.full(4, 1.0, np.float32)
    n_it = 7  # not a multiple of k: exercises the short trailing sweep
    want = denoise4D(cube, mu, iterations=n_it, FISTA=fista, quiet=True,
                     backend="jax")
    got = denoise_outofcore(cube, mu, iterations=n_it, FISTA=fista,
                            n_slabs=n_slabs, temporal_k=k)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-6, atol=2e-6)
    # sweep-final trace entries match the in-core per-iteration traces
    idx = sorted({min(i + k, n_it) - 1 for i in range(0, n_it, k)})
    np.testing.assert_allclose(got[1][idx], want[1][idx], rtol=2e-4)
    np.testing.assert_allclose(got[2][idx], want[2][idx], rtol=2e-4,
                               atol=1e-7)
    # intermediate entries are zeros by contract
    others = [i for i in range(n_it) if i not in idx]
    assert np.all(got[1][others] == 0)


def test_temporal_blocking_hybrid_schedule():
    """Sweeps must not cross the FISTA->unaccelerated phase boundary."""
    cube = _cube((9, 6, 8, 16))
    mu = np.full(4, 1.0, np.float32)
    want = denoise4D(cube, mu, iterations=(5, 4), quiet=True,
                     backend="jax")
    got = denoise_outofcore(cube, mu, iterations=(5, 4), n_slabs=2,
                            temporal_k=3)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("n_slabs,k,w", [(2, 3, 4), (3, 2, 2)])
@pytest.mark.parametrize("iters", [7, (5, 4)])
def test_sharded_outofcore_matches_incore(n_slabs, k, w, iters):
    """Out-of-core with each slab SHARDED over the local devices (the
    BASELINE config-5 deployment shape): core results must equal the
    in-core single-device run to sharded-seam ulps."""
    from cytvdn_tpu.config import SolverOptions, normalize_iterations
    from cytvdn_tpu.solver.outofcore import solve_outofcore_sharded_temporal

    cube = _cube((10, 8, 8, 16))
    mu = np.full(4, 1.0, np.float32)
    lam = mu / 32.0
    want = denoise4D(cube, mu, iterations=iters, quiet=True,
                     backend="jax")
    n_f, n_u = normalize_iterations(iters, True)
    opts = SolverOptions(ndim=4, iterations_fista=n_f,
                         iterations_unacc=n_u)
    out = solve_outofcore_sharded_temporal(
        cube, (1.0 / lam), (lam / mu), opts, n_slabs, k, shard_w=w)
    np.testing.assert_allclose(out["recon"], want[0], rtol=2e-6,
                               atol=2e-6)
    n_it = n_f + n_u
    idx = sorted({min(i + k, min(n_f or n_it, n_it)) - 1
                  for i in range(0, n_f, k)}
                 | {min(i + k, n_it) - 1 for i in range(n_f, n_it, k)})
    np.testing.assert_allclose(out["b_norm"][idx], want[1][idx],
                               rtol=2e-4)


def test_sharded_outofcore_early_stop():
    from cytvdn_tpu.config import SolverOptions
    from cytvdn_tpu.solver.outofcore import solve_outofcore_sharded_temporal

    cube = _cube((8, 8, 64))
    mu = np.full(3, 1.0, np.float32)
    lam = mu / 16.0
    opts = SolverOptions(ndim=3, iterations_fista=0, iterations_unacc=40,
                         stopping_relative_change=0.02)
    out = solve_outofcore_sharded_temporal(
        cube, (1.0 / lam), (lam / mu), opts, 2, 4, shard_w=4)
    assert bool(out["early_stopped"])
    assert int(out["iterations_run"]) % 4 == 0  # sweep granularity
    assert int(out["iterations_run"]) < 40


@pytest.mark.parametrize("seed", range(4))
def test_sharded_outofcore_fuzz(seed):
    """Randomized geometry sweep of the sharded out-of-core path: slab
    counts x K x mesh width x schedule, 3D and 4D, vs the in-core run."""
    from cytvdn_tpu.config import SolverOptions
    from cytvdn_tpu.solver.outofcore import solve_outofcore_sharded_temporal

    rng = np.random.default_rng(7000 + seed)
    ndim = int(rng.choice([3, 4]))
    n_slabs = int(rng.integers(2, 4))
    k = int(rng.integers(2, 5))
    w = int(rng.choice([2, 4]))
    # slabs must hold at least K core rows; axis 1 must tile the mesh
    ax0 = n_slabs * (k + int(rng.integers(1, 3)))
    ax1 = w * int(rng.integers(1, 3))
    if ndim == 4:
        shape = (ax0, ax1, int(rng.integers(2, 5)),
                 int(rng.integers(8, 17)))
    else:
        shape = (ax0, ax1, int(rng.integers(16, 65)))
    n_f = int(rng.integers(0, 6))
    n_u = int(rng.integers(0, 5))
    if n_f + n_u == 0:
        n_u = 3
    cube = _cube(shape)
    mu = np.full(ndim, 1.0, np.float32)
    lam = mu / (32.0 if ndim == 4 else 16.0)
    denoise = denoise4D if ndim == 4 else denoise3D
    want = denoise(cube, mu, iterations=(n_f, n_u), FISTA=n_f > 0,
                   quiet=True, backend="jax")
    opts = SolverOptions(ndim=ndim, iterations_fista=n_f,
                         iterations_unacc=n_u)
    out = solve_outofcore_sharded_temporal(
        cube, (1.0 / lam), (lam / mu), opts, n_slabs, k, shard_w=w)
    np.testing.assert_allclose(
        out["recon"], want[0], rtol=2e-6, atol=2e-6,
        err_msg=f"{shape} slabs={n_slabs} k={k} w={w} it=({n_f},{n_u})")


def test_temporal_k_exceeding_core_rejected():
    cube = _cube((8, 6, 8, 16))
    with pytest.raises(ValueError, match="temporal_k"):
        denoise_outofcore(cube, np.full(4, 1.0, np.float32), iterations=4,
                          n_slabs=4, temporal_k=5)
