"""I/O round-trip tests (EMD v0.7 layout per reference mpi.py:449-491),
CLI end-to-end, and checkpoint/resume exactness."""

import json
import os

import h5py
import numpy as np
import pytest

from cytvdn_tpu.io.emd import read_emd, write_emd, write_emd_regions, emd_path
from cytvdn_tpu.io.loaders import load_input, open_input

RNG = np.random.default_rng(21)


def test_emd_roundtrip_and_layout(tmp_path):
    data = RNG.standard_normal((4, 5, 6, 7)).astype(np.float32)
    path = write_emd(str(tmp_path / "out.h5"), data)
    assert path.endswith(".emd")  # extension forced (reference mpi.py:447)
    back = read_emd(path)
    np.testing.assert_array_equal(back, data)
    # layout matches the reference writer (mpi.py:449-491)
    with h5py.File(path, "r") as f:
        top = f["4DSTEM_experiment"]
        assert top.attrs["emd_group_type"] == 2
        assert top.attrs["version_major"] == 0
        assert top.attrs["version_minor"] == 7
        for grp in ("metadata", "data/datacubes", "data/counted_datacubes",
                    "data/diffractionslices", "data/realslices",
                    "data/pointlists", "data/pointlistarrays"):
            assert grp in f["4DSTEM_experiment"].parent["4DSTEM_experiment"]
        dc = top["data/datacubes/datacube_0"]
        assert dc.attrs["emd_group_type"] == 1
        assert dc.attrs["metadata"] == -1
        assert dc["dim1"].attrs["name"] == b"R_x"
        assert dc["dim1"].attrs["units"] == b"[pix]"
        assert dc["dim4"].attrs["name"] == b"Q_y"
        np.testing.assert_array_equal(dc["dim2"][...], np.arange(5))


def test_emd_region_writes(tmp_path):
    data = RNG.standard_normal((8, 6, 4, 4)).astype(np.float32)
    regions = [
        ((slice(0, 4), slice(None), slice(None), slice(None)), data[:4]),
        ((slice(4, 8), slice(None), slice(None), slice(None)), data[4:]),
    ]
    path = write_emd_regions(str(tmp_path / "regions.emd"), data.shape,
                             data.dtype, regions)
    np.testing.assert_array_equal(read_emd(path), data)


def test_emd_raw_offset_row_writes(tmp_path):
    """The concurrent multihost writer's core trick single-process: an
    early-allocated contiguous datacube has a defined raw byte span
    before any HDF5 write, axis-0 row blocks are positioned-POSIX-
    written into it concurrently (no HDF5 writer lock), and the result
    is indistinguishable from the default writer — values AND the full
    group/attr/dtype surface (reference layout, mpi.py:449-491)."""
    from cytvdn_tpu.io import emd

    shape = (16, 8, 6, 10)
    full = RNG.standard_normal(shape).astype(np.float32)
    raw = str(tmp_path / "raw.emd")
    with h5py.File(raw, "w") as f:
        emd._create_structure(f, shape, np.float32, alloc_early=True)
    span = emd._raw_row_span(raw, shape, np.float32)
    assert span is not None
    off, row_bytes = span
    assert row_bytes == int(np.prod(shape[1:])) * 4
    # three uneven "processes" write their own rows (any order): the
    # page-aligned bulks land concurrently, the page-sharing boundary
    # fragments are returned for the serialized ring (NFS page-RMW safety)
    all_frags = []
    for g0, g1 in ((7, 16), (0, 3), (3, 7)):
        frags = emd._pwrite_rows(raw, off, row_bytes, full[g0:g1], g0,
                                 np.float32)
        # a process's fragments never exceed one leading + one trailing
        # partial page, and every fragment is smaller than a page
        assert len(frags) <= 2
        assert all(len(c) < emd._RAW_PAGE for _, c in frags)
        all_frags.append(frags)
    # the fragments from different processes may share a page — that is
    # exactly why they ring — but bulk spans are page-disjoint by
    # construction: each bulk starts/ends on a page boundary
    for frags in all_frags:
        emd._pwrite_frags(raw, frags)
    np.testing.assert_array_equal(read_emd(raw), full)

    ref = write_emd(str(tmp_path / "ref.emd"), full)

    def surface(path):
        out = []
        with h5py.File(path, "r") as f:
            f.visititems(lambda n, o: out.append(
                (n, type(o).__name__, getattr(o, "shape", None),
                 str(getattr(o, "dtype", "")),
                 sorted((k, str(v)) for k, v in o.attrs.items()))))
            out.append(("/", "File", None, "",
                        sorted((k, str(v)) for k, v in f.attrs.items())))
        return out

    assert surface(raw) == surface(ref)
    # the escape hatch: CYTV_NO_RAW_WRITES forces the HDF5 token ring
    os.environ["CYTV_NO_RAW_WRITES"] = "1"
    try:
        assert emd._raw_row_span(raw, shape, np.float32) is None
    finally:
        del os.environ["CYTV_NO_RAW_WRITES"]
    # non-native byte-order datasets refuse the raw path
    be = str(tmp_path / "be.emd")
    with h5py.File(be, "w") as f:
        emd._create_structure(f, shape, np.dtype(">f4"), alloc_early=True)
    assert emd._raw_row_span(be, shape, np.float32) is None


def test_loaders_npy_and_emd(tmp_path):
    data = RNG.standard_normal((6, 7, 8)).astype(np.float32)
    npy = str(tmp_path / "cube.npy")
    np.save(npy, data)
    np.testing.assert_array_equal(load_input(npy), data)
    with open_input(npy) as h:
        assert h.shape == (6, 7, 8)
        block = h.read_block((slice(1, 3), slice(None), slice(2, 5)))
        np.testing.assert_array_equal(block, data[1:3, :, 2:5])

    emd = write_emd(str(tmp_path / "cube4.emd"),
                    RNG.standard_normal((4, 4, 5, 5)).astype(np.float32))
    with open_input(emd) as h:
        assert h.shape == (4, 4, 5, 5)


def test_cli_end_to_end(tmp_path):
    from cytvdn_tpu.cli import main

    data = (RNG.standard_normal((6, 8, 16)) * 0.3 + 1.0).astype(np.float32)
    inp = str(tmp_path / "in.npy")
    np.save(inp, data)
    out = str(tmp_path / "out.emd")
    rc = main([
        "-i", inp, "-o", out, "-m", "1.0", "-n", "5", "-f", "1",
        "-v", "0",
    ])
    assert rc == 0
    recon = read_emd(out)
    assert recon.shape == data.shape
    assert np.all(np.isfinite(recon))
    assert not np.array_equal(recon, data)  # it actually denoised


def test_cli_sharded(tmp_path):
    from cytvdn_tpu.cli import main

    data = (RNG.standard_normal((8, 8, 16)) * 0.3 + 1.0).astype(np.float32)
    inp = str(tmp_path / "in.npy")
    np.save(inp, data)
    out = str(tmp_path / "out.emd")
    rc = main([
        "-i", inp, "-o", out, "-m", "1.0", "-n", "5", "-v", "0",
        "--shard", "2,4,1",
    ])
    assert rc == 0
    assert read_emd(out).shape == data.shape


def test_cli_outofcore_sharded_single_host(tmp_path):
    """`cytv --out-of-core N --shard W` on ONE host (the documented
    config-5 launch) must load the cube and
    run the slab-sharded solver — a review-caught regression left
    `data=None` via the lazy-open branch and crashed."""
    from cytvdn_tpu.cli import main

    data = (RNG.standard_normal((12, 8, 16)) * 0.3 + 1.0).astype(np.float32)
    inp = str(tmp_path / "in.npy")
    np.save(inp, data)
    out = str(tmp_path / "out.emd")
    rc = main([
        "-i", inp, "-o", out, "-m", "1.0", "-n", "4", "-f", "1",
        "-v", "0", "--out-of-core", "2", "--temporal", "2",
        "--shard", "2",
    ])
    assert rc == 0
    recon = read_emd(out)
    assert recon.shape == data.shape
    assert not np.array_equal(recon, data)


def test_cli_preset(tmp_path):
    """--preset fills iterations/FISTA/stop; explicit flags override."""
    from cytvdn_tpu.cli import _apply_preset, build_parser, main

    # flag resolution (no run): preset supplies, explicit wins
    a = build_parser().parse_args(
        ["-i", "x", "-o", "y", "-m", "1.0", "--preset", "stem4d-converged"])
    assert _apply_preset(a)
    assert a.niterations == [200] and a.fista and a.stop == 0.05
    a = build_parser().parse_args(
        ["-i", "x", "-o", "y", "-m", "1.0", "--preset", "stem4d-converged",
         "-n", "7", "-f", "0"])
    assert _apply_preset(a)
    assert a.niterations == [7] and a.fista is False and a.stop == 0.05
    a = build_parser().parse_args(["-i", "x", "-o", "y", "-m", "1.0"])
    assert not _apply_preset(a)  # no -n, no preset

    # end to end with a hybrid preset
    data = (RNG.standard_normal((6, 4, 4, 8)) * 0.3 + 1.0).astype(np.float32)
    inp = str(tmp_path / "in.npy")
    np.save(inp, data)
    out = str(tmp_path / "out.emd")
    rc = main(["-i", inp, "-o", out, "-m", "1.0", "-v", "0",
               "--preset", "stem4d-hybrid"])
    assert rc == 0
    assert read_emd(out).shape == data.shape

    # unknown preset: CLI error convention (print + rc 2), not a traceback
    rc = main(["-i", inp, "-o", out, "-m", "1.0", "--preset", "nope"])
    assert rc == 2


def test_cli_bad_dims(tmp_path, capsys):
    from cytvdn_tpu.cli import main

    data = np.ones((4, 4, 4), np.float32)
    inp = str(tmp_path / "in.npy")
    np.save(inp, data)
    rc = main(["-i", inp, "-o", str(tmp_path / "o.emd"), "-m", "1.0",
               "-n", "2", "-d", "4", "-v", "0"])
    assert rc == 2


class TestCheckpoint:
    def _run(self, tmp_path, **kw):
        from cytvdn_tpu.utils.checkpoint import run_with_checkpointing

        cube = (RNG.standard_normal((6, 7, 8)) * 0.5 + 2.0)
        mu = np.full(3, 0.8)
        uninterrupted = run_with_checkpointing(
            cube, mu, iterations=(5, 6), checkpoint_every=0,
            checkpoint_path="", **kw)
        ck = str(tmp_path / "state.ckpt.npz")
        chunked = run_with_checkpointing(
            cube, mu, iterations=(5, 6), checkpoint_every=3,
            checkpoint_path=ck, **kw)
        return cube, mu, uninterrupted, chunked, ck

    def test_chunked_matches_uninterrupted(self, tmp_path):
        cube, mu, a, b, ck = self._run(tmp_path)
        np.testing.assert_array_equal(a["recon"], b["recon"])
        np.testing.assert_array_equal(a["b_norm"], b["b_norm"])
        np.testing.assert_array_equal(a["delta"], b["delta"])
        assert os.path.exists(ck)

    def test_resume_from_partial_checkpoint(self, tmp_path):
        from cytvdn_tpu.utils.checkpoint import (
            load_state, run_with_checkpointing, save_state)

        cube = (RNG.standard_normal((6, 7, 8)) * 0.5 + 2.0)
        mu = np.full(3, 0.8)
        full = run_with_checkpointing(
            cube, mu, iterations=(5, 6), checkpoint_every=0,
            checkpoint_path="")
        ck = str(tmp_path / "partial.npz")
        # run only 4 iterations ("crash" mid-FISTA-phase), then resume
        run_with_checkpointing(
            cube, mu, iterations=(5, 6), checkpoint_every=4,
            checkpoint_path=ck, stopping_relative_change=None)
        state, meta = load_state(ck)
        # truncate the checkpoint back to the first chunk (i=4)
        assert meta["ndim"] == 3
        resumed = run_with_checkpointing(
            cube, mu, iterations=(5, 6), checkpoint_every=4,
            checkpoint_path=ck, resume=True)
        np.testing.assert_array_equal(full["recon"], resumed["recon"])
        np.testing.assert_array_equal(full["delta"], resumed["delta"])

    def test_resume_mid_phase_exact(self, tmp_path):
        """Kill after the first chunk file lands (i=4 < n_fista=5), resume,
        and require bit-identical results to the uninterrupted run."""
        from cytvdn_tpu.utils.checkpoint import run_chunked, load_state
        from cytvdn_tpu.config import SolverOptions

        cube = (RNG.standard_normal((6, 7, 8)) * 0.5 + 2.0)
        mu = np.full(3, 0.8)
        lam = mu / 16.0
        li, lm = 1.0 / lam, lam / mu
        opts = SolverOptions(ndim=3, iterations_fista=5, iterations_unacc=6)
        full = run_chunked(cube, li, lm, opts, "", 0)
        ck = str(tmp_path / "mid.npz")
        # first chunk only: i_stop=4 (mid-FISTA)
        run_chunked(cube, li, lm, opts, ck, 4, resume=False,
                    reference_data=None)
        state, _ = load_state(ck)
        assert int(state["i"]) == 11  # ran to completion in chunks of 4
        resumed = run_chunked(cube, li, lm, opts, ck, 4, resume=True)
        np.testing.assert_array_equal(full["recon"], resumed["recon"])

    def test_sharded_checkpoint_matches(self, tmp_path):
        from cytvdn_tpu.parallel.api import denoise_sharded

        cube = (RNG.standard_normal((8, 6, 8)) * 0.5 + 2.0)
        mu = np.full(3, 0.8)
        plain = denoise_sharded(cube, mu, iterations=(4, 4), shard=(2, 1, 2))
        ck = str(tmp_path / "shard.npz")
        chunked = denoise_sharded(cube, mu, iterations=(4, 4),
                                  shard=(2, 1, 2), checkpoint_path=ck,
                                  checkpoint_every=3)
        np.testing.assert_array_equal(plain["recon"], chunked["recon"])
        np.testing.assert_array_equal(plain["delta"], chunked["delta"])


def test_lazy_sharded_input_matches_in_memory(tmp_path):
    """denoise_sharded from a file path: each device's shard is read
    directly via block reads; result must match the in-memory run."""
    from cytvdn_tpu.parallel.api import denoise_sharded

    data = (RNG.standard_normal((8, 8, 4, 4)) * 0.3 + 1.0).astype(np.float32)
    path = write_emd(str(tmp_path / "lazy.emd"), data)
    mu = np.full(4, 1.0, np.float32)
    want = denoise_sharded(data, mu, iterations=4, shard=(2, 4, 1, 1))
    got = denoise_sharded(path, mu, iterations=4, shard=(2, 4, 1, 1))
    np.testing.assert_array_equal(got["recon"], want["recon"])


def test_load_sharded_array_blocks(tmp_path):
    import jax
    from cytvdn_tpu.parallel.multihost import load_sharded_array

    data = RNG.standard_normal((8, 6, 4)).astype(np.float32)
    path = write_emd(str(tmp_path / "cube.emd"), data)
    arr = load_sharded_array(path, (4, 1, 2), dtype=np.float32)
    assert arr.shape == data.shape
    np.testing.assert_array_equal(np.asarray(arr), data)
    assert len(arr.sharding.device_set) == 8


def test_emd_virtual_stitch(tmp_path):
    """Multihost writer machinery: per-process part files + virtual-dataset
    master, exercised single-host with two simulated processes."""
    from cytvdn_tpu.io.emd import (read_emd, stitch_emd_virtual,
                                   write_emd_part)

    data = RNG.standard_normal((8, 6, 4)).astype(np.float32)
    out = str(tmp_path / "multi.emd")
    full = (slice(None),) * 2
    write_emd_part(out, 0, [((slice(0, 4),) + full, data[:4])])
    write_emd_part(out, 1, [((slice(4, 8),) + full, data[4:])])
    path = stitch_emd_virtual(out, data.shape, data.dtype, 2)
    np.testing.assert_array_equal(read_emd(path), data)
    # layout still reference-compatible
    with h5py.File(path, "r") as f:
        assert f["4DSTEM_experiment"].attrs["version_minor"] == 7
        assert f["4DSTEM_experiment/data/datacubes/datacube_0/data"].is_virtual


def test_emd_solid_stitch(tmp_path):
    """Gather-small path: parts copied into ONE self-contained EMD file,
    sidecars removed — the reference's single-artifact output contract
    (mpi.py:444-498) without its MPI-IO dependency."""
    import os

    from cytvdn_tpu.io.emd import read_emd, stitch_emd_solid, write_emd_part

    data = RNG.standard_normal((8, 6, 4)).astype(np.float32)
    out = str(tmp_path / "solid.emd")
    full = (slice(None),) * 2
    write_emd_part(out, 0, [((slice(0, 4),) + full, data[:4])])
    write_emd_part(out, 1, [((slice(4, 8),) + full, data[4:])])
    path = stitch_emd_solid(out, data.shape, data.dtype, 2)
    np.testing.assert_array_equal(read_emd(path), data)
    with h5py.File(path, "r") as f:
        d = f["4DSTEM_experiment/data/datacubes/datacube_0/data"]
        assert not d.is_virtual  # self-contained
    # parts deleted; the master survives alone (movable artifact)
    assert not os.path.exists(out + ".part0.h5")
    assert not os.path.exists(out + ".part1.h5")


def test_dm_builtin_fallback(tmp_path):
    """Without ncempy/py4DSTEM the DM path falls through to the built-in
    tag-tree reader (cytvdn_tpu/io/dm.py) instead of failing — the
    reference's primary input format works out of the box. (Full DM
    coverage lives in tests/test_dm.py.)"""
    import pytest

    from cytvdn_tpu.io.dm import write_dm
    from cytvdn_tpu.io.loaders import open_input

    try:
        import ncempy  # noqa: F401
        pytest.skip("ncempy installed; fallback not reachable")
    except ImportError:
        pass
    data = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
    p = str(tmp_path / "x.dm4")
    write_dm(p, data)
    with open_input(p) as h:
        np.testing.assert_array_equal(h.read(), data)


def test_progress_callback_chunks():
    """Progress-enabled runs are bit-exact and report monotone iteration
    counts ending at the total."""
    import cytvdn_tpu as tv

    cube = RNG.standard_normal((6, 6, 32)).astype(np.float32) * 0.2 + 1.0
    mu = np.full(3, 2.0, np.float32)
    a = tv.denoise3D(cube, mu, iterations=60, quiet=True)
    seen = []
    from cytvdn_tpu.config import SolverOptions
    from cytvdn_tpu.utils.checkpoint import run_chunked

    lam = mu / 16.0
    opts = SolverOptions(ndim=3, iterations_fista=0, iterations_unacc=60)
    out = run_chunked(cube, (1.0 / lam).astype(np.float32),
                      (lam / mu).astype(np.float32), opts,
                      checkpoint_path=None, checkpoint_every=25,
                      progress=lambda d, t, dl: seen.append((d, t)))
    np.testing.assert_array_equal(out["recon"], a[0])
    assert seen == [(25, 60), (50, 60), (60, 60)]


def test_resume_after_convergence_is_idempotent(tmp_path):
    """Regression: resuming a run that already early-stopped must return
    the checkpointed result unchanged (the early-stop latch is persisted)."""
    from cytvdn_tpu.utils.checkpoint import run_with_checkpointing

    cube = (RNG.standard_normal((6, 7, 8)) * 0.5 + 2.0)
    mu = np.full(3, 0.8)
    ck = str(tmp_path / "conv.npz")
    kw = dict(iterations=100, FISTA=False, stopping_relative_change=0.2,
              checkpoint_path=ck, checkpoint_every=5)
    first = run_with_checkpointing(cube, mu, **kw)
    assert first["iterations_run"] < 100
    again = run_with_checkpointing(cube, mu, resume=True, **kw)
    np.testing.assert_array_equal(first["recon"], again["recon"])
    np.testing.assert_array_equal(first["delta"], again["delta"])


import os as _os
import pytest as _pytest


@_pytest.mark.skipif(
    not _os.environ.get("CYTV_FULL_TESTS"),
    reason="set CYTV_FULL_TESTS=1 to build and compare against the actual "
           "reference binary (~2 min; committed results in "
           "REFERENCE_PARITY.json)",
)
def test_real_reference_parity():
    import subprocess, sys
    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, _os.path.join(repo, "tools", "reference_parity.py")],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]


def test_write_emd_sharded(tmp_path):
    """Region-writing a sharded device array without a host gather."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from cytvdn_tpu.io.emd import write_emd_sharded
    from cytvdn_tpu.parallel.sharded import make_mesh

    mesh, names = make_mesh((2, 4, 1))
    data = (RNG.standard_normal((8, 8, 6)) * 0.5 + 2.0).astype(np.float32)
    arr = jax.device_put(
        jnp.asarray(data), NamedSharding(mesh, P("ax0", "ax1", None))
    )
    path = write_emd_sharded(str(tmp_path / "sharded.emd"), arr)
    np.testing.assert_array_equal(read_emd(path), data)
