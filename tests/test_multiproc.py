"""True multi-process distributed tests: N real processes joined by
jax.distributed over localhost (gloo collectives) — the same code path a
multi-host GPU cluster takes, minus the hardware.

These spawn subprocesses via tools/multiproc_e2e.py; the in-process mesh
tests (tests/test_sharded.py) cover the numerics, these cover the
process-boundary plumbing: runtime bring-up through the CLI, per-process
lazy input reads, cross-process halos/psum, per-process checkpoint parts
with kill-and-resume, and the stitched single-file EMD output.

The reference's analog is its runnable MPI smoke test
(reference local_MPI_example.sh:11-20) — which exercises none of the
above beyond the solve itself (no metrics, no resume, README.md:34).
"""

import json
import os
import subprocess
import sys

import pytest

TOOL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "tools", "multiproc_e2e.py")


def _run(extra, port_seed):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, TOOL, "--port", str(port_seed)] + extra,
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("{")][-1]
    return json.loads(line)


@pytest.mark.slow
def test_two_process_e2e_bit_identical():
    out = _run([], 21000 + os.getpid() % 9000)
    assert out["multiproc_e2e"] == "ok"
    assert out["max_abs_err_vs_single_process"] == 0.0
    assert out["leftover_part_files"] == []


@pytest.mark.slow
def test_two_process_checkpoint_kill_resume():
    out = _run(["--checkpoint"], 22000 + os.getpid() % 9000)
    assert out["multiproc_e2e"] == "ok"
    assert out["max_abs_err_vs_single_process"] == 0.0
    assert out["checkpoint_cycle"] is True


@pytest.mark.slow
def test_two_process_temporal_pairs_axis0_mesh():
    """Halos ppermute across a real process boundary: an axis-0 mesh
    spanning both processes puts a shard seam between them."""
    out = _run(["--axis0"], 23000 + os.getpid() % 9000)
    assert out["multiproc_e2e"] == "ok"
    assert out["rel_err"] < 1e-6
    assert out["shard"] == "8,1,1,1"


OOC_TOOL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "tools", "multiproc_outofcore.py")


def _run_ooc(extra, port_seed):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, OOC_TOOL, "--port", str(port_seed)] + extra,
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("{")][-1]
    return json.loads(line)


@pytest.mark.slow
def test_multihost_outofcore_bit_identical():
    """Two processes each stream their own axis-0 row range of the
    host-resident state (solve_outofcore_multihost): stitched recon must
    equal the single-process IN-CORE run bit-for-bit (pre-sweep boundary
    band exchange + K-row margins are exact)."""
    out = _run_ooc([], 25000 + os.getpid() % 9000)
    assert out["multiproc_outofcore_e2e"] == "ok"
    assert out["recon_rel_err_vs_incore"] == 0.0


@pytest.mark.slow
def test_multihost_outofcore_cli():
    """`cytv --out-of-core` across two real processes: lazy per-host row
    reads from the EMD, the multihost solver, and CONCURRENT per-process
    row writes into one shared-FS EMD output (the reference's MPI-IO
    analog, mpi.py:444-498) — all through the console entry."""
    out = _run_ooc(["--cli"], 27000 + os.getpid() % 9000)
    assert out["multiproc_outofcore_cli_e2e"] == "ok"
    assert out["recon_rel_err_vs_incore"] == 0.0
    assert out["output_path_mode"] == "concurrent_row_writes"


@pytest.mark.slow
def test_multihost_outofcore_cli_gather_fallback():
    """CYTV_NO_SHARED_FS forces the no-shared-filesystem fallback: rows
    stream to process 0 in slab chunks and it writes the one EMD file.
    Same bytes on disk as the concurrent path."""
    out = _run_ooc(["--cli", "--no-shared-fs"],
                   30000 + os.getpid() % 9000)
    assert out["multiproc_outofcore_cli_e2e"] == "ok"
    assert out["recon_rel_err_vs_incore"] == 0.0
    assert out["output_path_mode"] == "proc0_gather"


@pytest.mark.slow
def test_multihost_outofcore_kill_resume():
    """Every process killed (os._exit) right after the first checkpoint
    generation lands; the resume pass must reproduce the uninterrupted
    in-core result bit-for-bit."""
    out = _run_ooc(["--checkpoint"], 26000 + os.getpid() % 9000)
    assert out["multiproc_outofcore_e2e"] == "ok"
    assert out["recon_rel_err_vs_incore"] == 0.0
    assert out["killed_after_first_generation"] is True


@pytest.mark.slow
def test_multihost_outofcore_three_process_interior():
    """nproc=3 exercises the INTERIOR process branch of the band
    exchange (both ``got`` neighbors applied in one refresh) with
    uneven row ranges (17 rows over 3 processes), full-sweep parity
    vs the single-process in-core run."""
    out = _run_ooc(["--nproc", "3"], 28000 + os.getpid() % 9000)
    assert out["multiproc_outofcore_e2e"] == "ok"
    assert out["nproc"] == 3
    assert out["recon_rel_err_vs_incore"] == 0.0


@pytest.mark.slow
def test_multihost_outofcore_interior_kill_resume():
    """The INTERIOR process (pid 1 of 3) crashes (os._exit) right after
    the first checkpoint generation; the other ranks are torn down at
    the same generation (what a launcher does on a rank loss). The
    resume pass — with the interior's both-neighbor band refresh live —
    must reproduce the uninterrupted in-core result bit-for-bit."""
    out = _run_ooc(["--nproc", "3", "--checkpoint", "--die-pid", "1"],
                   29000 + os.getpid() % 9000)
    assert out["multiproc_outofcore_e2e"] == "ok"
    assert out["recon_rel_err_vs_incore"] == 0.0
    assert out["killed_after_first_generation"] is True
    assert out["interior_kill"] is True
