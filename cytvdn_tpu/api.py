"""Public driver API — signature- and semantics-compatible with the
reference's ``denoise3D`` / ``denoise4D``
(reference cyTVDN/cyTVDN.py:19-247, 250-435).

numpy in, numpy out; device placement, jit and (optionally) mesh sharding
happen inside. Deviations from the reference, all documented:

- C-contiguity is not required (XLA handles layout; the reference asserts it
  at cyTVDN.py:73-75 because Cython memoryviews need it).
- float64 requires ``jax.config.update("jax_enable_x64", True)``; a clear
  error is raised otherwise.
- The 3D parameter assert message correctly states the 1/16 bound (the
  reference checks 1/16 but prints "1/8", cyTVDN.py:306-308).
- Memory estimates are honest total-live-array counts (the reference's
  driver prints and ``check_memory`` disagree with each other,
  cyTVDN.py:113,456 — see SURVEY.md §2.7).
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from cytvdn_tpu.config import Backend, BCMode, SolverOptions, normalize_iterations
from cytvdn_tpu.solver.engine import run_solver

__all__ = ["denoise3D", "denoise4D", "denoise"]


@functools.partial(jax.jit, static_argnames=("opts",))
def _run_jit(orig, lambda_inv, lam_mu, opts: SolverOptions, reference_data):
    return run_solver(orig, lambda_inv, lam_mu, opts, reference_data)


def _run(datacube, lambda_inv, lam_mu, opts: SolverOptions, reference_data,
         progress: bool = False):
    """Dispatch to the native CPU backend or the jitted device solver.

    ``progress`` routes the run through chunked execution so a live
    per-iteration bar can be shown (the reference's tqdm operator
    experience, cyTVDN.py:147-152, without a host sync per iteration).
    The reconstruction/accumulator state is bit-exact vs the unchunked
    run; the b_norm/delta traces can differ in the last ulp when a chunk
    boundary changes which kernel sums an iteration's reduction (the
    reference's own traces are order-nondeterministic OpenMP sums,
    SURVEY.md §2.1).
    """
    if opts.backend == Backend.CPP:
        from cytvdn_tpu.cpp.backend import solve_cpp

        return solve_cpp(datacube, lambda_inv, lam_mu, opts, reference_data)
    if progress:
        from cytvdn_tpu.utils.checkpoint import (
            progress_chunk_size,
            run_chunked,
        )
        from cytvdn_tpu.utils.log import make_progress

        n_total = opts.total_iterations
        cb = make_progress("TV denoising")
        try:
            return run_chunked(
                datacube, lambda_inv, lam_mu, opts,
                checkpoint_path=None,
                checkpoint_every=progress_chunk_size(n_total),
                reference_data=reference_data, progress=cb,
            )
        finally:
            cb.close()
    ref = jnp.asarray(reference_data) if opts.calculate_mse else None
    return _run_jit(jnp.asarray(datacube), jnp.asarray(lambda_inv),
                    jnp.asarray(lam_mu), opts, ref)


def _validate_and_derive(datacube, mu, lam, ndim, default_lam_div):
    """Shared parameter validation/derivation
    (reference cyTVDN/cyTVDN.py:62-78, 289-304)."""
    datacube = np.asarray(datacube)
    if datacube.ndim != ndim:
        raise ValueError(f"datacube must be {ndim}D, got shape {datacube.shape}")
    if datacube.dtype not in (np.float32, np.float64):
        raise TypeError("datacube must be float32 or float64.")
    if datacube.dtype == np.float64 and not jax.config.jax_enable_x64:
        raise TypeError(
            "float64 input requires jax.config.update('jax_enable_x64', True)"
        )
    mu = np.asarray(mu)
    if mu.ndim == 0:
        mu = np.full((ndim,), mu, dtype=datacube.dtype)
    if lam is None:
        # default regularization: lam = mu/32 in 4D, mu/16 in 3D
        # (reference cyTVDN.py:67-68, 294-295)
        lam = mu * (1.0 / default_lam_div)
    lam = np.asarray(lam)
    if lam.dtype != datacube.dtype:
        raise TypeError("Lambda must have same dtype as datacube.")
    if mu.dtype != datacube.dtype:
        raise TypeError("Mu must have same dtype as datacube.")
    lambda_inv = (1.0 / lam).astype(datacube.dtype)
    lam_mu = (lam / mu).astype(datacube.dtype)
    return datacube, mu, lam, lambda_inv, lam_mu


def _resolve_progress(progress: Optional[bool], quiet: bool,
                      opts: SolverOptions) -> bool:
    """Default: live progress for long, non-quiet device runs (matching
    the reference's always-on tqdm operator experience without taxing
    short jitted runs). Chunked execution pays one host dispatch per
    chunk, so short runs stay single-shot."""
    if opts.backend == Backend.CPP:
        return False  # the cpp host loop reports through its own prints
    if progress is not None:
        return bool(progress)
    return not quiet and opts.total_iterations >= 500


def _bc_note(bc_mode: int) -> None:
    """Surface the deliberate mirror-BC deviation at the API level.

    The reference's mirror branch is buggy (max-vs-min clamp,
    reference cyTVDN/utils.pyx:117-120, and two more defects in 3D at
    utils.pyx:192-197); this framework implements mirror *correctly*, so
    BC_mode=1 outputs intentionally differ from the reference bit-for-bit.
    Users migrating parity-dependent pipelines should know.
    """
    if BCMode(bc_mode) == BCMode.MIRROR:
        warnings.warn(
            "BC_mode=1 (mirror) is implemented correctly here; the "
            "reference's mirror branch is defective (cyTVDN utils.pyx:"
            "117-120,192-197), so results deliberately differ from the "
            "reference in this mode.",
            stacklevel=3,
        )


def _memory_note(datacube, fista, ndim, quiet):
    if quiet:
        return
    n_arrays = 2 + (2 * ndim if fista else ndim)  # orig+recon+accs(+ds)
    gib = datacube.nbytes * n_arrays / 2**30
    label = "FISTA accelerated" if fista else "Unaccelerated"
    print(
        f"{label} TV denoising holds {n_arrays} cube-size arrays "
        f"≈ {gib:.2f} GiB of device memory"
    )


def _finish(result, calculate_mse):
    """Device→host transfer and the reference's return contract
    (reference cyTVDN.py:244-247)."""
    recon = np.asarray(result["recon"])
    b_norm = np.asarray(result["b_norm"])
    delta = np.asarray(result["delta"])
    if calculate_mse:
        return recon, b_norm, delta, np.asarray(result["mse"])
    return recon, b_norm, delta


def _lossy_note(lossy_duals: bool, n_f: int, quiet: bool) -> None:
    """Warn once per call that lossy_duals trades exactness for traffic
    (the mode can never be a default — see SolverOptions.lossy_duals)."""
    if lossy_duals and n_f and not quiet:
        import warnings

        warnings.warn(
            "lossy_duals: FISTA shadow duals stored as bfloat16 — "
            "reconstruction is NOT bit-exact vs float32, in exchange for "
            "half the dual arrays' memory traffic",
            stacklevel=3)


def denoise4D(
    datacube: np.ndarray,
    mu: np.ndarray,
    iterations: Union[int, Sequence[int]] = 10,
    FISTA: bool = True,
    stopping_relative_change: Optional[float] = None,
    isotropic_R: bool = False,
    isotropic_Q: bool = False,
    reference_data: Optional[np.ndarray] = None,
    BC_mode: int = 2,
    lam: Optional[np.ndarray] = None,
    quiet: bool = False,
    backend: Union[str, Backend] = Backend.AUTO,
    fista_restart: bool = False,
    progress: Optional[bool] = None,
    lossy_duals: bool = False,
):
    """Proximal anisotropic (or half-isotropic) TV denoising of a 4D datacube.

    Signature, defaults and return contract match the reference
    (reference cyTVDN/cyTVDN.py:19-247): returns
    ``(recon, b_norm, delta_recon[, MSE])``.

    ``progress``: live per-iteration progress (tqdm when available) via
    chunked execution (state bit-exact; traces to the last ulp);
    defaults to on for long non-quiet runs. Each chunk pays one host
    dispatch.

    ``lossy_duals``: opt-in LOSSY mode — store the FISTA shadow duals in
    bfloat16 (half their bytes). Never the default: the recon drift is
    far above the 1e-5 reference-parity budget.
    """
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, 4, 32.0
    )
    _bc_note(BC_mode)
    if not quiet:
        ratios = ", ".join(f"1/{m / l:.0f}" for m, l in zip(mu, lam))
        print(f"λ/μ ≈ [{ratios}]")
    # stability: 0 < λ/μ <= 1/32 — warning only, as in the reference
    # (reference cyTVDN.py:89-90)
    if (np.any(lam_mu > (1.0 / 32.0)) or np.any(lam_mu <= 0)) and not quiet:
        print(
            "WARNING: Parameters must satisfy 0 < λ/μ <= 1/32 "
            "or result may diverge!"
        )

    n_f, n_u = normalize_iterations(iterations, FISTA)
    calculate_mse = reference_data is not None
    opts = SolverOptions(
        ndim=4,
        iterations_fista=n_f,
        iterations_unacc=n_u,
        bc_mode=BCMode(BC_mode),
        stopping_relative_change=stopping_relative_change,
        isotropic_R=isotropic_R,
        isotropic_Q=isotropic_Q,
        calculate_mse=calculate_mse,
        backend=Backend(backend),
        fista_restart=fista_restart,
        lossy_duals=lossy_duals,
    )
    _lossy_note(lossy_duals, n_f, quiet)
    _memory_note(datacube, n_f > 0, 4, quiet)

    result = _run(datacube, lambda_inv, lam_mu, opts, reference_data,
                  _resolve_progress(progress, quiet, opts))
    return _finish(result, calculate_mse)


def denoise3D(
    datacube: np.ndarray,
    mu: np.ndarray,
    iterations: Union[int, Sequence[int]] = 7_500,
    stopping_relative_change: Optional[float] = None,
    BC_mode: int = 2,
    FISTA: bool = False,
    reference_data: Optional[np.ndarray] = None,
    lam: Optional[np.ndarray] = None,
    quiet: bool = False,
    backend: Union[str, Backend] = Backend.AUTO,
    fista_restart: bool = False,
    progress: Optional[bool] = None,
    lossy_duals: bool = False,
):
    """Proximal anisotropic TV denoising of a 3D cube (EELS SI).

    Signature, defaults (``iterations=7500``, ``FISTA=False``) and return
    contract match the reference (reference cyTVDN/cyTVDN.py:250-435).

    ``progress``: live per-iteration progress (tqdm when available) via
    chunked execution (state bit-exact; traces to the last ulp);
    defaults to on for long non-quiet runs — the default 7500-iteration
    run is no longer silent until completion.
    """
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, 3, 16.0
    )
    _bc_note(BC_mode)
    # hard bound in 3D (reference cyTVDN.py:306-308; the reference's message
    # says 1/8 but its check is 1/16 — we state the actual bound)
    if not (np.all(lam_mu <= (1.0 / 16.0)) and np.all(lam_mu > 0)):
        raise ValueError("Parameters must satisfy 0 < λ/μ <= 1/16")
    if not quiet:
        ratios = ", ".join(f"1/{m / l:.0f}" for m, l in zip(mu, lam))
        print(f"λ/μ ≈ [{ratios}]")

    n_f, n_u = normalize_iterations(iterations, FISTA)
    calculate_mse = reference_data is not None
    opts = SolverOptions(
        ndim=3,
        iterations_fista=n_f,
        iterations_unacc=n_u,
        bc_mode=BCMode(BC_mode),
        stopping_relative_change=stopping_relative_change,
        calculate_mse=calculate_mse,
        backend=Backend(backend),
        fista_restart=fista_restart,
        lossy_duals=lossy_duals,
    )
    _lossy_note(lossy_duals, n_f, quiet)
    _memory_note(datacube, n_f > 0, 3, quiet)

    result = _run(datacube, lambda_inv, lam_mu, opts, reference_data,
                  _resolve_progress(progress, quiet, opts))
    return _finish(result, calculate_mse)


def denoise(datacube, mu, **kwargs):
    """Rank-dispatching convenience wrapper: calls :func:`denoise3D` or
    :func:`denoise4D` based on ``datacube.ndim``."""
    nd = np.asarray(datacube).ndim
    if nd == 3:
        return denoise3D(datacube, mu, **kwargs)
    if nd == 4:
        return denoise4D(datacube, mu, **kwargs)
    raise ValueError(f"datacube must be 3D or 4D, got {nd}D")
