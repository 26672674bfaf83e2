"""shard_map solver: the device-mesh replacement for the reference's MPI
distributed runtime ``run_MPI`` (reference cyTVDN/mpi.py:27-501).

Differences from the reference, by design:

- One engine: the sharded path runs the *same* ``run_solver`` iteration code
  as the single-device path, just with a :class:`MeshComm` strategy — no
  drift (the reference's MPI loop lacks FISTA, 3D, convergence metrics and
  stopping; here all of those work distributed, with ``psum`` providing the
  reductions the reference never implemented, README.md:34).
- Any subset of data axes can be split (the reference splits only the two
  scan axes, mpi.py:357-358); splitting the Q/spectral axes uses the same
  halo mechanism.
- Exact seams: see ``cytvdn_tpu/parallel/halo.py`` (SURVEY.md §8.3).
- Chunked execution + checkpoint/resume work distributed too (``state`` /
  ``i_stop`` / ``keep_state`` mirror ``run_solver``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cytvdn_tpu.config import SolverOptions
from cytvdn_tpu.parallel.halo import MeshComm
from cytvdn_tpu.parallel.partition import choose_grid
from cytvdn_tpu.solver.engine import run_solver


def resolve_shard(
    shard: Union[str, Sequence[int], None],
    shape: Tuple[int, ...],
    n_devices: int,
) -> Tuple[int, ...]:
    """Normalize the ``shard`` argument to a per-data-axis tile-count tuple.

    ``'auto'`` chooses a grid over the two scan axes with the
    edge-minimizing partitioner (the reference's policy, mpi.py:130-153).
    """
    ndim = len(shape)
    if shard is None:
        return (1,) * ndim
    if shard == "auto":
        # prefer all devices; when the scan axes have no even tiling over
        # that count (e.g. 250×250 on 8 devices), degrade to the largest
        # device count that tiles evenly rather than failing (the reference
        # partitioner handles uneven ceil-sized tiles, mpi.py:139-141;
        # even tiling is what keeps the mesh run bit-exact here)
        for n in range(n_devices, 0, -1):
            try:
                grid = choose_grid(n, shape[:2])
            except ValueError:
                continue
            return tuple(grid) + (1,) * (ndim - 2)
        return (1,) * ndim
    shard = tuple(int(s) for s in shard)
    if len(shard) != ndim:
        raise ValueError(f"shard must have {ndim} entries, got {shard}")
    for ax, (w, e) in enumerate(zip(shard, shape)):
        if e % w:
            raise ValueError(
                f"axis {ax} extent {e} not divisible by {w} tiles; choose a "
                f"divisible tiling (or pad the cube)"
            )
    return shard


def make_mesh(shard: Sequence[int], devices=None) -> Tuple[Mesh, Dict[int, str]]:
    """Build a Mesh whose axes correspond to the split data axes.

    Returns ``(mesh, axis_names)`` with ``axis_names`` mapping data axis →
    mesh axis name (only split axes present). The devices are laid out in
    ``jax.devices()`` order: the cards of one host are joined all to all
    (NVLink), so the mesh follows the data decomposition alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    n_needed = int(np.prod(shard))
    if n_needed > len(devices):
        raise ValueError(
            f"tiling {tuple(shard)} needs {n_needed} devices, have {len(devices)}"
        )
    split_axes = [ax for ax, w in enumerate(shard) if w > 1]
    if not split_axes:
        split_axes = [0]  # degenerate 1-device mesh still needs an axis
    names = {ax: f"ax{ax}" for ax in split_axes}
    mesh_shape = tuple(shard[ax] for ax in split_axes)
    dev_array = np.array(devices[:n_needed]).reshape(mesh_shape)
    mesh = Mesh(dev_array, tuple(names[ax] for ax in split_axes))
    return mesh, names


@functools.lru_cache(maxsize=32)
def _build_sharded_fn(opts: SolverOptions, shard: Tuple[int, ...], ndim: int,
                      with_ref: bool, with_state: bool, keep_state: bool,
                      devices_key):
    mesh, names = make_mesh(shard, devices=list(devices_key))
    data_spec = P(*[names.get(ax) for ax in range(ndim)])
    rep = P()

    n_ds = ndim if opts.iterations_fista else 0
    state_specs = {
        "recon": data_spec,
        "accs": (data_spec,) * ndim,
        "ds": (data_spec,) * n_ds,
        "b_norm": rep,
        "delta": rep,
        "mse": rep,
        "i": rep,
        "tk": rep,
    }

    out_specs = {
        "recon": data_spec,
        "b_norm": rep,
        "delta": rep,
        "iterations_run": rep,
        "early_stopped": rep,
    }
    if opts.calculate_mse:
        out_specs["mse"] = rep
    if keep_state:
        out_specs["accs"] = (data_spec,) * ndim
        out_specs["ds"] = (data_spec,) * n_ds
        out_specs["i"] = rep
        out_specs["tk"] = rep

    in_specs = [data_spec, rep, rep, rep]  # orig, lambda_inv, lam_mu, i_stop
    if with_ref:
        in_specs.append(data_spec)
    if with_state:
        in_specs.append(state_specs)

    def shard_body(orig, lambda_inv, lam_mu, i_stop, *rest):
        rest = list(rest)
        ref = rest.pop(0) if with_ref else None
        state = rest.pop(0) if with_state else None
        comm = MeshComm(names, opts.bc_mode)
        out = run_solver(
            orig, lambda_inv, lam_mu, opts, ref, comm,
            state=state, i_stop=i_stop, keep_state=keep_state,
        )
        if not keep_state:
            out.pop("accs", None)
            out.pop("ds", None)
            out.pop("i", None)
            out.pop("tk", None)
        return out

    fn = jax.shard_map(
        shard_body, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=out_specs, check_vma=False,
    )
    return jax.jit(fn), mesh, data_spec


def run_sharded(
    orig,
    lambda_inv,
    lam_mu,
    opts: SolverOptions,
    reference_data=None,
    shard: Union[str, Sequence[int], None] = "auto",
    devices=None,
    state: Optional[Dict[str, Any]] = None,
    i_stop=None,
    keep_state: bool = False,
):
    """Run the solver sharded over a device mesh. Same return contract as
    :func:`cytvdn_tpu.solver.engine.run_solver`."""
    devices = tuple(devices if devices is not None else jax.devices())
    shard_t = resolve_shard(shard, orig.shape, len(devices))
    with_ref = reference_data is not None
    with_state = state is not None
    if i_stop is None:
        i_stop = opts.total_iterations

    fn, mesh, data_spec = _build_sharded_fn(
        opts, shard_t, orig.ndim, with_ref, with_state, keep_state, devices
    )
    # Inputs are committed directly with their target sharding: host
    # arrays transfer per-shard to their owning devices, never
    # materializing the full cube on one device (a ``jnp.asarray`` onto
    # the default device would need the whole cube to fit the first card).
    data_sh = NamedSharding(mesh, data_spec)
    rep_sh = NamedSharding(mesh, P())

    def put(x, sh):
        from cytvdn_tpu.utils.checkpoint import ShardedBlocks

        if isinstance(x, ShardedBlocks):
            # multi-process checkpoint resume: each process supplies
            # only the blocks its devices own
            return jax.make_array_from_callback(x.shape, sh, x.lookup)
        return jax.device_put(x, sh)

    args = [put(orig, data_sh), put(jnp.asarray(lambda_inv), rep_sh),
            put(jnp.asarray(lam_mu), rep_sh),
            put(jnp.asarray(i_stop, jnp.int32), rep_sh)]
    if with_ref:
        args.append(put(reference_data, data_sh))
    if with_state:
        data_keys = ("recon", "accs", "ds")
        jstate = {}
        for k, v in state.items():
            sh = data_sh if k in data_keys else rep_sh
            if isinstance(v, tuple):
                jstate[k] = tuple(put(x, sh) for x in v)
            else:
                jstate[k] = put(v, sh)
        args.append(jstate)
    return fn(*args)
