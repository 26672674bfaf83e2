"""Sharded input loading: build a global device array from per-shard block
reads — the replacement for the reference's parallel-HDF5
collective reads (reference cyTVDN/mpi.py:111-118, 233-236).

``jax.make_array_from_callback`` asks each *process* only for the blocks
its own devices hold, so on a multi-host cluster every host reads only its
shards (+ nothing else) from the filesystem; no rank ever materializes the
full cube — the property the reference gets from memory-mapped/MPI-IO
opens (mpi.py:93-124).
"""

from __future__ import annotations

from typing import Sequence, Union

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from cytvdn_tpu.io.loaders import InputHandle, open_input
from cytvdn_tpu.parallel.sharded import make_mesh, resolve_shard


def sharding_for(shard: Sequence[int], ndim: int, devices=None):
    """NamedSharding splitting data axes per the ``shard`` tile counts."""
    mesh, names = make_mesh(shard, devices)
    spec = P(*[names.get(ax) for ax in range(ndim)])
    return NamedSharding(mesh, spec)


def load_sharded_array(
    source: Union[str, InputHandle, np.ndarray],
    shard: Union[str, Sequence[int]],
    devices=None,
    dtype=np.float32,
) -> jax.Array:
    """Load a datacube directly into a sharded global device array.

    ``source`` may be a file path, an open :class:`InputHandle`, or an
    in-memory array (then blocks are sliced from it). Each device's shard
    is read independently via ``InputHandle.read_block``.
    """
    close = False
    if isinstance(source, str):
        handle: Union[InputHandle, np.ndarray] = open_input(source)
        close = True
    else:
        handle = source
    try:
        shape = tuple(handle.shape)
        n_dev = len(devices) if devices is not None else len(jax.devices())
        shard_t = resolve_shard(shard, shape, n_dev)
        sharding = sharding_for(shard_t, len(shape), devices)

        if isinstance(handle, np.ndarray):
            def cb(index):
                return np.ascontiguousarray(handle[index]).astype(
                    dtype, copy=False)
        else:
            def cb(index):
                return handle.read_block(index).astype(dtype, copy=False)

        return jax.make_array_from_callback(shape, sharding, cb)
    finally:
        if close:
            handle.close()
