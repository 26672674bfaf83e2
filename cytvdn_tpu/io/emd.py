"""EMD v0.7 writer/reader — byte-compatible group/attribute layout with the
reference's hard-coded collective writer (reference cyTVDN/mpi.py:444-498).

The reference writes through parallel-HDF5 (``driver="mpio"``); h5py here
has no MPI, so multi-shard output is written as sequential region writes
into one file (:func:`write_emd_regions`) — the single-process analog of
the reference's per-rank ``write_direct`` with ``dest_sel`` region
selections (mpi.py:493-497). For multi-host runs the concurrent-writer
path is SHIPPED: :func:`write_emd_rows_multihost` early-allocates the
contiguous datacube and every process pwrites its own rows at the
raw byte offset — truly concurrent, no HDF5 writer lock
(``tools/bench_multihost_output.py`` times it against the gather and
ring schemes). Virtual-dataset
and solid-stitch part writers cover the sharded jax.Array surface.
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np

try:
    import h5py
except Exception:  # pragma: no cover - h5py is expected in the image
    h5py = None


def _require_h5py():
    if h5py is None:
        raise RuntimeError("h5py is required for EMD I/O")


_DIM_META = [
    ("dim1", "R_x", "[pix]"),
    ("dim2", "R_y", "[pix]"),
    ("dim3", "Q_x", "[pix]"),
    ("dim4", "Q_y", "[pix]"),
]


def _create_structure(fout, shape, dtype, virtual_layout=None,
                      alloc_early=False):
    """Create the EMD v0.7 skeleton (groups, attrs, dim axes) exactly as
    the reference lays it out (reference cyTVDN/mpi.py:449-491).

    ``alloc_early`` allocates the (contiguous) datacube's file space at
    create time with fill-time NEVER — the raw byte span then has a
    defined offset before any HDF5 write, which is what the concurrent
    multi-writer path needs (every byte is subsequently written by some
    process, so the skipped fill is never observable). The resulting
    dataset is byte-identical to the default writer's once filled."""
    top = fout.create_group("4DSTEM_experiment")
    top.attrs.create("emd_group_type", 2)
    top.attrs.create("version_major", 0)
    top.attrs.create("version_minor", 7)

    top.create_group("metadata")
    data = top.create_group("data")
    datacubes = data.create_group("datacubes")
    data.create_group("counted_datacubes")
    data.create_group("diffractionslices")
    data.create_group("realslices")
    data.create_group("pointlists")
    data.create_group("pointlistarrays")

    dc = datacubes.create_group("datacube_0")
    if virtual_layout is not None:
        dset = dc.create_virtual_dataset("data", virtual_layout)
    elif alloc_early:
        space = h5py.h5s.create_simple(tuple(shape))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        dcpl.set_fill_time(h5py.h5d.FILL_TIME_NEVER)
        did = h5py.h5d.create(dc.id, b"data",
                              h5py.h5t.py_create(np.dtype(dtype), logical=1),
                              space, dcpl)
        dset = h5py.Dataset(did)
    else:
        dset = dc.create_dataset("data", shape, dtype=dtype)
    dc.attrs.create("emd_group_type", 1)
    dc.attrs.create("metadata", -1)

    for ax, (dim_name, name, units) in enumerate(_DIM_META[: len(shape)]):
        dim = dc.create_dataset(dim_name, (shape[ax],))
        dim[...] = np.arange(0, shape[ax])
        dim.attrs.create("name", np.bytes_(name))
        dim.attrs.create("units", np.bytes_(units))
    return dset


def emd_path(path: str) -> str:
    """The reference forces the output extension to .emd
    (reference mpi.py:447)."""
    if path.endswith(".emd"):
        return path
    stem = path.rsplit(".", 1)[0] if "." in path else path
    return stem + ".emd"


def write_emd(path: str, data: np.ndarray) -> str:
    """Write a full array as an EMD v0.7 file. Returns the actual path."""
    _require_h5py()
    path = emd_path(path)
    with h5py.File(path, "w") as fout:
        dset = _create_structure(fout, data.shape, data.dtype)
        dset[...] = data
    return path


def write_emd_regions(
    path: str,
    global_shape: Tuple[int, ...],
    dtype,
    regions: Iterable[Tuple[Tuple[slice, ...], np.ndarray]],
) -> str:
    """Create the EMD structure once, then write non-overlapping regions —
    the single-writer analog of the reference's per-rank region writes
    (reference mpi.py:493-497)."""
    _require_h5py()
    path = emd_path(path)
    with h5py.File(path, "w") as fout:
        dset = _create_structure(fout, global_shape, dtype)
        for sel, block in regions:
            dset[sel] = block
    return path


#: outputs up to this size are gathered over the network and written by
#: process 0
#: alone (no part files, NO shared filesystem needed — each device briefly
#: holds the full cube)
_GATHER_MAX_BYTES = 4 << 30
#: outputs up to this size are stitched into one self-contained file by
#: default; larger outputs keep the virtual-dataset master unless
#: stitch="solid" is forced. Part-based paths require the hosts to share
#: the output filesystem — the same requirement the reference's
#: parallel-HDF5 MPI-IO writer has (mpi.py:115,447).
_SOLID_STITCH_MAX_BYTES = 8 << 30


def _gather_replicated(array):
    """Reshard a global array to fully-replicated (allgather over
    the interconnect) and return it as one host ndarray."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = getattr(array.sharding, "mesh", None)
    if mesh is None:
        raise ValueError("array has no mesh sharding")
    rep = jax.device_put(array, NamedSharding(mesh, P()))
    return np.asarray(rep)


def write_emd_sharded(path: str, array, stitch: str = "auto") -> str:
    """Write a (possibly sharded) jax.Array as EMD v0.7 without gathering
    it into one host buffer (except the small-output gather path below).

    - Single process: each addressable shard is written as a region into
      one file (the analog of the reference's per-rank ``write_direct``
      region writes, mpi.py:493-497).
    - Multi-process (several hosts), ``stitch="auto"`` and output ≤
      ``_GATHER_MAX_BYTES``: the array is replicated over the network and process
      0 writes ONE file — no part files, no shared-filesystem
      requirement.
    - Multi-process, larger outputs (or explicit ``stitch=``): HDF5
      without MPI-IO cannot share a writer, so every process writes its
      shards to a ``.partN.h5`` sidecar file and process 0 stitches the
      master — this path (like the reference's MPI-IO writer,
      mpi.py:115,447) requires a shared filesystem:

      - ``"auto"``: one self-contained EMD file (parts copied in, then
        deleted) up to ``_SOLID_STITCH_MAX_BYTES``; virtual-dataset master
        above (parts must stay next to the master);
      - ``"solid"``: always copy into one file;
      - ``"virtual"``: always the virtual-dataset master (no copy pass).
    """
    import numpy as np

    shards = getattr(array, "addressable_shards", None)
    if shards is None:
        return write_emd(path, np.asarray(array))
    if len(shards) == getattr(array, "sharding").num_devices:
        regions = ((s.index, np.asarray(s.data)) for s in shards)
        return write_emd_regions(path, array.shape, array.dtype, regions)

    import jax
    from jax.experimental import multihost_utils

    proc = jax.process_index()
    n_proc = jax.process_count()
    nbytes = int(np.prod(array.shape)) * np.dtype(array.dtype).itemsize
    if stitch == "auto" and nbytes <= _GATHER_MAX_BYTES:
        try:
            full = _gather_replicated(array)
        except Exception:
            full = None  # fall back to the part-based writer
        if full is not None:
            if proc == 0:
                write_emd(path, full)
            multihost_utils.sync_global_devices("cytv_emd_gather_written")
            return emd_path(path)

    regions = [(s.index, np.asarray(s.data)) for s in shards]
    write_emd_part(path, proc, regions)
    multihost_utils.sync_global_devices("cytv_emd_parts_written")
    if proc == 0:
        solid = stitch == "solid" or (
            stitch == "auto" and nbytes <= _SOLID_STITCH_MAX_BYTES
        )
        if solid:
            stitch_emd_solid(path, array.shape, array.dtype, n_proc)
        else:
            stitch_emd_virtual(path, array.shape, array.dtype, n_proc)
    multihost_utils.sync_global_devices("cytv_emd_stitched")
    return emd_path(path)


def _part_path(path: str, process_index: int) -> str:
    return emd_path(path) + f".part{process_index}.h5"


def write_emd_part(path: str, process_index: int, regions) -> str:
    """Write one process's shard regions to its sidecar part file, with
    each block's global position recorded in attrs."""
    _require_h5py()
    part = _part_path(path, process_index)
    with h5py.File(part, "w") as f:
        for i, (sel, block) in enumerate(regions):
            d = f.create_dataset(f"block{i}", data=np.asarray(block))
            starts = [s.start or 0 for s in sel]
            d.attrs["start"] = starts
    return part


def stitch_emd_virtual(path: str, global_shape, dtype, num_parts: int) -> str:
    """Create the EMD master whose datacube is a virtual dataset over the
    ``.partN.h5`` sidecars."""
    _require_h5py()
    path = emd_path(path)
    layout = h5py.VirtualLayout(shape=tuple(global_shape), dtype=dtype)
    for p in range(num_parts):
        part = _part_path(path, p)
        with h5py.File(part, "r") as f:
            for name in f:
                blk = f[name]
                start = [int(s) for s in blk.attrs["start"]]
                sel = tuple(
                    slice(st, st + ext) for st, ext in zip(start, blk.shape)
                )
                layout[sel] = h5py.VirtualSource(
                    os.path.basename(part), name, shape=blk.shape
                )
    with h5py.File(path, "w") as fout:
        dset = _create_structure(fout, tuple(global_shape), dtype,
                                 virtual_layout=layout)
    return path


def stitch_emd_solid(path: str, global_shape, dtype, num_parts: int,
                     remove_parts: bool = True) -> str:
    """Copy the ``.partN.h5`` sidecar blocks into ONE self-contained EMD
    file (block-by-block streaming — no full-cube host buffer) and delete
    the parts. This restores the reference's single-artifact output
    contract (mpi.py:444-498) for outputs that may be moved or archived;
    the virtual-dataset stitch stays available for very large cubes."""
    _require_h5py()
    path = emd_path(path)
    with h5py.File(path, "w") as fout:
        dset = _create_structure(fout, tuple(global_shape), dtype)
        for p in range(num_parts):
            with h5py.File(_part_path(path, p), "r") as f:
                for name in f:
                    blk = f[name]
                    start = [int(s) for s in blk.attrs["start"]]
                    sel = tuple(
                        slice(st, st + ext)
                        for st, ext in zip(start, blk.shape)
                    )
                    dset[sel] = blk[...]
    if remove_parts:
        for p in range(num_parts):
            try:
                os.remove(_part_path(path, p))
            except OSError:
                pass
    return path


_DSET_PATH = "4DSTEM_experiment/data/datacubes/datacube_0/data"


def _raw_row_span(path: str, global_shape, dtype):
    """``(byte_offset, row_bytes)`` of the datacube's contiguous on-disk
    span, or ``None`` when raw-offset writes cannot be used (layout not
    contiguous, space not yet allocated, or a non-native on-disk byte
    order). Axis-0 rows of a C-order contiguous dataset are contiguous
    byte ranges, so each process's row block is one ``pwrite`` span.
    ``CYTV_NO_RAW_WRITES=1`` disables the raw path (the writers then
    ring through HDF5 — same bytes, serialized)."""
    if os.environ.get("CYTV_NO_RAW_WRITES"):
        return None
    try:
        with h5py.File(path, "r") as f:
            d = f[_DSET_PATH]
            if tuple(d.shape) != tuple(global_shape):
                return None
            if d.id.get_create_plist().get_layout() != h5py.h5d.CONTIGUOUS:
                return None
            off = d.id.get_offset()
            # numpy dtype equality is byte-order aware ('<f4' == '=f4'
            # only on little-endian hosts) — a big-endian file or host
            # falls back to the HDF5 writer ring
            if off is None or d.dtype != np.dtype(dtype).newbyteorder("="):
                return None
            row_bytes = int(np.prod(global_shape[1:])) * d.dtype.itemsize
            return int(off), row_bytes
    except Exception:
        return None


#: filesystem-page granularity for the concurrent raw writer's bulk/fragment
#: split. NFS clients cache and flush at page granularity with only
#: close-to-open coherence, so two clients concurrently dirtying the SAME
#: page would read-modify-write-clobber each other at shard seams; keeping
#: concurrent writes page-disjoint (and serializing the tiny page-sharing
#: fragments behind barriers) is correct there too. 4096 covers every
#: Linux page size in production; a larger true page size only means the
#: fragments stay "bulk" — still disjoint, still safe on local/Lustre/GPFS,
#: and the ring serialization protects the NFS case regardless.
_RAW_PAGE = 4096


def _pwrite_span(fd, buf, pos: int) -> None:
    """Positioned write of one byte span (Linux caps a single pwrite near
    2 GiB, hence the 1 GiB chunking)."""
    n = len(buf)
    done = 0
    while done < n:
        done += os.pwrite(fd, buf[done:done + (1 << 30)], pos + done)


def _pwrite_rows(path: str, offset: int, row_bytes: int,
                 rows: np.ndarray, g0: int, dtype):
    """Write the PAGE-ALIGNED interior of ``rows``'s byte span (axis-0 rows
    starting at global row ``g0``) with positioned POSIX writes — no HDF5
    writer lock, so every process writes its bulk truly concurrently, and
    no two processes ever dirty the same filesystem page (see
    ``_RAW_PAGE``). Returns the up-to-two boundary fragments
    ``(file_pos, bytes)`` that share a page with a neighbor (or with HDF5
    metadata); the caller writes those in a serialized ring. No fsync —
    durability semantics match the HDF5 ring writer's close(), which
    doesn't fsync either."""
    data = np.ascontiguousarray(rows, dtype=np.dtype(dtype).newbyteorder("="))
    buf = memoryview(data).cast("B")
    pos0 = offset + g0 * row_bytes
    pos1 = pos0 + len(buf)
    a0 = min(-(-pos0 // _RAW_PAGE) * _RAW_PAGE, pos1)  # align up, clamp
    a1 = max((pos1 // _RAW_PAGE) * _RAW_PAGE, a0)      # align down, clamp
    frags = []
    if a0 > pos0:
        frags.append((pos0, bytes(buf[:a0 - pos0])))
    if pos1 > a1:
        frags.append((a1, bytes(buf[a1 - pos0:])))
    if a1 > a0:
        fd = os.open(path, os.O_WRONLY)
        try:
            _pwrite_span(fd, buf[a0 - pos0:a1 - pos0], a0)
        finally:
            os.close(fd)
    return frags


def _pwrite_frags(path: str, frags) -> None:
    """Write this process's boundary fragments (its turn in the serialized
    ring). Open/close per turn so NFS close-to-open coherence revalidates
    the shared boundary pages written by earlier turns."""
    if not frags:
        return
    fd = os.open(path, os.O_WRONLY)
    try:
        for pos, chunk in frags:
            _pwrite_span(fd, memoryview(chunk), pos)
    finally:
        os.close(fd)


def write_emd_rows_multihost(path: str, global_shape, dtype,
                             rows: np.ndarray, row_range) -> str | None:
    """Concurrent-writer multihost output: every process writes its OWN
    axis-0 rows into ONE shared EMD file — the functional equivalent of
    the reference's parallel-HDF5 per-rank ``write_direct`` region writes
    (reference cyTVDN/mpi.py:444-498, ``driver="mpio"``), built on plain
    h5py.

    The datacube is created contiguous with early-allocated file space,
    so its raw byte span has a defined offset before any data lands;
    each process then writes its rows at the computed offset with
    positioned POSIX writes (``os.pwrite``) — TRULY concurrent, no HDF5
    writer lock, zero wire bytes. When the raw span is unavailable
    (exotic filesystem, byte-order mismatch) the writers degrade to the
    sequential-by-process HDF5 token ring; both variants produce
    byte-identical files. Requires the output path on a filesystem
    visible to all processes (the same precondition the reference's
    MPI-IO writer has, mpi.py:115,447); visibility is probed
    collectively and the function returns ``None`` (caller falls back to
    the gather) when any process cannot see the file. Set
    ``CYTV_NO_SHARED_FS=1`` to force the fallback.

    Returns the written path, or ``None`` if the filesystem is not
    shared.
    """
    import jax
    from jax.experimental import multihost_utils

    _require_h5py()
    path = emd_path(path)
    proc = jax.process_index()
    g0, g1 = int(row_range[0]), int(row_range[1])
    if proc == 0:
        # fresh per-run nonce: the visibility probe must not accept a
        # STALE same-shape file a previous run left at this path on a
        # NON-shared filesystem host (every process would then happily
        # write its rows into its own local file — silently scattered
        # output). Each process must read back THIS run's token.
        nonce = (int(np.frombuffer(os.urandom(8), np.uint64)[0]) >> 2) | 1
        with h5py.File(path, "w") as fout:
            _create_structure(fout, tuple(global_shape), dtype,
                              alloc_early=True)
            fout.attrs["cytv_run_nonce"] = np.int64(nonce)
    multihost_utils.sync_global_devices("cytv_emd_mh_created")
    observed = 0
    if not os.environ.get("CYTV_NO_SHARED_FS"):
        try:
            with h5py.File(path, "r") as f:
                d = f["4DSTEM_experiment/data/datacubes/datacube_0/data"]
                if tuple(d.shape) == tuple(global_shape):
                    observed = int(f.attrs.get("cytv_run_nonce", 0))
        except Exception:
            observed = 0
    # the verdict must be COLLECTIVE: every process takes the same branch
    # (the multi-host control-flow invariant) — one process falling back
    # while others enter the write ring would hang the job. Shared iff
    # every process observed the SAME fresh nonce proc 0 just wrote.
    allv = np.asarray(multihost_utils.process_allgather(
        np.asarray([observed], np.int64)))
    if int(allv.min()) == 0 or int(allv.min()) != int(allv.max()):
        if proc == 0:
            try:
                os.remove(path)
            except OSError:
                pass
        multihost_utils.sync_global_devices("cytv_emd_mh_fallback")
        return None
    # raw-offset concurrent writes when every process resolves the SAME
    # contiguous byte span (the verdict must be collective — one process
    # pwriting while another rings would corrupt nothing but would hang
    # on the mismatched barrier names)
    span = _raw_row_span(path, global_shape, dtype)
    offs = np.asarray(multihost_utils.process_allgather(np.asarray(
        [span[0] if span else -1], np.int64)))
    if int(offs.min()) == int(offs.max()) and int(offs.min()) >= 0:
        frags = _pwrite_rows(path, span[0], span[1], rows, g0, dtype)
        multihost_utils.sync_global_devices("cytv_emd_mh_raw_written")
        # Boundary fragments share filesystem pages with a neighbor (or
        # with HDF5 metadata); on NFS-style page-granular caches two
        # concurrent writers of one page would clobber each other, so the
        # fragments (≤ 2 pages/process) go through a serialized ring —
        # the bulk above stays fully concurrent.
        for p in range(jax.process_count()):
            if p == proc:
                _pwrite_frags(path, frags)
            multihost_utils.sync_global_devices(f"cytv_emd_mh_frag_{p}")
        if proc == 0:
            with h5py.File(path, "r+") as fout:
                if "cytv_run_nonce" in fout.attrs:
                    # drop the probe token: the finished file keeps the
                    # reference writer's exact attribute surface
                    del fout.attrs["cytv_run_nonce"]
        multihost_utils.sync_global_devices("cytv_emd_mh_raw_done")
        return path
    nproc = jax.process_count()
    for p in range(nproc):
        if p == proc:
            with h5py.File(path, "r+") as fout:
                if p == 0 and "cytv_run_nonce" in fout.attrs:
                    # drop the probe token: the finished file keeps the
                    # reference writer's exact attribute surface
                    del fout.attrs["cytv_run_nonce"]
                d = fout["4DSTEM_experiment/data/datacubes/datacube_0/data"]
                d[(slice(g0, g1),) + (slice(None),)
                  * (len(global_shape) - 1)] = rows
        multihost_utils.sync_global_devices(f"cytv_emd_mh_row_{p}")
    return path


def write_emd_rows_gathered(path: str, global_shape, dtype,
                            rows: np.ndarray, row_range,
                            chunk_rows: int) -> str | None:
    """No-shared-FS multihost output fallback: stream every process's
    axis-0 rows to process 0 in fixed-size padded chunks (allgather
    shapes must agree across processes) and region-write them there —
    no process ever materializes the full cube. Row ranges are
    allgathered, so ANY contiguous row partition works (uneven
    included). Returns the written path on process 0, ``None`` on the
    other processes (which still must iterate the collectives).

    This is the one implementation of the gather scheme; the CLI and
    tools/bench_multihost_output.py both call it (slower than
    ``write_emd_rows_multihost`` on a shared FS)."""
    import jax
    from jax.experimental import multihost_utils

    _require_h5py()
    proc = jax.process_index()
    nproc = jax.process_count()
    g0, g1 = int(row_range[0]), int(row_range[1])
    ranges = np.asarray(multihost_utils.process_allgather(
        np.asarray([g0, g1], np.int64)))
    n0 = int(global_shape[0])
    rest = tuple(global_shape[1:])
    ch = max(1, int(chunk_rows))

    def chunks():
        for c0 in range(0, n0, ch):
            c1 = min(c0 + ch, n0)
            pad = np.zeros((ch,) + rest, dtype)
            o0, o1 = max(c0, g0), min(c1, g1)
            if o1 > o0:
                pad[o0 - c0:o1 - c0] = rows[o0 - g0:o1 - g0]
            got = np.asarray(multihost_utils.process_allgather(pad))
            if proc != 0:
                continue
            block = np.zeros((c1 - c0,) + rest, dtype)
            for q in range(nproc):
                q0, q1 = int(ranges[q][0]), int(ranges[q][1])
                a0, a1 = max(c0, q0), min(c1, q1)
                if a1 > a0:
                    block[a0 - c0:a1 - c0] = got[q][a0 - c0:a1 - c0]
            yield ((slice(c0, c1),) + (slice(None),) * len(rest)), block

    if proc == 0:
        return write_emd_regions(path, global_shape, dtype, chunks())
    for _ in chunks():
        pass
    return None


def read_emd(path: str, lazy: bool = False):
    """Read the datacube from an EMD v0.7 file (layout per the reference
    writer). With ``lazy=True`` returns ``(h5py.File, h5py.Dataset)`` for
    sharded block reads; the caller closes the file."""
    _require_h5py()
    f = h5py.File(path, "r")
    try:
        dset = f["4DSTEM_experiment/data/datacubes/datacube_0/data"]
    except KeyError:
        # fall back: first dataset named "data" anywhere (EMD variants)
        found = []

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset) and name.endswith("/data"):
                found.append(obj)

        f.visititems(visit)
        if not found:
            f.close()
            raise ValueError(f"no datacube dataset found in {path}")
        dset = found[0]
    if lazy:
        return f, dset
    arr = dset[...]
    f.close()
    return arr
