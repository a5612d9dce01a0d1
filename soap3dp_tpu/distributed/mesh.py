"""Multi-chip scaling: read-sharded data parallelism over a device mesh.

The reference scales to multiple GPUs by running one process per
device with the host index shared via mmap+mlock (README.md section 3;
IndexHandler.cpp:180-226). The equivalent here is one process
driving a jax.sharding.Mesh: the index is replicated into every
card's memory (GPUINDEXUpload per card), read batches are sharded
along the batch axis, and per-shard statistics are combined with psum
(over NVLink on one host). SAM emission stays host-side per shard, merged like the
reference's .gout.N files.

For whole-genome full-SA configurations the SA-sample table (the one
large, rarely-touched array) can additionally be sharded along the
mesh and fetched with collectives; that path is scaffolded by
`shard_index_sa` and used only when `sa_sharded` is requested.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from soap3dp_tpu.fm import fmindex
from soap3dp_tpu.fm.fmindex import DeviceIndex
from soap3dp_tpu.fm.search import SearchConfig, _search_batch
from soap3dp_tpu.index.builder import Index


def make_mesh(devices=None, axis: str = "reads") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def mesh_of(didx: DeviceIndex) -> Mesh | None:
    """The mesh a DeviceIndex was replicated onto, or None (single chip).

    The pipeline discovers multi-chip mode from the index upload: load
    with `replicate_index(index, mesh)` and every downstream stage
    (seed search, DP rescue) shards its batches over the same mesh —
    the one-switch analog of the reference's one-process-per-GPU +
    shared-index recipe (README.md section 3, IndexHandler.cpp:180-226).
    """
    sh = getattr(didx.occ, "sharding", None)
    m = getattr(sh, "mesh", None)
    if m is None:
        return None
    if getattr(m, "empty", False):
        return None
    try:
        if m.devices.size <= 1:
            return None
    except Exception:
        return None
    return m


def shard_rows(mesh: Mesh, *arrays):
    """device_put each array row-sharded over the mesh's first axis.

    Rows must already be padded to a multiple of the mesh size
    (see pad_to_mesh)."""
    sh = NamedSharding(mesh, P(mesh.axis_names[0]))
    out = tuple(jax.device_put(np.asarray(a), sh) for a in arrays)
    return out if len(out) > 1 else out[0]


def pad_to_mesh(mesh: Mesh, n: int, quantum: int = 1) -> int:
    """Smallest padded size >= n that is a multiple of mesh_size*quantum."""
    q = mesh.devices.size * quantum
    return max(q, -(-int(n) // q) * q)


def replicate_index(index: Index, mesh: Mesh, shard_sa: bool = False
                    ) -> DeviceIndex:
    """Upload the index to every chip in the mesh.

    With ``shard_sa`` the SA-sample table — the one large, rarely
    touched array (up to 12GB at human scale with full sampling,
    SURVEY section 2.3) — is sharded across the mesh instead of
    replicated; XLA inserts the all-gather/collective for the few SA
    lookups the compacted pipeline performs. Everything else (occ
    blocks, LUT, packed genome) stays replicated in HBM.
    """
    repl = NamedSharding(mesh, P())
    didx = fmindex.device_index(index, sharding=repl)
    if shard_sa:
        n = didx.sa_samples.shape[0]
        pad = (-n) % mesh.devices.size
        sa = jnp.concatenate(
            [didx.sa_samples,
             jnp.zeros(pad, didx.sa_samples.dtype)]) if pad else didx.sa_samples
        didx = dataclasses.replace(
            didx, sa_samples=jax.device_put(
                sa, NamedSharding(mesh, P(mesh.axis_names[0]))))
    return didx


def shard_batch(mesh: Mesh, reads: np.ndarray, lens: np.ndarray,
                axis: str = "reads"):
    """Pad the batch to a multiple of the mesh size and shard axis 0."""
    n = mesh.devices.size
    B = reads.shape[0]
    pad = (-B) % n
    if pad:
        reads = np.pad(reads, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
    sh = NamedSharding(mesh, P(axis))
    return (jax.device_put(reads, sh), jax.device_put(lens, sh), B)


def sharded_search(didx: DeviceIndex, reads, lens, cfg: SearchConfig,
                   max_steps: int):
    """Data-parallel seed search: XLA partitions the jitted search over
    the batch axis; the index arrays are replicated, so the only
    cross-chip traffic is the candidate compaction's reduction."""
    hits, _ = _search_batch(didx, reads, lens, cfg, cfg.occ_cap, max_steps)
    return hits


@partial(jax.jit, static_argnames=("cfg", "max_steps"))
def _align_step_impl(didx, reads, lens, cfg, max_steps):
    hits, _ = _search_batch(didx, reads, lens, cfg, cfg.occ_cap, max_steps)
    B = reads.shape[0]
    read_of = jnp.where(hits.row >= B, hits.row - B, hits.row)
    read_of = jnp.clip(read_of, 0, B - 1)
    aligned = jnp.zeros((B,), bool).at[read_of].max(hits.valid)
    return hits, aligned.sum()


def alignment_step(mesh: Mesh, didx: DeviceIndex, reads, lens,
                   cfg: SearchConfig, max_steps: int):
    """One full sharded alignment step + a global aligned-read count.

    The count reduction is the cross-chip collective of this workload —
    the analog of merging the reference's per-process summary lines.
    XLA inserts the psum from the output sharding (replicated scalar
    from sharded inputs).
    """
    hits, n = _align_step_impl(didx, reads, lens, cfg, max_steps)
    return hits, int(n)
