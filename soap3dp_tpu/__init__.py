"""soap3dp_tpu — a short-read DNA aligner for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas rebuild of the SOAP3-dp method
(reference: aquaskyline/SOAP3-dp, C/C++/CUDA): FM-index ("2BWT") seed
search for exact/mismatch alignment plus semi-global banded affine-gap
dynamic programming rescue, with paired-end insert-size pairing,
BWA-like MAPQ, and SAM/succinct output.

The architecture is its own, not a port:

* the index lives in device memory as flat arrays: per-16bp-word
  cumulative occ counts and packed BWT words,
* search is a batched, static-shape seed-and-verify pipeline
  (pigeonhole seeds -> backward search -> sampled-SA decode ->
  XOR/popcount verification) instead of the reference's per-thread
  divergent case enumeration (reference DV-Kernel.cu:4249-4502),
* DP rescue is an anti-diagonal wavefront, fused with its traceback
  in one Pallas (Triton) kernel on the GPU (reference
  DV-DPfunctions.cu:146-241), and
* scaling is data-parallel over reads via jax.sharding / shard_map
  (the reference scales by one process per GPU, README.md section 3).
"""

from soap3dp_tpu.version import __version__

__all__ = ["__version__"]


def _tune_allocator() -> None:
    """Keep large malloc blocks on the heap instead of mmap/munmap.

    Virtualized hosts can take hundreds of microseconds per anonymous
    page fault; glibc returns mmap'd blocks to the OS on free, so every
    large numpy temporary re-faults its pages (observed ~30 MB/s vs
    ~10 GB/s on pre-touched memory). Raising M_MMAP_THRESHOLD and
    M_TRIM_THRESHOLD makes the heap grow once and be reused.
    """
    import ctypes
    import sys

    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 2**31 - 1)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 2**31 - 1)  # M_TRIM_THRESHOLD
    except OSError:
        pass


_tune_allocator()
