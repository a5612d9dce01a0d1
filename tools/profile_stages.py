"""Per-stage device/host timing breakdown on the current JAX backend.

The rebuild's analog of the reference's per-stage timers
(BGS-Experiment.log stage breakdowns; setStartTime/getElapsedTime,
2bwt-lib/Timing.c). Run on the GPU to see where a batch goes:

    python tools/profile_stages.py [--pairs 25000]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync(out):
    import jax

    jax.block_until_ready(out)


def t(label, fn, *args, n=3, **kw):
    _sync(fn(*args, **kw))  # warmup/compile
    best = float("inf")
    for _ in range(n):
        t0 = time.time()
        out = fn(*args, **kw)
        _sync(out)
        best = min(best, time.time() - t0)
    print(f"  {label:<42s} {best * 1e3:9.1f} ms", file=sys.stderr)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=25000)
    ap.add_argument("--genome", type=int, default=40,
                    help="bench genome size in Mbp: 40 (full SA, LUT-only)"
                         " or 250 (sampled SA + FM extension steps)")
    ap.add_argument("--k", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from soap3dp_tpu.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()
    import bench
    from soap3dp_tpu.fm import fmindex
    from soap3dp_tpu.fm.search import SearchConfig, search_reads
    from soap3dp_tpu.kernels.banded_dp import DPScores, dp_forward, dp_traceback
    from soap3dp_tpu.pipeline import hits as hitmod
    from soap3dp_tpu.pipeline.options import AlignOptions
    from soap3dp_tpu.pipeline.pair import pair_hits

    print(f"devices: {jax.devices()}", file=sys.stderr)
    if args.genome == 40:
        index, codes = bench.get_index(40_000_000, sa_rate=1, lut_k=14)
    else:
        index, codes = bench.get_index(args.genome * 1_000_000,
                                       sa_rate=4, lut_k=13)
    t0 = time.time()
    didx = fmindex.device_index(index)
    _sync(didx.occ)
    print(f"  index upload: {time.time() - t0:.2f}s", file=sys.stderr)

    rng = np.random.default_rng(5)
    b1, b2 = bench.make_pairs(codes, args.pairs, rng)
    B = args.pairs
    lens = jnp.full(B, bench.READ_LEN, jnp.int32)
    cfg = SearchConfig(k=args.k, occ_cap=16)

    print(f"batch = {B} pairs ({2 * B} reads x {bench.READ_LEN}bp)",
          file=sys.stderr)
    r1 = jnp.asarray(b1.codes)
    h = t("search end1 (seed+decode+verify+dedupe)",
          lambda: search_reads(didx, r1, lens, cfg))

    # host post-processing
    t0 = time.time()
    table = hitmod.hits_to_table(h, B, index, b1.lens)
    print(f"  {'host hits_to_table':<42s} {(time.time() - t0) * 1e3:9.1f} ms",
          file=sys.stderr)
    t0 = time.time()
    st = hitmod.read_stats(table, B)
    opts = AlignOptions()
    combos = pair_hits(table, table, B, b1.lens, b2.lens, opts)
    print(f"  {'host stats+pairing':<42s} {(time.time() - t0) * 1e3:9.1f} ms",
          file=sys.stderr)

    # DP stage at a realistic rescue rate (~3% of pairs)
    P = max(B // 16, 512)
    Lr, Lw = bench.READ_LEN, bench.READ_LEN + 2 * (bench.READ_LEN >> 2)
    wins = rng.integers(0, 4, (P, Lw)).astype(np.uint8)
    dpreads = wins[:, 10:10 + Lr].copy()
    dargs = (jnp.asarray(dpreads), jnp.full(P, Lr, jnp.int32),
             jnp.asarray(wins), jnp.full(P, Lw, jnp.int32),
             jnp.full(P, 49, jnp.int32), jnp.full(P, 49, jnp.int32),
             jnp.full(P, Lw + 1, jnp.int32), jnp.zeros(P, jnp.int32))
    fwd = t(f"dp_forward ({P} problems {Lr}x{Lw})",
            lambda: dp_forward(*dargs, sc=DPScores()))
    bS, bI, bJ, bC, dirs = fwd
    t(f"dp_traceback ({P} problems)",
      lambda: dp_traceback(dirs, dargs[0], dargs[1], dargs[2], bI, bJ,
                           dargs[4], jnp.ones(P, bool)))

    # SA decode microbench
    M = 1 << 17
    rows = jnp.asarray(rng.integers(0, index.n, M).astype(np.uint32))
    t(f"sa_decode ({M} rows, rate {index.sa_rate})",
      lambda: fmindex.sa_decode(didx, rows, jnp.ones(M, bool)))
    # raw occ microbench
    ks = jnp.asarray(rng.integers(0, index.n, M).astype(np.uint32))
    cs = jnp.asarray(rng.integers(0, 4, M).astype(np.uint32))
    occ_j = jax.jit(lambda c, k: fmindex.occ(didx, c, k))
    t(f"occ x{M}", occ_j, cs, ks)


if __name__ == "__main__":
    main()
