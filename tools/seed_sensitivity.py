"""Deep-DP seeding sensitivity: exact seeds vs halved (1-mismatch) seeds.

The reference seeds deep DP with a 1-mismatch GPU kernel
(single_1_mismatch_alignment2, alignment.cu:1839). The rebuild uses
exact staged seeds; the cheap batched 1-mismatch equivalent is searching
both exact halves of every seed (pigeonhole). This tool measures, on
reads mutated at a given substitution rate (the reads deep DP actually
sees: both ends >k mismatches):

  - per-end candidate recall: planted locus recovered by seeding
  - candidate volume (the DP-stage cost driver)
  - wall time of the seeding stage

Usage: python tools/seed_sensitivity.py [sub_rate=0.04] [n_reads=20000]
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main() -> int:
    sub_rate = float(sys.argv[1]) if len(sys.argv) > 1 else 0.04
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 20_000
    sys.path.insert(0, ".")
    import bench
    import jax

    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.pipeline import dp_rescue
    from soap3dp_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    index, codes = bench.get_index(40_000_000, sa_rate=1, lut_k=14)
    didx = device_index(index)
    jax.block_until_ready(didx.occ)
    codes = np.asarray(codes)

    L = 100
    rng = np.random.default_rng(5)
    pos = rng.integers(0, len(codes) - L, n_reads)
    reads = codes[pos[:, None] + np.arange(L)[None, :]].copy()
    mask = rng.random(reads.shape) < sub_rate
    reads[mask] = (reads[mask] + rng.integers(1, 4, int(mask.sum()))) % 4
    # keep only reads deep DP would see (>k mismatches)
    keep = mask.sum(axis=1) > 2
    reads, pos = reads[keep], pos[keep]
    lens = np.full(len(reads), L, np.int32)
    print(f"[sens] {len(reads)} reads with >2 mismatches "
          f"(sub rate {sub_rate})", file=sys.stderr)

    results = {}
    for name, halved in (("exact", False), ("halved-1mm", True)):
        sp, sl = dp_rescue.deep_dp_seed_matrix(lens, L, halved=halved)
        # warmup (compile)
        dp_rescue.seed_candidates(didx, reads[:1024], lens[:1024],
                                  sp[:1024], sl[:1024])
        t0 = time.time()
        cand = dp_rescue.seed_candidates(didx, reads, lens, sp, sl)
        dt = time.time() - t0
        margin = int(dp_rescue.dp_margin(np.asarray([L]))[0])
        ok = (cand.strand == 0) & (np.abs(cand.pos - pos[cand.read]) <= margin)
        recall = len(np.unique(cand.read[ok])) / len(reads)
        results[name] = (recall, len(cand.read), dt)
        print(f"[sens] {name:<12s} recall {recall:7.4f}  "
              f"candidates {len(cand.read):8d}  seeding {dt * 1000:7.1f} ms",
              file=sys.stderr)
    ex, hv = results["exact"], results["halved-1mm"]
    print(f"[sens] recall delta {hv[0] - ex[0]:+.4f}, "
          f"candidate ratio {hv[1] / max(ex[1], 1):.2f}x, "
          f"time ratio {hv[2] / max(ex[2], 1e-9):.2f}x", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
