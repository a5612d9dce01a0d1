"""Element-gather cost vs table size on the current JAX device.

If random u32 element gathers get more expensive past some table size
(TLB/page behavior), that taxes the large LUT tables of a lut_k=14
index and the 3.1 GB occ table at human scale — and the fix
(splitting/sharding hot tables) applies to both.

Usage: python tools/gather_microbench.py [n_queries]
Prints ns/element for random gathers from tables of increasing size.
"""

from __future__ import annotations

import sys
import time
from functools import partial

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp

    nq = int(sys.argv[1]) if len(sys.argv) > 1 else 4_000_000
    print(f"[gather] device: {jax.devices()[0]}, queries/size: {nq}")

    @partial(jax.jit, static_argnames=())
    def do_gather(tbl, idxs):
        # 4 dependent rounds so latency can't hide behind one launch
        acc = jnp.zeros_like(idxs)
        for _ in range(4):
            v = jnp.take(tbl, ((idxs ^ acc) % tbl.shape[0]).astype(jnp.int32))
            acc = acc + v
        return acc.sum()

    rng = np.random.default_rng(3)
    idxs_h = rng.integers(0, 1 << 30, nq, dtype=np.int64).astype(np.uint32)
    idxs = jnp.asarray(idxs_h)

    for n_elems in (1 << 22, 1 << 24, 1 << 26, 1 << 27, 1 << 28,
                    3 * (1 << 27), 1 << 29, 3 * (1 << 28)):
        gb = n_elems * 4 / 1e9
        try:
            tbl = jnp.arange(n_elems, dtype=jnp.uint32)
            jax.block_until_ready(do_gather(tbl, idxs))  # warm
            times = []
            for _ in range(3):
                t0 = time.time()
                jax.block_until_ready(do_gather(tbl, idxs))
                times.append(time.time() - t0)
            dt = min(times)
            print(f"[gather] table {gb:6.2f} GB: {dt * 1e9 / (4 * nq):7.2f} "
                  f"ns/elem  ({dt * 1000:.1f} ms for {4 * nq / 1e6:.0f}M)")
            del tbl
        except Exception as e:  # noqa: BLE001 — report and continue
            print(f"[gather] table {gb:6.2f} GB: FAILED ({type(e).__name__}: "
                  f"{str(e)[:120]})")
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
