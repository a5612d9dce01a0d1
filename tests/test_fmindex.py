"""FM-index JAX primitives vs brute-force oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.lib.stride_tricks import sliding_window_view

from soap3dp_tpu.fm import fmindex
from soap3dp_tpu.index.suffix_array import bwt_from_sa, suffix_array


def find_exact(text: np.ndarray, pat: np.ndarray) -> list[int]:
    """All positions where pat occurs in text (vectorized oracle)."""
    L = len(pat)
    if L > len(text):
        return []
    win = sliding_window_view(text, L)
    return np.flatnonzero(np.all(win == pat[None, :], axis=1)).tolist()


@pytest.fixture(scope="module")
def oracle(small_genome):
    codes = small_genome.codes
    sa = suffix_array(codes)
    bwt, primary = bwt_from_sa(codes, sa)
    return codes, sa, bwt, primary


def test_occ_matches_bruteforce(small_device_index, oracle, rng):
    codes, sa, bwt, primary = oracle
    n = len(codes)
    ks = rng.integers(0, n + 1, size=256).astype(np.uint32)
    cs = rng.integers(0, 4, size=256).astype(np.uint32)
    got = np.asarray(fmindex.occ(small_device_index, jnp.asarray(cs), jnp.asarray(ks)))
    for k, c, g in zip(ks, cs, got):
        kp = int(k) - (1 if k > primary else 0)
        assert g == np.sum(bwt[:kp] == c), (k, c)


def test_backward_search_exact(small_device_index, oracle, rng):
    """Interval of a pattern == brute-force positions where it occurs."""
    codes, sa, bwt, primary = oracle
    n = len(codes)
    B, L = 64, 30
    starts = rng.integers(0, n - L, size=B)
    seqs = np.stack([codes[s:s + L] for s in starts]).astype(np.uint8)
    # corrupt a few so they (probably) don't match anywhere
    seqs[:8] = rng.integers(0, 4, size=(8, L)).astype(np.uint8)

    l, r = fmindex.backward_search(
        small_device_index, jnp.asarray(seqs),
        jnp.zeros(B, jnp.int32), jnp.full((B,), L, jnp.int32), max_steps=L)
    l, r = np.asarray(l), np.asarray(r)

    for b in range(B):
        pat = seqs[b]
        hits = find_exact(codes, pat)
        width = max(0, int(r[b]) - int(l[b]))
        assert width == len(hits), b
        if hits:
            got = sorted(int(sa[row]) for row in range(int(l[b]), int(r[b])))
            assert got == hits


def test_backward_search_lut_consistency(small_device_index, oracle, rng):
    """LUT-jumpstarted search equals stepwise search."""
    codes, *_ = oracle
    n = len(codes)
    B, L = 32, 24
    starts = rng.integers(0, n - L, size=B)
    seqs = np.stack([codes[s:s + L] for s in starts]).astype(np.uint8)
    args = (jnp.asarray(seqs), jnp.zeros(B, jnp.int32), jnp.full((B,), L, jnp.int32))
    l1, r1 = fmindex.backward_search(small_device_index, *args, max_steps=L, use_lut=True)
    l2, r2 = fmindex.backward_search(small_device_index, *args, max_steps=L, use_lut=False)
    assert np.array_equal(np.asarray(l1), np.asarray(l2))
    assert np.array_equal(np.asarray(r1), np.asarray(r2))


def test_backward_search_segment(small_device_index, oracle, rng):
    """Searching a middle segment honors start/length."""
    codes, sa, *_ = oracle
    n = len(codes)
    B, L, s0, sl = 16, 40, 13, 17
    starts = rng.integers(0, n - L, size=B)
    seqs = np.stack([codes[s:s + L] for s in starts]).astype(np.uint8)
    l, r = fmindex.backward_search(
        small_device_index, jnp.asarray(seqs),
        jnp.full((B,), s0, jnp.int32), jnp.full((B,), sl, jnp.int32), max_steps=sl)
    l, r = np.asarray(l), np.asarray(r)
    for b in range(B):
        pat = seqs[b, s0:s0 + sl]
        hits = find_exact(codes, pat)
        assert int(r[b]) - int(l[b]) == len(hits)
        got = sorted(int(sa[row]) for row in range(int(l[b]), int(r[b])))
        assert got == sorted(hits)


def test_sa_decode(small_device_index, oracle, rng):
    codes, sa, *_ = oracle
    n = len(codes)
    rows = rng.integers(0, n + 1, size=512).astype(np.uint32)
    got = np.asarray(fmindex.sa_decode(
        small_device_index, jnp.asarray(rows), jnp.ones(512, bool)))
    assert np.array_equal(got, sa[rows])


def test_extract_genome_and_mismatches(small_device_index, oracle, rng):
    codes, *_ = oracle
    n = len(codes)
    M, L = 64, 50
    tps = rng.integers(0, n - L, size=M).astype(np.uint32)
    g = np.asarray(fmindex.extract_genome(small_device_index, jnp.asarray(tps), L))
    for i, tp in enumerate(tps):
        assert np.array_equal(g[i], codes[tp:tp + L]), i

    reads = np.stack([codes[tp:tp + L] for tp in tps]).astype(np.uint8)
    # plant known mismatches
    k = rng.integers(0, 4, size=M)
    for i in range(M):
        pos = rng.choice(L, size=k[i], replace=False)
        reads[i, pos] = (reads[i, pos] + rng.integers(1, 4, size=k[i])) % 4
    nm = np.asarray(fmindex.count_mismatches(
        small_device_index, jnp.asarray(tps), jnp.asarray(reads),
        jnp.full((M,), L, jnp.int32)))
    assert np.array_equal(nm, k)


def test_layout_safe_scans_match_native():
    """cumsum_1d/cummax_1d/nonzero_prefix (utils/scans.py) must agree
    with the native ops at sizes spanning the reshape boundaries —
    these replace XLA's 1-D lowerings whose trailing-dim-1 tiling
    blows up HBM at candidate-budget sizes (human-scale repeat runs)."""
    import jax.numpy as jnp

    from soap3dp_tpu.utils import scans

    rng = np.random.default_rng(33)
    for n in (7, 1024, 1025, 4096, 300_000, 2**21 + 13):
        x = rng.integers(-50, 50, n).astype(np.int32)
        assert np.array_equal(np.asarray(scans.cumsum_1d(jnp.asarray(x))),
                              np.cumsum(x)), n
        assert np.array_equal(np.asarray(scans.cummax_1d(jnp.asarray(x))),
                              np.maximum.accumulate(x)), n
        mask = rng.random(n) < 0.01
        for size in (16, 4096):
            want = np.full(size, -1, np.int64)
            nz = np.flatnonzero(mask)[:size]
            want[: len(nz)] = nz
            got = np.asarray(scans.nonzero_prefix(jnp.asarray(mask), size))
            assert np.array_equal(got, want), (n, size)
