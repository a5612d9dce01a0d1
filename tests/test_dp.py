"""Wavefront DP engine vs the scalar-semantics oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from soap3dp_tpu.kernels import banded_dp
from soap3dp_tpu.kernels.banded_dp import DPScores, dp_forward, dp_traceback
from tests import dp_oracle

SC = DPScores()
SCORES = (SC.match, SC.mismatch, SC.gap_open, SC.gap_ext)

OPCH = {banded_dp.OP_MATCH: "M", banded_dp.OP_MISMATCH: "m",
        banded_dp.OP_INS: "I", banded_dp.OP_DEL: "D", banded_dp.OP_CLIP: "S"}


def runs_from_oracle(pat):
    runs = []
    for p in pat:
        op, n = (p if isinstance(p, tuple) else (p, 1))
        if n == 0:
            continue
        if runs and runs[-1][0] == op:
            runs[-1][1] += n
        else:
            runs.append([op, n])
    return [(o, n) for o, n in runs]


def runs_from_engine(ops, cnts, nrun, p):
    return [(OPCH[int(ops[p, r])], int(cnts[p, r])) for r in range(int(nrun[p]))
            if int(cnts[p, r]) > 0]


def mutate(rng, seq, nsub, nins, ndel):
    out = list(seq)
    for _ in range(ndel):
        if len(out) > 4:
            del out[rng.integers(0, len(out))]
    for _ in range(nins):
        out.insert(rng.integers(0, len(out) + 1), rng.integers(0, 4))
    for _ in range(nsub):
        p = rng.integers(0, len(out))
        out[p] = (out[p] + rng.integers(1, 4)) % 4
    return np.asarray(out, dtype=np.uint8)


def make_problems(rng, P, Lr, Lw, with_anchor=False):
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = np.zeros((P, Lr), dtype=np.uint8)
    rlens = np.zeros(P, dtype=np.int32)
    for p in range(P):
        off = rng.integers(0, Lw // 3)
        span = rng.integers(Lr // 2, Lr)
        piece = mutate(rng, wins[p, off:off + span],
                       rng.integers(0, 4), rng.integers(0, 3), rng.integers(0, 3))
        piece = piece[:Lr]
        reads[p, :len(piece)] = piece
        rlens[p] = len(piece)
    clip_l = rng.integers(0, 6, size=P).astype(np.int32)
    clip_r = rng.integers(0, 6, size=P).astype(np.int32)
    if with_anchor:
        anchor_l = rng.integers(2, Lw, size=P).astype(np.int32)
        anchor_r = rng.integers(0, Lw // 2, size=P).astype(np.int32)
    else:
        anchor_l = np.full(P, Lw + 1, dtype=np.int32)
        anchor_r = np.zeros(P, dtype=np.int32)
    wlens = np.full(P, Lw, dtype=np.int32)
    return reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r


@pytest.mark.parametrize("with_anchor", [False, True])
def test_forward_matches_oracle(rng, with_anchor):
    P, Lr, Lw = 32, 24, 48
    prob = make_problems(rng, P, Lr, Lw, with_anchor)
    reads, rlens, wins, wlens, cl, cr, al, ar = prob
    bS, bI, bJ, bC, _ = dp_forward(*[jnp.asarray(x) for x in prob], sc=SC)
    bS, bI, bJ, bC = map(np.asarray, (bS, bI, bJ, bC))
    for p in range(P):
        H, Dt, best, cnt = dp_oracle.oracle_forward(
            reads[p, :rlens[p]], wins[p], cl[p], cr[p], al[p], ar[p], SCORES)
        assert bS[p] == best[0], p
        assert (bJ[p], bI[p]) == (best[1], best[2]), p
        assert bC[p] == cnt, p


@pytest.mark.parametrize("with_anchor", [False, True])
def test_traceback_matches_oracle(rng, with_anchor):
    P, Lr, Lw = 32, 24, 48
    prob = make_problems(rng, P, Lr, Lw, with_anchor)
    reads, rlens, wins, wlens, cl, cr, al, ar = prob
    jprob = [jnp.asarray(x) for x in prob]
    bS, bI, bJ, bC, dirs = dp_forward(*jprob, sc=SC)
    active = np.asarray(bS) >= 1  # only meaningful alignments
    ops, cnts, nrun, startj = dp_traceback(
        dirs, jprob[0], jprob[1], jprob[2], bI, bJ, jprob[4],
        jnp.asarray(active))
    ops, cnts, nrun, startj = map(np.asarray, (ops, cnts, nrun, startj))
    checked = 0
    for p in range(P):
        if not active[p]:
            continue
        H, Dt, best, cnt = dp_oracle.oracle_forward(
            reads[p, :rlens[p]], wins[p], cl[p], cr[p], al[p], ar[p], SCORES)
        pat, sj = dp_oracle.oracle_traceback(
            reads[p, :rlens[p]], wins[p], H, Dt, best, cl[p], al[p], SCORES)
        assert runs_from_engine(ops, cnts, nrun, p) == runs_from_oracle(pat), p
        assert startj[p] == sj, p
        # pattern must reproduce the score (clips free)
        assert dp_oracle.score_of_pattern(pat, SCORES) == best[0], p
        checked += 1
    assert checked > P // 2


def test_exact_read_aligns_perfectly(rng):
    """A read copied verbatim from the window: all-match, full score."""
    P, Lr, Lw = 8, 20, 40
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = wins[:, 5:5 + Lr].copy()
    args = (jnp.asarray(reads), jnp.full(P, Lr, jnp.int32), jnp.asarray(wins),
            jnp.full(P, Lw, jnp.int32), jnp.zeros(P, jnp.int32),
            jnp.zeros(P, jnp.int32), jnp.full(P, Lw + 1, jnp.int32),
            jnp.zeros(P, jnp.int32))
    bS, bI, bJ, bC, dirs = dp_forward(*args, sc=SC)
    assert np.all(np.asarray(bS) == Lr)
    assert np.all(np.asarray(bI) == Lr)
    ops, cnts, nrun, startj = dp_traceback(
        dirs, args[0], args[1], args[2], bI, bJ, args[4],
        jnp.ones(P, bool))
    assert np.all(np.asarray(startj) == 5)
    for p in range(P):
        assert runs_from_engine(np.asarray(ops), np.asarray(cnts),
                                np.asarray(nrun), p) == [("M", Lr)]


def scan_reference(args, cutoff):
    """dp_forward + dp_traceback on one batch: (stats, ops, cnts, nrun,
    startj, active) of the executable spec."""
    bS, bI, bJ, bC, dirs = banded_dp.dp_forward(*args, sc=SC)
    stats = np.stack([np.asarray(x) for x in (bS, bI, bJ, bC)], axis=1)
    active = stats[:, 0] >= cutoff
    ops, cnts, nrun, startj = dp_traceback(
        dirs, args[0], args[1], args[2], bI, bJ, args[4],
        jnp.asarray(active))
    return stats, ops, cnts, nrun, startj, active


def assert_kernel_matches_scan(args, cutoff, stats, runs, min_checked):
    """Fused-kernel outputs equal the scan path's, run for run."""
    sstats, r_ops, r_cnts, r_nrun, r_startj, active = scan_reference(
        args, cutoff)
    stats, runs = np.asarray(stats), np.asarray(runs)
    assert np.array_equal(stats[:, :4], sstats)
    assert not stats[:, 6].any(), "run budget overflow"
    checked = 0
    for p in range(len(cutoff)):
        if not active[p]:
            assert stats[p, 5] == 0
            continue
        assert stats[p, 4] == r_startj[p], p
        want = [(int(r_ops[p, r]), int(r_cnts[p, r]))
                for r in range(int(r_nrun[p])) if r_cnts[p, r] > 0]
        got = [(int(runs[p, r]) >> 12, int(runs[p, r]) & 0xFFF)
               for r in range(int(stats[p, 5])) if runs[p, r] & 0xFFF]
        assert got == want, p
        checked += 1
    assert checked >= min_checked


def kernel_interpret(args, cutoff, programs=None):
    P, Lr = args[0].shape
    pt = banded_dp.kernel_tile(P, Lr, args[2].shape[1], platform="gpu")
    assert pt is not None
    return banded_dp._dp_align_call(
        *args, jnp.asarray(cutoff), SC, pt=pt,
        mr=banded_dp._max_runs_bound(Lr), programs=programs, interpret=True)


@pytest.mark.parametrize("with_anchor", [False, True])
def test_fused_align_matches_scan_path(with_anchor):
    """The fused forward+traceback kernel (interpret mode) must produce
    byte-identical runs/stats to the scan + host-RLE reference path."""
    rng = np.random.default_rng(9)
    P, Lr, Lw = 64, 40, 70
    args = [jnp.asarray(x) for x in make_problems(rng, P, Lr, Lw, with_anchor)]
    cutoff = np.full(P, 10, np.int32)
    stats, runs = kernel_interpret(args, cutoff)
    assert_kernel_matches_scan(args, cutoff, stats, runs, P // 2 + 1)


@pytest.mark.parametrize("programs", [1, 3])
def test_fused_align_persistent_grid(programs):
    """Fewer programs than tiles: each program walks tiles g, g+G, ...
    reusing its direction scratch, and every tile still matches."""
    rng = np.random.default_rng(5)
    P, Lr, Lw = 40, 30, 64
    args = [jnp.asarray(x) for x in make_problems(rng, P, Lr, Lw, True)]
    cutoff = np.full(P, 8, np.int32)
    stats, runs = kernel_interpret(args, cutoff, programs=programs)
    assert_kernel_matches_scan(args, cutoff, stats, runs, P // 2)


def long_read_problems(rng, P, Lr, Lw, at, lo, clip):
    wins = rng.integers(0, 4, (P, Lw)).astype(np.uint8)
    reads = np.zeros((P, Lr), np.uint8)
    rlens = rng.integers(lo, Lr + 1, P).astype(np.int32)
    for p in range(P):
        reads[p, :rlens[p]] = wins[p, at:at + rlens[p]]
    reads[0, Lr // 5] = (reads[0, Lr // 5] + 1) % 4
    reads[1, Lr // 10:Lr * 4 // 5] = np.roll(
        reads[1, Lr // 10:Lr * 4 // 5], 3)            # indel-ish
    reads[2] = rng.integers(0, 4, Lr)                 # garbage, below cutoff
    return [jnp.asarray(x) for x in (
        reads, rlens, wins, np.full(P, Lw, np.int32),
        rng.integers(0, clip, P).astype(np.int32),
        rng.integers(0, clip, P).astype(np.int32),
        np.full(P, Lw + 1, np.int32), np.zeros(P, np.int32))]


def test_fused_align_long_reads_matches_scan():
    """256-lane state (reads up to 255bp) on the fused kernel."""
    rng = np.random.default_rng(17)
    P, Lr, Lw = 64, 200, 300
    args = long_read_problems(rng, P, Lr, Lw, 20, 150, 20)
    cutoff = np.full(P, 45, np.int32)  # 0.3 * min read length
    stats, runs = kernel_interpret(args, cutoff)
    assert_kernel_matches_scan(args, cutoff, stats, runs, P // 2 + 1)


def test_fused_align_512bp_matches_scan():
    """512bp reads on the fused kernel: a 1024-lane, one-problem tile
    (the reference's MAX_READ_LENGTH is 1024, definitions.h:38)."""
    rng = np.random.default_rng(23)
    P, Lr, Lw = 16, 512, 576
    args = long_read_problems(rng, P, Lr, Lw, 20, 480, 30)
    cutoff = np.full(P, 144, np.int32)  # 0.3 * min read length
    stats, runs = kernel_interpret(args, cutoff)
    assert_kernel_matches_scan(args, cutoff, stats, runs, P - 2)


def test_fused_align_1024bp_two_pass_matches_scan():
    """1024bp reads stay exact on the fused kernel: a 2048-lane state in
    one pass, directions in the program's own scratch region (no
    re-forward pass is needed)."""
    rng = np.random.default_rng(31)
    P, Lr, Lw = 8, 1024, 1100
    args = long_read_problems(rng, P, Lr, Lw, 30, 990, 40)
    cutoff = np.full(P, 297, np.int32)  # 0.3 * min read length
    stats, runs = kernel_interpret(args, cutoff)
    assert_kernel_matches_scan(args, cutoff, stats, runs, P - 1)


@pytest.mark.parametrize("shape,platform,n_shards,want", [
    ((1024, 100, 256), "gpu", 1, 4),      # 100bp: 128 lanes, 4 problems
    ((1024, 100, 640), "gpu", 4, 4),      # wide window, 4 shards
    ((1024, 40, 70), "gpu", 1, 8),        # 64 lanes: the largest tile
    ((64, 200, 300), "gpu", 1, 2),        # 256 lanes
    ((8, 1024, 1100), "gpu", 1, 1),       # 2048 lanes, one problem
    ((1024, 2048, 2100), "gpu", 1, None),  # 4096 lanes: scan
    ((1024, 100, 4096), "gpu", 1, None),  # run lengths need 13 bits: scan
    ((1030, 100, 256), "gpu", 1, None),   # tile does not divide P: scan
    ((1024, 100, 256), "gpu", 512, None),  # nor P / shards
    ((1024, 100, 256), "cpu", 1, None),   # not a GPU: scan
])
def test_kernel_tile_by_platform_and_shape(shape, platform, n_shards, want):
    P, Lr, Lw = shape
    assert banded_dp.kernel_tile(P, Lr, Lw, n_shards, platform) == want


def test_dp_align_off_gpu_takes_scan_and_counts(rng):
    """Off the GPU dp_align runs the scan path and counts the batch
    under "scan"; its results equal the scan reference."""
    P, Lr, Lw = 16, 24, 48
    prob = make_problems(rng, P, Lr, Lw)
    args = [jnp.asarray(x) for x in prob]
    cutoff = np.full(P, 6, np.int32)
    before = dict(banded_dp.dp_path_calls)
    score, hI, hJ, nbc, ops, cnts, nrun, startj, of = banded_dp.dp_align(
        *args, cutoff, sc=SC)
    assert banded_dp.dp_path_calls["scan"] == before.get("scan", 0) + 1
    assert banded_dp.dp_path_calls["kernel"] == before.get("kernel", 0)
    stats, r_ops, r_cnts, r_nrun, r_startj, active = scan_reference(
        args, cutoff)
    assert np.array_equal(np.stack([score, hI, hJ, nbc], 1), stats)
    assert np.array_equal(nrun, r_nrun) and not of.any()
    assert np.array_equal(startj[active], r_startj[active])


def test_max_runs_bound_is_a_power_of_two():
    for L in (1, 40, 100, 150, 300, 700, 1024):
        mr = banded_dp._max_runs_bound(L)
        assert mr >= banded_dp.MAX_RUNS and mr & (mr - 1) == 0
        assert mr >= 2 * (7 * L // 30) + 4


def test_fused_align_sharded_over_mesh():
    """On a 4-device mesh each device runs the kernel on its slice of
    the problem axis; the padded problem count splits into whole tiles
    per device, and the result equals the unsharded scan."""
    import jax

    from soap3dp_tpu.distributed import mesh as dmesh

    mesh = dmesh.make_mesh(jax.devices()[:4])
    M = dmesh.pad_to_mesh(mesh, 37, banded_dp.KERNEL_P_TILE)
    assert M % (4 * banded_dp.KERNEL_P_TILE) == 0
    rng = np.random.default_rng(41)
    Lr, Lw = 30, 64
    prob = make_problems(rng, M, Lr, Lw, True)
    pt = banded_dp.kernel_tile(M, Lr, Lw, 4, platform="gpu")
    assert pt is not None
    cutoff = np.full(M, 8, np.int32)
    sharded = [dmesh.shard_rows(mesh, np.asarray(x)) for x in prob]
    call = banded_dp._kernel_fn(SC, pt, banded_dp._max_runs_bound(Lr), mesh,
                                interpret=True)
    stats, runs = call(*sharded, dmesh.shard_rows(mesh, cutoff))
    assert_kernel_matches_scan([jnp.asarray(x) for x in prob], cutoff,
                               stats, runs, M // 2)


@pytest.mark.gpu
def test_fused_kernel_compiled_on_gpu_matches_scan(gpu):
    """The kernel as compiled for the card (no interpreter) equals the
    scan at the rescue width: 100 bp reads in 256 bp windows."""
    rng = np.random.default_rng(43)
    P, Lr, Lw = 1024, 100, 256
    args = [jnp.asarray(x) for x in make_problems(rng, P, Lr, Lw, True)]
    cutoff = np.full(P, 30, np.int32)
    pt = banded_dp.kernel_tile(P, Lr, Lw)
    assert pt is not None
    stats, runs = banded_dp._dp_align_call(
        *args, jnp.asarray(cutoff), SC, pt=pt,
        mr=banded_dp._max_runs_bound(Lr))
    assert_kernel_matches_scan(args, cutoff, stats, runs, P // 4)
