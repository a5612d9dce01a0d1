"""Batched semi-global affine-gap DP: anti-diagonal wavefront + traceback.

Replaces the reference's per-thread full-table DP (SemiGlobalAligntment
/ GPUBacktrack, DV-DPfunctions.cu:146-512), which fills the (read x
window) table cell by cell in one CUDA thread per problem. Here a batch
of problems advances one anti-diagonal per step, each step a full-width
(P, Lr+1) vector operation with no divergence:

    H[i,j] = max(H[i-1,j-1] + subst, D[i,j], I[i,j])
    D[i,j] = max(H[i,j-1] + open, D[i,j-1] + ext)     # window gap
    I[i,j] = max(H[i-1,j] + open, I[i-1,j] + ext, fresh)  # read gap

where cells on anti-diagonal d = i + j depend only on diagonals d-1 and
d-2. Semantics (clip/anchor rules, tie-breaks, traceback priorities)
exactly match the reference; tests/dp_oracle.py is the executable spec.

Instead of re-deriving the path from scores like GPUBacktrack, the
forward pass emits a direction byte per cell (priorities baked in:
diag > D-open > D-ext > clip-SM > clip-SI > I-open > I-ext), and the
traceback walks the direction bytes.

Two implementations share those semantics: ``dp_forward`` +
``dp_traceback`` (lax.scan, the executable spec, every platform) and
``_dp_align_call`` (a Pallas kernel on the Triton route that fuses
forward, traceback and CIGAR run-length encoding, GPU only).
``dp_align`` picks one by platform and shape.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from soap3dp_tpu.utils import shapes

NEG = -32000      # DP_SCORE_NEG_INFINITY (DV-DPfunctions.cu:52)
NEG_BIG = -(1 << 20)  # masking value, far below any reachable score

# direction encodings
DH_DIAG, DH_D, DH_SM, DH_I = 0, 1, 2, 3
DD_OPEN, DD_EXT = 0, 1
DI_FRESH, DI_OPEN, DI_EXT = 0, 1, 2

# traceback op codes
OP_NONE, OP_MATCH, OP_MISMATCH, OP_INS, OP_DEL, OP_CLIP = 0, 1, 2, 3, 4, 5
OP_CHARS = {OP_MATCH: "M", OP_MISMATCH: "m", OP_INS: "I", OP_DEL: "D", OP_CLIP: "S"}


@dataclasses.dataclass(frozen=True)
class DPScores:
    """Scoring scheme (soap3-dp.ini [DP]: 1 / -2 / -3 / -1 defaults)."""

    match: int = 1
    mismatch: int = -2
    gap_open: int = -3   # cost of a length-1 gap
    gap_ext: int = -1

    @property
    def gap_init(self) -> int:
        return self.gap_open - self.gap_ext


def _clamp(x):
    return jnp.maximum(x, NEG)


def _shift(v):
    """v[..., i] -> v[..., i-1]; lane 0 filled with NEG_BIG."""
    return jnp.concatenate(
        [jnp.full(v.shape[:-1] + (1,), NEG_BIG, v.dtype), v[..., :-1]], axis=-1)


@partial(jax.jit, static_argnames=("sc",))
def dp_forward(
    reads: jax.Array,    # (P, Lr) uint8 codes
    rlens: jax.Array,    # (P,) int32
    wins: jax.Array,     # (P, Lw) uint8 codes
    wlens: jax.Array,    # (P,) int32
    clip_l: jax.Array,   # (P,) int32 max free left soft-clip
    clip_r: jax.Array,   # (P,) int32 max free right soft-clip
    anchor_l: jax.Array,  # (P,) int32: window start must be < anchor_l (1-based)
    anchor_r: jax.Array,  # (P,) int32: window end must be >= anchor_r (1-based)
    sc: DPScores = DPScores(),
):
    """Returns (best_score, hit_i, hit_j, count, dirs).

    hit_i/hit_j are 1-based end coordinates of the best cell (read chars
    consumed = hit_i, i.e. right clip = rlen - hit_i; window chars
    consumed = hit_j). count = number of eligible cells achieving the
    best score (the reference's maxScoreCount). dirs has shape
    (Lr+Lw, P, Lr+1) uint8 — direction byte of each cell, diag-major.
    """
    P, Lr = reads.shape
    Lw = wins.shape[1]
    m, mm, go, ge, gi = sc.match, sc.mismatch, sc.gap_open, sc.gap_ext, sc.gap_init
    i_vec = jnp.arange(Lr + 1, dtype=jnp.int32)[None, :]           # (1, Lr+1)
    reads_pad = jnp.concatenate(
        [jnp.zeros((P, 1), reads.dtype), reads], axis=1).astype(jnp.int32)

    # column j=0 (free start / clipped-prefix inits)
    col0_raw = jnp.where(i_vec == 0, 0,
                         jnp.where(i_vec <= clip_l[:, None], go,
                                   gi + ge * (i_vec - jnp.minimum(clip_l[:, None], i_vec))))
    col0_H = _clamp(col0_raw)
    col0_D = _clamp(col0_raw + gi)

    h0 = jnp.full((P, Lr + 1), NEG_BIG, jnp.int32).at[:, 0].set(0)
    d0 = jnp.full((P, Lr + 1), NEG_BIG, jnp.int32).at[:, 0].set(_clamp(jnp.int32(gi)))
    i0 = jnp.full((P, Lr + 1), NEG_BIG, jnp.int32)
    hm1 = jnp.full((P, Lr + 1), NEG_BIG, jnp.int32)
    chars0 = jnp.full((P, Lr + 1), -1, jnp.int32)

    best0 = (jnp.full((P,), NEG, jnp.int32), jnp.zeros((P,), jnp.int32),
             jnp.zeros((P,), jnp.int32), jnp.zeros((P,), jnp.int32))

    def step(carry, d):
        H1, H2, D1, I1, chars, (bS, bJ, bI, bC) = carry
        j_vec = d - i_vec                                           # (1, Lr+1)
        # window char entering this diagonal at lane 0: win[:, d-1]
        newc = jnp.take_along_axis(
            wins, jnp.clip(d - 1, 0, Lw - 1)[None, None].repeat(P, 0), axis=1
        )[:, 0].astype(jnp.int32)
        chars = jnp.concatenate([newc[:, None], chars[:, :-1]], axis=1)

        init_j = jnp.where(j_vec < anchor_l[:, None], 0, NEG)
        init_jm1 = jnp.where(j_vec - 1 < anchor_l[:, None], 0, NEG)
        fresh_ok = (i_vec - 1) <= clip_l[:, None]

        dist = jnp.where(chars == reads_pad, m, mm)

        # D state: gap in the read (window char consumed), deps at (i, j-1)
        d_open = go + H1
        d_ext = ge + D1
        D_new = _clamp(jnp.maximum(d_open, d_ext))
        dD = (d_ext > d_open).astype(jnp.int32)                     # tie -> open

        # I state: gap in the window (read char consumed), deps at (i-1, j)
        H1s, I1s, H2s = _shift(H1), _shift(I1), _shift(H2)
        i_fresh = jnp.where(fresh_ok, init_j + go, NEG_BIG)
        i_open = go + H1s
        i_ext = ge + I1s
        I_new = _clamp(jnp.maximum(i_fresh, jnp.maximum(i_open, i_ext)))
        dI = jnp.where(I_new == i_fresh, DI_FRESH,
                       jnp.where(I_new == i_open, DI_OPEN, DI_EXT))

        # H state
        diag_true = dist + H2s
        diag_fresh = jnp.where(fresh_ok, init_jm1 + dist, NEG_BIG)
        H_new = _clamp(jnp.maximum(jnp.maximum(diag_true, diag_fresh),
                                   jnp.maximum(D_new, I_new)))
        dH = jnp.where(H_new == diag_true, DH_DIAG,
                       jnp.where((H_new == d_open) | (H_new == d_ext), DH_D,
                                 jnp.where(H_new == diag_fresh, DH_SM, DH_I)))

        # boundary lanes: i == d is column j=0; lane 0 is row i=0
        on_col0 = i_vec == d
        H_new = jnp.where(on_col0, col0_H, H_new)
        D_new = jnp.where(on_col0, col0_D, D_new)
        I_new = jnp.where(on_col0, NEG_BIG, I_new)
        H_new = H_new.at[:, 0].set(_clamp(init_j[:, 0]))
        D_new = D_new.at[:, 0].set(NEG_BIG)
        I_new = I_new.at[:, 0].set(_clamp(init_j[:, 0] + gi))

        # bit 5 = "this cell's read/window chars match": lets the
        # traceback classify M vs m without touching reads/wins again
        dirs = (dH | (dD << 2) | (dI << 3)
                | ((chars == reads_pad).astype(jnp.int32) << 5)).astype(jnp.uint8)

        # best-cell tracking over eligible cells
        elig = ((i_vec >= 1) & (i_vec <= rlens[:, None]) & (j_vec >= 1)
                & (j_vec <= wlens[:, None])
                & (i_vec >= (rlens - clip_r)[:, None])
                & (j_vec >= anchor_r[:, None]))
        escore = jnp.where(elig, H_new, NEG_BIG)
        s_star = escore.max(axis=1)
        # among ties within the diagonal prefer the largest i (smallest j)
        i_star = jnp.where(escore == s_star[:, None], i_vec, -1).max(axis=1)
        j_star = d - i_star
        c_star = (escore == s_star[:, None]).sum(axis=1, dtype=jnp.int32)
        better = (s_star > bS) | (
            (s_star == bS) & ((j_star < bJ) | ((j_star == bJ) & (i_star < bI))))
        equal = (s_star == bS)
        bC = jnp.where(better, c_star, jnp.where(equal, bC + c_star, bC))
        bS = jnp.where(better, s_star, bS)
        bJ = jnp.where(better, j_star, bJ)
        bI = jnp.where(better, i_star, bI)

        return (H_new, H1, D_new, I_new, chars, (bS, bJ, bI, bC)), dirs

    ds = jnp.arange(1, Lr + Lw + 1, dtype=jnp.int32)
    (_, _, _, _, _, best), dirs = jax.lax.scan(
        step, (h0, hm1, d0, i0, chars0, best0), ds)
    bS, bJ, bI, bC = best
    return bS, bI, bJ, bC, dirs


@jax.jit
def _traceback_scan(
    dirs: jax.Array,     # (ND, P, Lr+1) uint8 from dp_forward
    hit_i: jax.Array,    # (P,) int32 (1-based)
    hit_j: jax.Array,    # (P,) int32 (1-based)
    active: jax.Array,   # (P,) bool
):
    """Device half of the traceback: one reverse sweep over diagonals.

    Instead of a data-dependent walk with one scattered HBM gather per
    move (the shape of GPUBacktrack, DV-DPfunctions.cu:316-512), this
    scans diagonals d = ND..1 so each step streams one (P, Lr+1) dirs
    row sequentially; a problem at diagonal d takes its move via a
    one-hot lane select (a VPU multiply-reduce, no gather) and problems
    on other diagonals idle. Every move lowers i+j by 1 or 2, so one
    sweep retires every lane. Emits one op per step per problem
    (OP_NONE when idle); run-length encoding happens on the host.
    """
    ND, P, Lr1 = dirs.shape
    N, DCH, ICH = 0, 1, 2
    lane = jnp.arange(Lr1, dtype=jnp.int32)[None, :]

    def step(carry, xs):
        d, dirs_d = xs                    # dirs_d = dirs[d-1]: (P, Lr1)
        i, j, state, done, startj, clip = carry
        act = ~done & (i > 0) & (j > 0) & (i + j == d)
        oh = lane == i[:, None]
        byte = jnp.where(oh, dirs_d.astype(jnp.int32), 0).sum(axis=1)
        dH = byte & 3
        dD = (byte >> 2) & 1
        dI = (byte >> 3) & 3
        mop = jnp.where((byte >> 5) & 1, OP_MATCH, OP_MISMATCH)

        do_diag = act & (state == N) & (dH == DH_DIAG)
        do_sm = act & (state == N) & (dH == DH_SM)
        do_d = act & ((state == DCH) | ((state == N) & (dH == DH_D)))
        do_i = act & ((state == ICH) | ((state == N) & (dH == DH_I)))
        i_fresh = do_i & (dI == DI_FRESH)

        op = jnp.where(act,
                       jnp.where(do_diag | do_sm, mop,
                                 jnp.where(do_d, OP_DEL, OP_INS)),
                       OP_NONE).astype(jnp.int8)

        ni = jnp.where(do_diag | (do_i & ~i_fresh), i - 1, i)
        nj = jnp.where(do_diag | do_sm | do_d, j - 1, j)
        nstate = jnp.where(act,
                           jnp.where(do_d, jnp.where(dD == DD_OPEN, N, DCH),
                                     jnp.where(do_i & ~i_fresh,
                                               jnp.where(dI == DI_OPEN, N, ICH), N)),
                           state)
        exit_now = do_sm | i_fresh
        clip = jnp.where(exit_now, i - 1, clip)
        startj = jnp.where(do_sm, j - 1, jnp.where(i_fresh, j, startj))
        done = done | exit_now
        i = jnp.where(act, ni, i)
        j = jnp.where(act, nj, j)
        return (i, j, nstate, done, startj, clip), op

    init = (jnp.where(active, hit_i, 0), jnp.where(active, hit_j, 0),
            jnp.zeros((P,), jnp.int32), ~active,
            jnp.zeros((P,), jnp.int32), jnp.zeros((P,), jnp.int32))
    ds = jnp.arange(1, ND + 1, dtype=jnp.int32)
    (i, j, state, done, startj, clip), opseq = jax.lax.scan(
        step, init, (ds, dirs), reverse=True)
    meta = jnp.stack([i, j, done.astype(jnp.int32), startj, clip])
    return opseq, meta


@jax.jit
def _gather_opseq_rows(opseq, idx):
    """(ND, P) op sequence -> (len(idx), ND) rows, one executable
    (eager transpose+gather dispatched ~6 tiny executables)."""
    return jnp.transpose(opseq)[idx]


@jax.jit
def _stack4(a, b, c, d):
    return jnp.stack([a, b, c, d])


def dp_traceback(
    dirs: jax.Array,     # (Lr+Lw, P, Lr+1) uint8 from dp_forward
    reads: jax.Array,    # (P, Lr) uint8 (interface compat; match bit is in dirs)
    rlens: jax.Array,    # (P,) int32
    wins: jax.Array,     # (P, Lw) uint8 (interface compat)
    hit_i: jax.Array,    # (P,) int32 (1-based)
    hit_j: jax.Array,    # (P,) int32 (1-based)
    clip_l: jax.Array,   # (P,) int32
    active: jax.Array,   # (P,) bool — lanes worth tracing (score >= cutoff)
):
    """Traceback: device diagonal sweep + host run-length encoding.

    Returns (ops, counts, nruns, start_j): ops/counts are (P, MAXRUNS)
    numpy arrays in right-to-left order (first run is the right clip);
    start_j is the 0-based window offset where the alignment starts.
    """
    del reads, wins  # match/mismatch is carried in dirs bit 5
    ND, P, Lr1 = dirs.shape
    opseq, meta = _traceback_scan(
        dirs, jnp.asarray(hit_i), jnp.asarray(hit_j), jnp.asarray(active))
    meta = np.asarray(meta)  # one packed (5, P) transfer
    i, j, done = meta[0], meta[1], meta[2].astype(bool)
    startj, clip = meta[3].copy(), meta[4].copy()
    active = np.asarray(active)
    rlens_h = np.asarray(rlens)
    hit_i_h = np.asarray(hit_i)

    # boundary exits (walk ran off the window/read edge)
    at_j0 = active & ~done & (j == 0) & (i > 0)
    scl = np.minimum(np.asarray(clip_l), i)
    ins_tail = np.where(at_j0, i - scl, 0)
    clip = np.where(at_j0, scl, clip)
    startj = np.where(at_j0, 0, startj)
    at_i0 = active & ~done & (i == 0)
    startj = np.where(at_i0, j, startj)

    # most lanes usually fail the score cutoff and were never traced:
    # gather only the active rows on device before the big transfer and
    # the host RLE (bucketed so the gather executable is reused)
    pass_idx = np.flatnonzero(active)
    if len(pass_idx) == 0:
        return (np.zeros((P, 1), np.int32), np.zeros((P, 1), np.int32),
                np.zeros(P, np.int32), startj)
    nb = min(shapes.bucket(len(pass_idx), min_size=256), P)
    idx_pad = pass_idx if len(pass_idx) >= nb else \
        np.pad(pass_idx, (0, nb - len(pass_idx)))
    sub = np.asarray(_gather_opseq_rows(opseq, jnp.asarray(idx_pad[:nb])))
    S = sub[: len(pass_idx), ::-1]                    # (npass, ND) emission order
    rclip = (rlens_h - hit_i_h)[pass_idx]
    ops_s, cnts_s, nrun_s = _rle_runs(
        S, rclip, ins_tail[pass_idx], clip[pass_idx])
    MR = ops_s.shape[1]
    ops = np.zeros((P, MR), np.int32)
    cnts = np.zeros((P, MR), np.int32)
    nrun = np.zeros(P, np.int32)
    ops[pass_idx] = ops_s
    cnts[pass_idx] = cnts_s
    nrun[pass_idx] = nrun_s
    return ops, cnts, nrun, startj


def _rle_runs(S: np.ndarray, rclip: np.ndarray, ins_tail: np.ndarray,
              lclip: np.ndarray):
    """Run-length encode per-problem op streams into dense (P, MR) arrays.

    S is (P, ND) move ops (OP_NONE = idle step); rclip/ins_tail/lclip
    are per-problem counts for the bracketing runs.
    """
    P, ND = S.shape
    rows_m, cols_m = np.nonzero(S != OP_NONE)
    vals_m = S[rows_m, cols_m].astype(np.int32)
    cnt_m = np.ones(len(rows_m), np.int64)

    def seg(counts, op, segid):
        r = np.flatnonzero(counts > 0)
        return (r, np.full(len(r), segid, np.int8),
                np.zeros(len(r), np.int64),
                np.full(len(r), op, np.int32), counts[r].astype(np.int64))

    r0, s0, p0, v0, c0 = seg(np.asarray(rclip), OP_CLIP, 0)
    r2, s2, p2, v2, c2 = seg(np.asarray(ins_tail), OP_INS, 2)
    r3, s3, p3, v3, c3 = seg(np.asarray(lclip), OP_CLIP, 3)
    rows = np.concatenate([r0, rows_m, r2, r3])
    segs = np.concatenate([s0, np.ones(len(rows_m), np.int8), s2, s3])
    poss = np.concatenate([p0, cols_m, p2, p3])
    vals = np.concatenate([v0, vals_m, v2, v3])
    cnts = np.concatenate([c0, cnt_m, c2, c3])
    order = np.lexsort((poss, segs, rows))
    rows, vals, cnts = rows[order], vals[order], cnts[order]

    if len(rows) == 0:
        return (np.zeros((P, 1), np.int32), np.zeros((P, 1), np.int32),
                np.zeros(P, np.int32))
    change = np.concatenate(
        [[True], (vals[1:] != vals[:-1]) | (rows[1:] != rows[:-1])])
    runid = np.cumsum(change) - 1
    ops_r = vals[change]
    rows_r = rows[change]
    cnts_r = np.bincount(runid, weights=cnts).astype(np.int32)
    nrun = np.bincount(rows_r, minlength=P).astype(np.int32)
    MR = max(int(nrun.max()), 1)
    first = np.concatenate([[0], np.cumsum(nrun)[:-1]])
    col = np.arange(len(ops_r)) - first[rows_r]
    ops = np.zeros((P, MR), np.int32)
    cnts_d = np.zeros((P, MR), np.int32)
    ops[rows_r, col] = ops_r
    cnts_d[rows_r, col] = cnts_r
    return ops, cnts_d, nrun


# ------------------------------------------------------------------
# Fused forward + traceback + run-length encoding (Pallas, Triton route)
# ------------------------------------------------------------------

MAX_RUNS = 128          # run budget floor; see _max_runs_bound()
KERNEL_P_TILE = 8       # largest problem tile; every tile divides it
_TILE_CELLS = 512       # state cells (problems x lanes) one program holds
_MAX_LANES = 2048       # state lanes: next power of two >= read length + 1
_DIRS_BUDGET = 1 << 30  # direction-scratch bytes over all programs
# DP batches by path ("kernel", "scan", "overflow_redo"); read by
# chip_smoke.py to prove which path ran. Rescue flushes call dp_align
# from a worker thread too, hence the lock.
dp_path_calls: collections.Counter = collections.Counter()
_path_lock = threading.Lock()
_warned_scan_fallback = False


def _count(path: str) -> None:
    with _path_lock:
        dp_path_calls[path] += 1


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _max_runs_bound(max_read_len: int) -> int:
    """Upper bound on CIGAR runs for an alignment passing the 0.3*L
    cutoff: every non-match run costs >= 3 score (mismatch: lost match
    + penalty; gap: open), so #non-match runs <= 0.7L/3 and total runs
    <= 2*that + 3 bracketing runs (right clip, insert tail, left clip).
    Rounded up to a power of two (a Triton block dimension)."""
    return max(MAX_RUNS, _next_pow2(2 * (7 * max_read_len // 30) + 4))


def kernel_tile(P: int, Lr: int, Lw: int, n_shards: int = 1,
                platform: str | None = None) -> int | None:
    """Problems per program of the fused kernel for this batch shape,
    or None when the batch takes the scan path: off the GPU, reads of
    _MAX_LANES or more, windows of 4096 or more (run lengths are packed
    in 12 bits), or a problem count the tile does not split evenly over
    the shards."""
    if (platform or jax.default_backend()) != "gpu":
        return None
    L = _next_pow2(Lr + 1)
    if L > _MAX_LANES or Lw >= 4096:
        return None
    pt = min(KERNEL_P_TILE, max(1, _TILE_CELLS // L))
    if P % (pt * n_shards):
        return None
    return pt


def _dp_align_kernel(rlen_ref, wlen_ref, clipl_ref, clipr_ref, anchl_ref,
                     anchr_ref, cut_ref, reads_ref, wins_ref,
                     stats_ref, runs_ref, dirs_ref, shift_ref, *,
                     sc: DPScores, Lr: int, Lw: int, L: int, PT: int,
                     MR: int, n_tiles: int, interpret: bool):
    """Forward DP + traceback + CIGAR run-length encoding for tiles of
    PT problems; the same recurrences, tie-breaks and direction bytes as
    ``dp_forward`` and the same runs as ``dp_traceback``.

    Every ref is flat and indexed by computed offsets. One program walks
    its tiles (g, g+G, ...) through all Lr+Lw diagonals in a loop inside
    the block, the H/D state of a (PT, L) tile in registers. A lane
    needs its left neighbour's H and I from the previous diagonal, and
    a Triton block has no lane rotate, so each diagonal's H/I planes are
    stored to the program's own ``shift_ref`` slot (double-buffered by
    diagonal parity, one barrier per diagonal) and reloaded one lane
    over. The direction bytes go to the program's own ``dirs_ref``
    region, reused tile after tile, and the traceback gathers one byte
    per problem per move from it; only finished runs and 8 stats per
    problem reach the outputs.
    """
    m, mm, go, ge, gi = sc.match, sc.mismatch, sc.gap_open, sc.gap_ext, sc.gap_init
    ND = Lr + Lw
    PL = PT * L
    g = pl.program_id(0)
    G = pl.num_programs(0)
    i_vec = jax.lax.broadcasted_iota(jnp.int32, (PT, L), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (PT, L), 0)
    prow = jax.lax.broadcasted_iota(jnp.int32, (PT,), 0)
    mr_lane = jax.lax.broadcasted_iota(jnp.int32, (PT, MR), 1)
    is_lane0 = i_vec == 0
    plane = row * L + i_vec
    left = jnp.maximum(plane - 1, 0)     # lane i-1 (masked off at lane 0)
    sh_base = g * (4 * PL)               # [parity][H, I] planes
    dirs_prog = g * (PT * ND * L)
    dirs_fwd = dirs_prog + row * (ND * L) + i_vec   # + (d-1)*L
    dirs_tb = dirs_prog + prow * (ND * L)

    def barrier():
        if not interpret:   # the interpreter runs one thread
            plgpu.debug_barrier()

    def put_run(runs_ops, runs_cnts, ridx, of, flush, op, cnt):
        """One-hot append of a run at per-problem slot ridx."""
        oh = (mr_lane == ridx[:, None]) & flush[:, None]
        runs_ops = jnp.where(oh, op if jnp.ndim(op) == 0 else op[:, None],
                             runs_ops)
        runs_cnts = jnp.where(oh, cnt[:, None], runs_cnts)
        of = jnp.where(flush & (ridx >= MR), 1, of)
        ridx = jnp.where(flush, ridx + 1, ridx)
        return runs_ops, runs_cnts, ridx, of

    def tile(k, carry):
        p = (g + k * G) * PT + prow                      # (PT,) problem ids
        rlens, wlens, clip_l, clip_r, anchor_l, anchor_r, cutoff = (
            plgpu.load(r.at[p]) for r in (rlen_ref, wlen_ref, clipl_ref,
                                          clipr_ref, anchl_ref, anchr_ref,
                                          cut_ref))
        rl, wl, cl = rlens[:, None], wlens[:, None], clip_l[:, None]
        cr, al, ar = clip_r[:, None], anchor_l[:, None], anchor_r[:, None]
        pc = p[:, None]
        rd = plgpu.load(reads_ref.at[pc * Lr + jnp.clip(i_vec - 1, 0, Lr - 1)])
        reads_pad = jnp.where((i_vec >= 1) & (i_vec <= Lr),
                              rd.astype(jnp.int32), 0)
        wrow = pc * Lw

        col0_raw = jnp.where(i_vec == 0, 0,
                             jnp.where(i_vec <= cl, go,
                                       gi + ge * (i_vec - jnp.minimum(cl, i_vec))))
        col0_H = _clamp(col0_raw)
        col0_D = _clamp(col0_raw + gi)
        neg = jnp.full((PT, L), NEG_BIG, jnp.int32)
        h0 = jnp.where(is_lane0, 0, NEG_BIG)
        d0 = jnp.where(is_lane0, _clamp(jnp.int32(gi)), NEG_BIG)

        barrier()   # the previous tile's traceback is done with dirs_ref
        plgpu.store(shift_ref.at[sh_base + plane], h0)
        plgpu.store(shift_ref.at[sh_base + PL + plane], neg)
        barrier()

        def fwd_step(dm1, c):
            H1, H2s, D1, bS, bJ, bI, bC = c
            d = dm1 + 1
            src = sh_base + (dm1 & 1) * (2 * PL)
            H1s = plgpu.load(shift_ref.at[src + left], mask=~is_lane0,
                             other=NEG_BIG)
            I1s = plgpu.load(shift_ref.at[src + PL + left], mask=~is_lane0,
                             other=NEG_BIG)
            j_vec = d - i_vec
            wj = d - 1 - i_vec                           # window char j-1
            wc = plgpu.load(wins_ref.at[wrow + jnp.clip(wj, 0, Lw - 1)])
            chars = jnp.where(wj >= 0, wc.astype(jnp.int32), -1)

            init_j = jnp.where(j_vec < al, 0, NEG)
            init_jm1 = jnp.where(j_vec - 1 < al, 0, NEG)
            fresh_ok = (i_vec - 1) <= cl
            same = chars == reads_pad
            dist = jnp.where(same, m, mm)

            d_open = go + H1
            d_ext = ge + D1
            D_new = _clamp(jnp.maximum(d_open, d_ext))
            dD = (d_ext > d_open).astype(jnp.int32)

            i_fresh = jnp.where(fresh_ok, init_j + go, NEG_BIG)
            i_open = go + H1s
            i_ext = ge + I1s
            I_new = _clamp(jnp.maximum(i_fresh, jnp.maximum(i_open, i_ext)))
            dI = jnp.where(I_new == i_fresh, DI_FRESH,
                           jnp.where(I_new == i_open, DI_OPEN, DI_EXT))

            diag_true = dist + H2s
            diag_fresh = jnp.where(fresh_ok, init_jm1 + dist, NEG_BIG)
            H_new = _clamp(jnp.maximum(jnp.maximum(diag_true, diag_fresh),
                                       jnp.maximum(D_new, I_new)))
            dH = jnp.where(H_new == diag_true, DH_DIAG,
                           jnp.where((H_new == d_open) | (H_new == d_ext), DH_D,
                                     jnp.where(H_new == diag_fresh, DH_SM, DH_I)))

            on_col0 = i_vec == d
            H_new = jnp.where(on_col0, col0_H, H_new)
            D_new = jnp.where(on_col0, col0_D, D_new)
            I_new = jnp.where(on_col0, NEG_BIG, I_new)
            H_new = jnp.where(is_lane0, _clamp(init_j), H_new)
            D_new = jnp.where(is_lane0, NEG_BIG, D_new)
            I_new = jnp.where(is_lane0, _clamp(init_j + gi), I_new)

            byte = dH | (dD << 2) | (dI << 3) | (same.astype(jnp.int32) << 5)
            plgpu.store(dirs_ref.at[dirs_fwd + dm1 * L], byte.astype(jnp.uint8))
            dst = sh_base + (d & 1) * (2 * PL)
            plgpu.store(shift_ref.at[dst + plane], H_new)
            plgpu.store(shift_ref.at[dst + PL + plane], I_new)

            elig = ((i_vec >= 1) & (i_vec <= rl) & (j_vec >= 1)
                    & (j_vec <= wl) & (i_vec >= rl - cr) & (j_vec >= ar))
            escore = jnp.where(elig, H_new, NEG_BIG)
            s_star = escore.max(axis=1)
            hit = escore == s_star[:, None]
            # among ties within the diagonal prefer the largest i
            i_star = jnp.where(hit, i_vec, -1).max(axis=1)
            j_star = d - i_star
            c_star = hit.astype(jnp.int32).sum(axis=1)
            better = (s_star > bS) | (
                (s_star == bS) & ((j_star < bJ) | ((j_star == bJ) & (i_star < bI))))
            equal = s_star == bS
            bC = jnp.where(better, c_star, jnp.where(equal, bC + c_star, bC))
            bS = jnp.where(better, s_star, bS)
            bJ = jnp.where(better, j_star, bJ)
            bI = jnp.where(better, i_star, bI)
            barrier()   # this diagonal's H/I planes are complete
            return H_new, H1s, D_new, bS, bJ, bI, bC

        zv = jnp.zeros((PT,), jnp.int32)
        _, _, _, bS, bJ, bI, bC = jax.lax.fori_loop(
            0, ND, fwd_step, (h0, neg, d0, zv + NEG, zv, zv, zv))

        # ---- traceback: one move per problem per step, newest cell first
        N, DCH, ICH = 0, 1, 2
        active = bS >= cutoff
        runs0 = jnp.zeros((PT, MR), jnp.int32)
        rclip = jnp.maximum(rlens - bI, 0)
        runs_ops, runs_cnts, ridx, of = put_run(
            runs0, runs0, zv, zv, active & (rclip > 0), jnp.int32(OP_CLIP),
            rclip)
        i0 = jnp.where(active, bI, 0)
        j0 = jnp.where(active, bJ, 0)

        def tb_step(t, c):
            (i, j, state, done, startj, clipv, cur_op, cur_cnt,
             ridx, of, runs_ops, runs_cnts) = c
            act = (done == 0) & (i > 0) & (j > 0)
            byte = plgpu.load(
                dirs_ref.at[dirs_tb + jnp.maximum(i + j - 1, 0) * L + i],
                mask=act, other=0).astype(jnp.int32)
            dH = byte & 3
            dD = (byte >> 2) & 1
            dI = (byte >> 3) & 3
            mop = jnp.where((byte >> 5) & 1, OP_MATCH, OP_MISMATCH)

            do_diag = act & (state == N) & (dH == DH_DIAG)
            do_sm = act & (state == N) & (dH == DH_SM)
            do_d = act & ((state == DCH) | ((state == N) & (dH == DH_D)))
            do_i = act & ((state == ICH) | ((state == N) & (dH == DH_I)))
            i_fresh = do_i & (dI == DI_FRESH)
            op = jnp.where(do_diag | do_sm, mop,
                           jnp.where(do_d, OP_DEL, OP_INS))

            ni = jnp.where(do_diag | (do_i & ~i_fresh), i - 1, i)
            nj = jnp.where(do_diag | do_sm | do_d, j - 1, j)
            nstate = jnp.where(act,
                               jnp.where(do_d, jnp.where(dD == DD_OPEN, N, DCH),
                                         jnp.where(do_i & ~i_fresh,
                                                   jnp.where(dI == DI_OPEN, N, ICH),
                                                   N)),
                               state)
            exit_now = do_sm | i_fresh
            clipv = jnp.where(exit_now, i - 1, clipv)
            startj = jnp.where(do_sm, j - 1, jnp.where(i_fresh, j, startj))
            done = jnp.where(exit_now, 1, done)
            i = jnp.where(act, ni, i)
            j = jnp.where(act, nj, j)

            same = act & (op == cur_op)
            cur_cnt = jnp.where(same, cur_cnt + 1, cur_cnt)
            new_run = act & ~same
            runs_ops, runs_cnts, ridx, of = put_run(
                runs_ops, runs_cnts, ridx, of, new_run & (cur_cnt > 0),
                cur_op, cur_cnt)
            cur_op = jnp.where(new_run, op, cur_op)
            cur_cnt = jnp.where(new_run, 1, cur_cnt)
            return (i, j, nstate, done, startj, clipv, cur_op, cur_cnt,
                    ridx, of, runs_ops, runs_cnts)

        # every move lowers i + j, so max(i + j) steps retire the tile
        (i, j, _, done, startj, clipv, cur_op, cur_cnt, ridx, of,
         runs_ops, runs_cnts) = jax.lax.fori_loop(
            0, jnp.max(i0 + j0), tb_step,
            (i0, j0, zv, jnp.where(active, 0, 1), zv, zv, zv - 1, zv,
             ridx, of, runs_ops, runs_cnts))

        # boundary exits (walk ran off the window/read edge)
        at_j0 = active & (done == 0) & (j == 0) & (i > 0)
        scl = jnp.minimum(clip_l, i)
        ins_tail = jnp.where(at_j0, i - scl, 0)
        clipv = jnp.where(at_j0, scl, clipv)
        startj = jnp.where(at_j0, 0, startj)
        at_i0 = active & (done == 0) & (i == 0)
        startj = jnp.where(at_i0, j, startj)

        # final flush: current run, insert tail, left clip (an insert
        # tail merges into a trailing insert run, as the host RLE does)
        merge_ins = active & (cur_cnt > 0) & (ins_tail > 0) & (cur_op == OP_INS)
        cur_cnt = jnp.where(merge_ins, cur_cnt + ins_tail, cur_cnt)
        ins_tail = jnp.where(merge_ins, 0, ins_tail)
        runs_ops, runs_cnts, ridx, of = put_run(
            runs_ops, runs_cnts, ridx, of, active & (cur_cnt > 0),
            cur_op, cur_cnt)
        runs_ops, runs_cnts, ridx, of = put_run(
            runs_ops, runs_cnts, ridx, of, active & (ins_tail > 0),
            jnp.int32(OP_INS), ins_tail)
        runs_ops, runs_cnts, ridx, of = put_run(
            runs_ops, runs_cnts, ridx, of, active & (clipv > 0),
            jnp.int32(OP_CLIP), clipv)

        # each run packed as (op << 12 | cnt): half the result bytes;
        # cnt > 4095 cannot happen for windows < 4096 (kernel_tile
        # guards), the clamp + overflow flag keep it safe anyway
        of = jnp.where(runs_cnts.max(axis=1) > 4095, 1, of)
        for col, v in enumerate((bS, bI, bJ, bC, startj,
                                 jnp.minimum(ridx, MR), of, zv)):
            plgpu.store(stats_ref.at[p * 8 + col], v)
        plgpu.store(runs_ref.at[pc * MR + mr_lane],
                    (runs_ops << 12) | jnp.minimum(runs_cnts, 4095))
        return carry

    jax.lax.fori_loop(0, (n_tiles - g + G - 1) // G, tile, 0)


@partial(jax.jit, static_argnames=("sc", "pt", "mr", "programs", "interpret"))
def _dp_align_call(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                   anchor_r, cutoff, sc: DPScores, pt: int, mr: int,
                   programs: int | None = None, interpret: bool = False):
    """(P, 8) stats [score, hit_i, hit_j, n_best, startj, nrun, overflow,
    0] and (P, mr) packed runs from the fused kernel. ``programs`` caps
    the grid (default: as many as the direction-scratch budget allows,
    at most one per tile); ``interpret`` runs it on the CPU."""
    P, Lr = reads.shape
    Lw = wins.shape[1]
    L = _next_pow2(Lr + 1)
    ND = Lr + Lw
    n_tiles = P // pt
    G = programs or min(n_tiles, max(1, _DIRS_BUDGET // (pt * ND * L)))
    kernel = partial(_dp_align_kernel, sc=sc, Lr=Lr, Lw=Lw, L=L, PT=pt,
                     MR=mr, n_tiles=n_tiles, interpret=interpret)
    stats, runs, _, _ = pl.pallas_call(
        kernel,
        grid=(G,),
        out_shape=[
            jax.ShapeDtypeStruct((P * 8,), jnp.int32),
            jax.ShapeDtypeStruct((P * mr,), jnp.int32),
            jax.ShapeDtypeStruct((G * pt * ND * L,), jnp.uint8),   # dirs
            jax.ShapeDtypeStruct((G * 4 * pt * L,), jnp.int32),    # shift
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=4 if pt * L <= 1024 else 8, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="dp_align",
    )(*(jnp.asarray(a, jnp.int32) for a in (
        rlens, wlens, clip_l, clip_r, anchor_l, anchor_r, cutoff)),
      reads.reshape(-1), wins.reshape(-1))
    return stats.reshape(P, 8), runs.reshape(P, mr)


def _kernel_fn(sc: DPScores, pt: int, mr: int, mesh=None,
               interpret: bool = False):
    """The fused kernel as a function of dp_align's 9 device operands;
    with a mesh, every device runs it on its own slice of the problem
    axis (the problems are independent, and XLA cannot partition a
    custom call by itself)."""
    call = partial(_dp_align_call, sc=sc, pt=pt, mr=mr, interpret=interpret)
    if mesh is None:
        return call
    spec = jax.sharding.PartitionSpec(mesh.axis_names[0])
    return jax.shard_map(call, mesh=mesh, in_specs=(spec,) * 9,
                         out_specs=(spec, spec), check_vma=False)


@jax.jit
def _gather_runs_u16(runs: jax.Array, idx: jax.Array) -> jax.Array:
    return jnp.take(runs, idx, axis=0).astype(jnp.uint16)


def dp_align(
    reads: jax.Array,    # (P, Lr) uint8 codes (device)
    rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r,  # as dp_forward
    cutoff: np.ndarray,  # (P,) int32 score threshold (traceback gate)
    sc: DPScores = DPScores(),
    mesh=None,           # shard the problem axis over this mesh
):
    """Forward + traceback in one device dispatch; host-ready results.

    Returns numpy ``(score, hit_i, hit_j, n_best, ops, cnts, nrun,
    startj, overflow)``: ops/cnts are right-to-left CIGAR runs for every
    lane with score >= cutoff (others have nrun == 0). ``overflow``
    marks lanes whose run count exceeded the kernel budget (possible
    only for alignments far below the standard 0.3*L cutoff) — callers
    must treat those as failed and log them.

    On the GPU, batches the fused kernel takes (``kernel_tile``) run
    through it; every other batch takes the scan path.
    """
    P, Lr = reads.shape
    Lw = wins.shape[1]
    n_sh = mesh.devices.size if mesh is not None else 1
    pt = kernel_tile(P, Lr, Lw, n_sh)
    if pt is None:
        global _warned_scan_fallback
        if jax.default_backend() == "gpu" and not _warned_scan_fallback:
            _warned_scan_fallback = True
            print(f"[soap3dp] notice: a DP batch of {P} problems with reads "
                  f"of {Lr} and windows of {Lw} is outside the fused GPU "
                  "kernel's shapes (see kernel_tile); batches like it use "
                  "the slower scan path", file=sys.stderr)
        return _dp_align_scan(reads, rlens, wins, wlens, clip_l, clip_r,
                              anchor_l, anchor_r, cutoff, sc)
    _count("kernel")
    mr = _max_runs_bound(Lr)
    stats, runs = _kernel_fn(sc, pt, mr, mesh)(
        reads, jnp.asarray(rlens), wins, jnp.asarray(wlens),
        jnp.asarray(clip_l), jnp.asarray(clip_r), jnp.asarray(anchor_l),
        jnp.asarray(anchor_r), jnp.asarray(cutoff, jnp.int32))
    st = np.asarray(stats)                            # (P, 8), ~small
    score, nrun, startj = st[:, 0], st[:, 5], st[:, 4]
    ops = np.zeros((P, mr), np.int32)
    cnts = np.zeros((P, mr), np.int32)
    # transfer packed runs for the lanes that passed only (most
    # don't): bucketed device gather, u16 rows, one D2H transfer
    pass_idx = np.flatnonzero((score >= np.asarray(cutoff)) & (nrun > 0))
    if len(pass_idx):
        nb = min(shapes.bucket(len(pass_idx), min_size=256), P)
        idx_pad = pass_idx if len(pass_idx) >= nb else \
            np.pad(pass_idx, (0, nb - len(pass_idx)))
        sub = np.asarray(_gather_runs_u16(runs, jnp.asarray(idx_pad[:nb])))
        sub = sub[: len(pass_idx)].astype(np.int32)
        ops[pass_idx] = sub >> 12
        cnts[pass_idx] = sub & 0xFFF
    overflow = st[:, 6].astype(bool)
    redo = overflow & (score >= np.asarray(cutoff))
    if redo.any():
        # run budget exceeded (possible only for cutoffs below the 0.3*L
        # bound the budget is proven for): re-run those lanes through
        # the scan forward + host RLE instead of dropping valid alignments
        _count("overflow_redo")
        sel = np.flatnonzero(redo)
        nb = min(shapes.bucket(len(sel), min_size=64), P)
        sel_pad = np.pad(sel, (0, nb - len(sel))) if len(sel) < nb \
            else sel[:nb]
        g = jnp.asarray(sel_pad)
        ga = [jnp.asarray(a)[g] for a in
              (reads, rlens, wins, wlens, clip_l, clip_r,
               anchor_l, anchor_r)]
        _, bI, bJ, _, dirs = dp_forward(*ga, sc=sc)
        act = np.zeros(nb, bool)
        act[: len(sel)] = True
        o2, c2, n2, sj2 = dp_traceback(dirs, ga[0], ga[1], ga[2],
                                       bI, bJ, ga[4], jnp.asarray(act))
        if o2.shape[1] > ops.shape[1]:
            wide = o2.shape[1] - ops.shape[1]
            ops = np.pad(ops, ((0, 0), (0, wide)))
            cnts = np.pad(cnts, ((0, 0), (0, wide)))
        nrun, startj = nrun.copy(), startj.copy()
        ops[sel, : o2.shape[1]] = o2[: len(sel)]
        cnts[sel, : c2.shape[1]] = c2[: len(sel)]
        nrun[sel] = n2[: len(sel)]
        startj[sel] = sj2[: len(sel)]
        overflow = overflow & ~redo
    return (score, st[:, 1], st[:, 2], st[:, 3],
            ops, cnts, nrun, startj, overflow)


def _dp_align_scan(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                   anchor_r, cutoff, sc):
    """dp_align through the scan forward + scan traceback + host RLE
    (with a mesh, XLA partitions the scan over the sharded problem
    axis)."""
    _count("scan")
    bS, bI, bJ, bC, dirs = dp_forward(
        reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r, sc=sc)
    stats = np.asarray(_stack4(bS, bI, bJ, bC))
    score, hI, hJ, nbc = stats
    active = score >= np.asarray(cutoff)
    ops, cnts, nrun, startj = dp_traceback(
        dirs, reads, rlens, wins, hI, hJ, jnp.asarray(clip_l),
        jnp.asarray(active))
    return (score, hI, hJ, nbc, ops, cnts, nrun, startj,
            np.zeros(len(score), bool))
