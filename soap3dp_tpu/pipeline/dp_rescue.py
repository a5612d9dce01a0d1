"""DP rescue: seeding, candidate windows, batched banded DP, results.

The batched equivalents of the reference's three DP engines:

* single-end salvage (SingleDP_Space, DV-DPForSingleReads.cu): 3+
  evenly spaced seeds per read (lengths staged by read length,
  definitions.h:191-213), decode seed hits to candidate loci, merge
  nearby candidates, then banded DP of the read against a window of
  [pos - margin, pos + len + margin) with margin(l) = l/4 if l > 100
  else 25 (DPS_MARGIN, DV-DPfunctions.cu:1005).
* half-aligned PE rescue (DP_Space::HalfEndAlignmentEngine,
  DV-DPfunctions.cu:2027-2109): mate window derived from the anchor
  position and the insert-size range.
* both-unaligned PE ("deep DP", DeepDP_Space): seed both ends, pair
  candidate loci within the insert window, DP both ends.

The reference seeds with a 1-mismatch GPU kernel
(single_1_mismatch_alignment2, alignment.cu:1839); this rebuild uses
exact seeds (the uniform batched backward search), which pigeonholes a
1-mismatch seed of length L into one exact seed of length >= L/2 — the
staged seed lengths keep sensitivity comparable.

All stages share one batched DP call: windows are gathered from the
packed genome on device, reads are strand-oriented, scores below the
cutoff (0.3 * read length by default) are dropped, and survivors are
traced back to CIGAR runs.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from soap3dp_tpu.fm import fmindex
from soap3dp_tpu.fm.fmindex import DeviceIndex
from soap3dp_tpu.index.builder import Index
from soap3dp_tpu.kernels.banded_dp import DPScores, dp_align
from soap3dp_tpu.utils import timers

MERGE_GAP = 50  # candidates within 50bp collapse (DP2_DIVIDE_GAP)
U32 = jnp.uint32


def dp_margin(rlen: np.ndarray) -> np.ndarray:
    """DPS_MARGIN / DP2_MARGIN: l/4 for l > 100, else 25."""
    rlen = np.asarray(rlen)
    return np.where(rlen > 100, rlen >> 2, 25)


def single_dp_seed_matrix(lens: np.ndarray, max_len: int, halved: bool = False
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Per-read seed (positions (B,S), lengths (B,)) for single-end DP
    seeding (getSeedPositions STAGE_SINGLE_DP, definitions.h:323-377).
    S is static given max_len; unused seed slots repeat the last seed
    (candidate dedupe collapses them). ``halved`` doubles the seed set
    with exact halves — the 1-mismatch pigeonhole (see
    deep_dp_seed_matrix); measured +0.35 recall on 4%-mutated reads."""
    lens = np.asarray(lens, np.int64)
    slen = np.select([lens > 300, lens > 80, lens > 60, lens > 40],
                     [70, 38, 32, 26], 22).astype(np.int64)
    trim = np.select([lens > 300, lens > 80, lens > 60, lens > 40],
                     [(lens * 0.15).astype(np.int64), 10, 4, 4], 0)
    h = np.where(lens > 300, (lens * 0.15).astype(np.int64), 0)
    num = np.where(lens > 120, 3 + lens // 100, 3)
    S = int(3 + (max_len // 100 if max_len > 120 else 0))
    i = np.arange(S, dtype=np.int64)[None, :]
    apart = (lens - trim - h) // np.maximum(num, 1)
    pos = h[:, None] + i * apart[:, None]
    # the reference clamps the last seed into the trimmed tail; extra
    # static slots repeat it
    last = np.minimum(h + (num - 1) * apart, lens - slen - trim)
    pos = np.where(i < (num - 1)[:, None], pos, last[:, None])
    pos = np.clip(pos, 0, np.maximum(lens - slen, 0)[:, None])
    if halved:
        half = slen // 2
        pos = np.concatenate([pos, pos + half[:, None]], axis=1)
        return pos.astype(np.int32), half.astype(np.int32)
    return pos.astype(np.int32), slen.astype(np.int32)


def deep_dp_seed_matrix(lens: np.ndarray, max_len: int, round2: bool = False,
                        halved: bool = False
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-read seed matrix for deep-DP seeding
    (getSeedPositions STAGE_DEEP_DP_ROUND1/2, definitions.h:378-441).

    With ``halved``, every seed is replaced by its two exact halves —
    the pigeonhole equivalent of the reference's 1-mismatch seed kernel
    (single_1_mismatch_alignment2, alignment.cu:1839): a placement with
    <=1 mismatch inside the original seed matches at least one half
    exactly. Measured by tools/seed_sensitivity.py.
    """
    lens = np.asarray(lens, np.int64)
    table = [52, 30, 28, 26, 24] if round2 else [45, 26, 24, 22, 20]
    slen = np.select([lens > 150, lens > 80, lens > 60, lens > 40],
                     table[:4], table[4]).astype(np.int64)
    num = np.maximum(2, lens // np.maximum(slen, 1))
    # static S: max seeds any read length up to max_len can request
    r = np.arange(1, max(max_len, 2) + 1, dtype=np.int64)
    sl_r = np.select([r > 150, r > 80, r > 60, r > 40], table[:4], table[4])
    S = int(np.maximum(2, r // sl_r).max())
    i = np.arange(S, dtype=np.int64)[None, :]
    apart = np.maximum((lens - slen) // np.maximum(num - 1, 1), 1)
    pos = np.minimum(i * apart[:, None],
                     np.maximum(lens - slen, 0)[:, None])
    last = np.minimum((num - 1) * apart, np.maximum(lens - slen, 0))
    pos = np.where(i < num[:, None], pos, last[:, None])
    if halved:
        half = slen // 2
        pos = np.concatenate([pos, pos + half[:, None]], axis=1)
        # seed_candidates takes one length per read: both halves use
        # floor(slen/2); the second half simply starts mid-seed (its few
        # extra tail bases are covered by the next seed's first half)
        return pos.astype(np.int32), half.astype(np.int32)
    return pos.astype(np.int32), slen.astype(np.int32)


@dataclasses.dataclass
class Candidates:
    """Candidate alignment loci: (read index into the subset, strand, pos)."""

    read: np.ndarray    # (M,) int32 — indices into the *subset* arrays
    strand: np.ndarray  # (M,) int8
    pos: np.ndarray     # (M,) int64 candidate read-start text position


@partial(jax.jit, static_argnames=("occ_cap", "max_steps", "K", "lut_only"))
def _seed_cand_batch(
    idx: DeviceIndex,
    reads: jax.Array,      # (B, L) uint8 forward codes
    lens: jax.Array,       # (B,) int32
    seed_pos: jax.Array,   # (B, S) int32
    seed_len: jax.Array,   # (B,) int32
    occ_cap: int,
    max_steps: int,
    K: int,
    lut_only: bool = False,
):
    """Device half of seed_candidates: search + compacted SA decode.

    Returns (row, pos, valid, total): row is the oriented row id,
    pos the (clamped-at-0) candidate read-start text position.

    With ``lut_only`` (4^lut_k >= genome size) seeds truncate to the
    LUT width and the whole search is one table gather per lane — the
    same fast path as the primary seed search; noisier candidates are
    filtered by the DP cutoff / anchor joins downstream.
    """
    B, L = reads.shape
    S = seed_pos.shape[1]
    oriented = jnp.concatenate(
        [reads, fmindex.revcomp_reads(reads, lens)], axis=0)
    R = 2 * B
    sp = jnp.concatenate([seed_pos, seed_pos], axis=0)
    sl2 = jnp.concatenate([seed_len, seed_len]).astype(jnp.int32)
    ln2 = jnp.concatenate([lens, lens]).astype(jnp.int32)
    if lut_only:
        sl2 = jnp.minimum(sl2, idx.lut_k)
    sp = jnp.minimum(sp, jnp.maximum(ln2 - sl2, 0)[:, None])
    slen_arr = jnp.broadcast_to(jnp.minimum(sl2, ln2)[:, None], sp.shape)
    rows = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)
    if lut_only:
        km = fmindex.rolling_kmer_codes(oriented, idx.lut_k)
        m = jnp.take_along_axis(km, jnp.clip(sp, 0, L - 1), axis=1)
        m = m.reshape(-1).astype(jnp.int32)
        l = idx.lut_lo[m]
        r = idx.lut_hi[m]
    else:
        l, r = fmindex.backward_search(
            idx, oriented[rows], sp.reshape(-1), slen_arr.reshape(-1),
            max_steps=max_steps)
    width = r - l
    slot = jnp.arange(occ_cap, dtype=jnp.uint32)[None, :]
    ok = slot < jnp.minimum(width, U32(occ_cap))[:, None]     # (R*S, cap)
    total = ok.sum(dtype=jnp.int32)
    flat = jnp.nonzero(ok.reshape(-1), size=K, fill_value=-1)[0]
    cvalid = flat >= 0
    safe = jnp.where(cvalid, flat, 0)
    lane = (safe // occ_cap).astype(jnp.int32)
    cslot = (safe % occ_cap).astype(jnp.uint32)
    sa_pos = fmindex.sa_decode(idx, l[lane] + cslot, cvalid)
    st = sp.reshape(-1).astype(U32)[lane]
    cvalid &= sa_pos >= st
    pos = jnp.where(cvalid, sa_pos - st, U32(0))
    # one packed transfer: [row | pos | valid] (fixed D2H latency per event)
    packed = jnp.concatenate([rows[lane].astype(U32), pos,
                              cvalid.astype(U32)])
    return packed, total


def seed_candidates(
    idx: DeviceIndex,
    reads: np.ndarray,     # (B, L) uint8 forward codes (subset to rescue)
    lens: np.ndarray,      # (B,) int32
    seed_pos: np.ndarray,  # (B, S) int32 per-read seed offsets
    seed_len: np.ndarray,  # (B,) int32 per-read seed length
    occ_cap: int = 64,
    merge_gap: int = MERGE_GAP,
) -> Candidates:
    """Exact-search the staged seeds on both strands, decode, merge."""
    B, L = reads.shape
    if B == 0:
        return Candidates(np.zeros(0, np.int32), np.zeros(0, np.int8),
                          np.zeros(0, np.int64))
    # static-shape bucketing: pad the subset so repeated rescues reuse
    # the compiled search (see utils/shapes.py)
    from soap3dp_tpu.utils import shapes

    from soap3dp_tpu.distributed import mesh as dmesh

    mesh = dmesh.mesh_of(idx)
    B_real = B
    B = shapes.bucket(B, min_size=64)
    if mesh is not None:
        B = dmesh.pad_to_mesh(mesh, B)
    reads = shapes.pad_rows(np.asarray(reads), B)
    lens = shapes.pad_rows(np.asarray(lens), B)
    seed_pos = shapes.pad_rows(np.asarray(seed_pos, np.int32), B)
    seed_len = shapes.pad_rows(np.asarray(seed_len, np.int32), B)
    if mesh is not None:
        # shard the seeding batch over the mesh (padding rows repeat
        # read 0; their candidates are dropped by the B_real filter)
        reads, lens, seed_pos, seed_len = dmesh.shard_rows(
            mesh, reads, lens, seed_pos, seed_len)
    S = seed_pos.shape[1]
    R = 2 * B
    # the seed-length table has a handful of staged values, so this
    # static bound yields a bounded jit-cache set
    msl = int(seed_len.max()) if seed_len.size else 0
    max_steps = max(msl - idx.lut_k, min(idx.lut_k, msl))
    # NOTE: truncating rescue seeds to the LUT width (lut_only) was
    # measured a net loss — the unverified 14bp-seed noise multiplies
    # DP problems downstream. Rescue seeds keep their staged lengths.
    lut_only = False
    K = shapes.bucket(R * S * 2, min_size=1024)
    K_max = R * S * occ_cap
    with timers.stage("dp.seed_cand"):
        while True:
            packed, total = _seed_cand_batch(
                idx, jnp.asarray(reads), jnp.asarray(lens, jnp.int32),
                jnp.asarray(seed_pos, jnp.int32), jnp.asarray(seed_len, jnp.int32),
                occ_cap, max_steps, min(K, K_max), lut_only=lut_only)
            t = int(total)
            if t <= K or K >= K_max:
                break
            K = min(shapes.bucket(t), K_max)
        Kc = min(K, K_max)
        # transfer a bucketed prefix only (nonzero output is index-sorted,
        # so pad entries sit at the end), as one packed event
        tb = min(shapes.bucket(t, min_size=1024), Kc)
        ph = np.asarray(jnp.concatenate(
            [packed[0:tb], packed[Kc:Kc + tb], packed[2 * Kc:2 * Kc + tb]])
        ).reshape(3, -1)
    vald = ph[2].astype(bool)
    rowf = ph[0].astype(np.int32)[vald]
    posf = ph[1][vald].astype(np.int64)
    strand = (rowf >= B).astype(np.int8)
    read = (rowf - strand.astype(np.int32) * B).astype(np.int32)
    keep_real = read < B_real  # drop bucket-padding rows
    read, strand, posf = read[keep_real], strand[keep_real], posf[keep_real]
    # merge: sort by (read, strand, pos); drop candidates within merge_gap
    order = np.lexsort((posf, strand, read))
    read, strand, posf = read[order], strand[order], posf[order]
    if read.size:
        same = (np.diff(read) == 0) & (np.diff(strand) == 0) & (np.diff(posf) < merge_gap)
        keep = np.concatenate([[True], ~same])
        read, strand, posf = read[keep], strand[keep], posf[keep]
    return Candidates(read=read, strand=strand, pos=posf)


@partial(jax.jit, static_argnames=("O", "W"))
def _prescan_impl(idx, reads_p, lens_rows, read_idx, strand, ws, rlens,
                  wlens, O: int, W: int):
    """Cross-correlation mismatch counts: mm[m, o] = mismatches of
    read m placed gapless at window offset o. L shift-and-add steps of
    (M, O) byte compares — the vectorized form of the reference's
    packed XOR+popcount check-and-extend
    (SRA2BWTCheckAndExtend.h:57-66).

    Orientation + window extraction happen INSIDE the jit: as eager
    ops they would dispatch ~15 tiny executables per flush."""
    rc = fmindex.revcomp_reads(reads_p, lens_rows)
    oriented = jnp.where(strand[:, None] == 1, rc[read_idx],
                         reads_p[read_idx])
    wins = fmindex.extract_genome(idx, ws, W).astype(jnp.uint8)
    M, Lr = oriented.shape

    def body(l, mm):
        wcol = jax.lax.dynamic_slice_in_dim(wins, l, O, axis=1)
        ne = (wcol != oriented[:, l][:, None]) & (l < rlens)[:, None]
        return mm + ne.astype(jnp.int32)

    mm = jax.lax.fori_loop(0, Lr, body, jnp.zeros((M, O), jnp.int32))
    o = jnp.arange(O, dtype=jnp.int32)[None, :]
    valid = o <= (wlens - rlens)[:, None]
    mm = jnp.where(valid, mm, 1 << 20)
    min_mm = mm.min(axis=1).astype(jnp.int32)
    best = jnp.argmax(mm == min_mm[:, None], axis=1).astype(jnp.int32)
    n0 = (mm == 0).sum(axis=1, dtype=jnp.int32)
    return jnp.stack([min_mm, best, n0], axis=1)


def gapless_prescan(
    idx: DeviceIndex,
    reads: np.ndarray,     # (B, L) forward codes of the subset
    lens: np.ndarray,      # (M,) per-CANDIDATE read lengths
    cand: Candidates,
    win_start: np.ndarray,  # (M,) int64
    win_len: np.ndarray,    # (M,) int32
    max_win: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-candidate best gapless placement in the window.

    Returns (min_mm, best_off, n_zero): the window's minimum full-length
    mismatch count, the LEFTMOST offset achieving it, and the number of
    0-mismatch offsets. A candidate with min_mm == 0 scores the global
    maximum L*match — no DP placement (mismatch, indel, or clipped) can
    beat it, so the caller may emit it without running DP (VERDICT r2
    item 3; window geometry cf. HalfEndAlgnBatch::pack,
    DV-DPfunctions.cu:2027-2109).
    """
    from soap3dp_tpu.utils import shapes

    M_real = cand.read.shape[0]
    if M_real == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    Bp = shapes.bucket(reads.shape[0], min_size=64)
    reads_p = shapes.pad_rows(np.asarray(reads), Bp)
    M_pad = shapes.bucket(M_real, min_size=128)
    O = shapes.bucket_multiple(max_win, 128)
    read_idx = shapes.pad_rows(cand.read, M_pad, fill_from_first=False)
    strand = shapes.pad_rows(cand.strand, M_pad, fill_from_first=False)
    ws = shapes.pad_rows(np.asarray(win_start), M_pad, fill_from_first=False)
    wl = shapes.pad_rows(np.asarray(win_len, np.int32), M_pad,
                         fill_from_first=False)
    rl = shapes.pad_rows(np.asarray(lens, np.int32), M_pad,
                         fill_from_first=False)
    L = reads_p.shape[1]

    lens_rows = np.zeros(Bp, np.int32)
    lens_rows[cand.read[:M_real]] = np.asarray(lens, np.int32)[:M_real]
    out = np.asarray(_prescan_impl(
        idx, reads_p, lens_rows, read_idx.astype(np.int32),
        strand.astype(np.int8), ws.astype(np.uint32), rl, wl,
        O, O + ((L + 127) // 128) * 128))
    return out[:M_real, 0], out[:M_real, 1], out[:M_real, 2]


@partial(jax.jit, static_argnames=("un", "max_win"))
def _pack_problems(idx, reads, lens, cread, strand_rev, win_start,
                   un: int, max_win: int):
    """Device pack of DP problems: orient reads per candidate strand and
    extract the genome windows — fused into one executable (see
    _prescan_impl)."""
    rc = fmindex.revcomp_reads_uniform(reads, un) if un \
        else fmindex.revcomp_reads(reads, lens)
    oriented = jnp.where(strand_rev[:, None], rc[cread], reads[cread])
    wins = fmindex.extract_genome(idx, win_start, max_win).astype(jnp.uint8)
    return oriented, wins


@dataclasses.dataclass
class DPResult:
    """One DP alignment per surviving problem (arrays over problems)."""

    read: np.ndarray      # subset index
    strand: np.ndarray
    pos: np.ndarray       # absolute text position of the alignment start
    score: np.ndarray
    ops: np.ndarray       # (M, MAXRUNS) right-to-left run ops
    cnts: np.ndarray
    nrun: np.ndarray
    win_start: np.ndarray  # window origin (for MD reconstruction)
    n_best_cells: np.ndarray  # maxScoreCount within the window
    problem: np.ndarray   # index of the surviving input problem


def empty_dpresult() -> DPResult:
    z = np.zeros(0, np.int64)
    return DPResult(
        read=z.astype(np.int32), strand=z.astype(np.int8), pos=z,
        score=z.astype(np.int32), ops=np.zeros((0, 1), np.int32),
        cnts=np.zeros((0, 1), np.int32), nrun=np.zeros(0, np.int32),
        win_start=z, n_best_cells=z.astype(np.int32), problem=z)


def concat_dpresults(parts: list[DPResult]) -> DPResult:
    """Concatenate DPResults (ops/cnts right-padded to a common width)."""
    parts = [p for p in parts if p is not None and p.read.size]
    if not parts:
        return empty_dpresult()
    if len(parts) == 1:
        return parts[0]
    MR = max(p.ops.shape[1] for p in parts)

    def padw(a):
        return np.pad(a, ((0, 0), (0, MR - a.shape[1])))

    return DPResult(
        read=np.concatenate([p.read for p in parts]),
        strand=np.concatenate([p.strand for p in parts]),
        pos=np.concatenate([p.pos for p in parts]),
        score=np.concatenate([p.score for p in parts]),
        ops=np.concatenate([padw(p.ops) for p in parts]),
        cnts=np.concatenate([padw(p.cnts) for p in parts]),
        nrun=np.concatenate([p.nrun for p in parts]),
        win_start=np.concatenate([p.win_start for p in parts]),
        n_best_cells=np.concatenate([p.n_best_cells for p in parts]),
        problem=np.concatenate([p.problem for p in parts]))


def run_banded_dp(
    idx: DeviceIndex,
    reads: np.ndarray,        # (B, L) forward codes of the subset
    lens: np.ndarray,         # (B,)
    cand: Candidates,
    win_start: np.ndarray,    # (M,) int64 window start per candidate
    win_len: np.ndarray,      # (M,) int32
    max_win: int,
    clip_l: np.ndarray, clip_r: np.ndarray,       # (M,)
    anchor_l: np.ndarray, anchor_r: np.ndarray,   # (M,)
    cutoff: np.ndarray,       # (M,) score threshold
    sc: DPScores,
    index_host: Index | None = None,
) -> DPResult:
    """One batched DP over candidate windows; returns survivors only.

    Problem count and window width are bucketed to static shapes (pad
    lanes get an unreachable cutoff, so they never survive)."""
    from soap3dp_tpu.distributed import mesh as dmesh
    from soap3dp_tpu.utils import shapes

    mesh = dmesh.mesh_of(idx)
    M_real = cand.read.shape[0]
    if M_real:
        # subset reads too: every jnp op shape must come from the bucket set
        Bp = shapes.bucket(reads.shape[0], min_size=64)
        reads = shapes.pad_rows(np.asarray(reads), Bp)
        lens = shapes.pad_rows(np.asarray(lens), Bp)
        M_pad = shapes.bucket(M_real, min_size=128)
        if mesh is not None:
            # the fused DP kernel runs under shard_map: every shard
            # needs an equal, tile-aligned slice of the problem axis
            from soap3dp_tpu.kernels.banded_dp import KERNEL_P_TILE
            M_pad = dmesh.pad_to_mesh(mesh, M_pad, KERNEL_P_TILE)
        max_win = shapes.bucket_multiple(max_win, 128)
        cand = Candidates(
            read=shapes.pad_rows(cand.read, M_pad, fill_from_first=False),
            strand=shapes.pad_rows(cand.strand, M_pad, fill_from_first=False),
            pos=shapes.pad_rows(cand.pos, M_pad, fill_from_first=False))
        win_start = shapes.pad_rows(np.asarray(win_start), M_pad,
                                    fill_from_first=False)
        win_len = shapes.pad_rows(np.asarray(win_len), M_pad,
                                  fill_from_first=False)
        clip_l = shapes.pad_rows(np.asarray(clip_l), M_pad, False)
        clip_r = shapes.pad_rows(np.asarray(clip_r), M_pad, False)
        anchor_l = shapes.pad_rows(np.asarray(anchor_l), M_pad, False)
        anchor_r = shapes.pad_rows(np.asarray(anchor_r), M_pad, False)
        big = np.full(M_pad - M_real, 1 << 20, np.int64)
        cutoff = np.concatenate([np.asarray(cutoff, np.int64), big])
    M = cand.read.shape[0]
    if M == 0:
        z = np.zeros(0, np.int64)
        return DPResult(*(z.astype(t) for t in
                          (np.int32, np.int8, np.int64, np.int32)),
                        ops=np.zeros((0, 1), np.int32),
                        cnts=np.zeros((0, 1), np.int32),
                        nrun=np.zeros(0, np.int32),
                        win_start=z, n_best_cells=z.astype(np.int32),
                        problem=z.astype(np.int64))
    L = reads.shape[1]

    def dev(a, dtype=None):
        """Per-problem array -> device, row-sharded when on a mesh."""
        a = np.asarray(a, dtype) if dtype is not None else np.asarray(a)
        return dmesh.shard_rows(mesh, a) if mesh is not None else jnp.asarray(a)

    with timers.stage("dp.pack"):
        # stays on device end to end: orientation, window extraction and
        # the DP all consume HBM-resident arrays (no host round trip),
        # packed by one jit (_pack_problems) instead of eager jnp ops
        lens_h = np.asarray(lens)
        un = int(lens_h[0]) if len(lens_h) and (lens_h == lens_h[0]).all() \
            else 0
        oriented, wins = _pack_problems(
            idx, jnp.asarray(reads), jnp.asarray(lens_h, np.int32),
            dev(cand.read), dev(cand.strand == 1),
            dev(win_start, np.uint32), un, max_win)
        rlen = lens[cand.read].astype(np.int32)

    with timers.stage("dp.align"):
        # fused forward + traceback on the GPU: the kernel returns
        # finished CIGAR runs (the scan path elsewhere)
        cutoff32 = np.minimum(np.asarray(cutoff), 1 << 20).astype(np.int32)
        score, hI, hJ, nbc, ops, cnts, nrun, startj, overflow = dp_align(
            oriented, dev(rlen), wins,
            dev(win_len, np.int32),
            dev(clip_l, np.int32), dev(clip_r, np.int32),
            dev(anchor_l, np.int32), dev(anchor_r, np.int32),
            dev(cutoff32), sc=sc, mesh=mesh)
    passed = score >= cutoff
    if overflow.any():
        # lanes over the kernel's run budget with score >= cutoff are
        # re-run via the scan fallback inside dp_align; anything still
        # flagged here failed the cutoff anyway (belt and braces)
        passed &= ~overflow
    if index_host is not None:
        # drop alignments whose reference span [pos, pos+span) crosses a
        # chromosome boundary or an excluded ambiguity region (the
        # reference's annotation/boundary handling in output)
        from soap3dp_tpu.io.sam import crosses_boundary
        end_j = hJ.astype(np.int64)
        span = np.maximum(end_j - startj, 1)
        passed &= ~crosses_boundary(
            index_host, (win_start + startj).astype(np.uint64), span)
    sel = np.flatnonzero(passed)
    return DPResult(
        read=cand.read[sel], strand=cand.strand[sel],
        pos=win_start[sel] + startj[sel], score=score[sel],
        ops=ops[sel], cnts=cnts[sel], nrun=nrun[sel],
        win_start=win_start[sel], n_best_cells=nbc[sel],
        problem=sel.astype(np.int64))
