"""Seed-and-verify k-mismatch search: the batched BWT alignment stage.

The reference finds all <=k-mismatch alignments with per-thread
bidirectional-BWT case enumeration (cases A-F over read cells,
DV-Kernel.cu:3656-4502, case tables definitions.h:97-121). That design
is efficient per CUDA thread but maximally divergent — every lane
follows its own branch-and-prune path — which is exactly wrong for
wide lockstep vector hardware.

This module produces the *same result set* with a uniform pipeline:

1. pigeonhole seeds: split each read into k+1 segments — any placement
   with <=k mismatches matches at least one segment exactly;
2. batched exact backward search of a PREFIX of every (read, strand,
   segment), LUT-jumpstarted. The queried prefix length is scaled to
   the genome (~log4(n) + slack): any exact full segment is also an
   exact prefix, so the candidate set is a superset and verification
   restores exactness — while the FM loop shrinks from ~L/(k+1) steps
   to a handful past the LUT width;
3. device-side compaction of the surviving SA slots (most seed lanes
   have 0-1 occurrences; only real candidates are decoded/verified);
4. one-gather SA decode (full SA) or a bounded LF walk (sampled SA);
5. scatter-min hash dedupe of (row, position) placements (device
   sorts measured ~10x the cost at these sizes);
6. packed XOR/popcount verification of each unique placement
   against the genome (the reference's check-and-extend idea,
   2bwt-flex/SRA2BWTCheckAndExtend.h:57-66, promoted from a fallback
   to the main verification path).

Reads with an over-budget seed interval are flagged and re-run with
FULL pigeonhole segments and a larger cap — the same two-round budget
scheme as the reference (perform_round1/round2_alignment,
alignment.cu:118-221; sentinels DV-Kernel.cu:4464-4486).
"""

from __future__ import annotations

import os
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from soap3dp_tpu.fm import fmindex
from soap3dp_tpu.fm.fmindex import DeviceIndex, U32
from soap3dp_tpu.utils import scans, shapes, timers

SENTINEL = jnp.uint32(0xFFFFFFFF)
ROW_SENTINEL = jnp.int32(0x7FFFFFFF)


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Static search parameters (part of the jit cache key)."""

    k: int = 2                # max mismatches (reference -s: 0..4)
    occ_cap: int = 16         # round-1 SA-interval budget per seed
    occ_cap_round2: int = 256  # round-2 budget (reference sa_range round2)
    occ_cap_round3: int = 4096  # super-repetitive budget: the analog of the
    # reference's host full re-alignment of over-budget reads
    # (ProcessReadDoubleStrand2, CPUfunctions.cpp:555) — a bounded third
    # pass that decodes the full SA interval instead of dropping the read
    seed_slack: int = 2       # extra bases past log4(n) in the seed prefix
    # (slack=1 measured 232k -> 121k reads/s at 250Mbp: the random-
    # candidate tail at E[interval]~0.25/lane dominates the saved step)
    escalate_budget: int = 8192  # max flagged reads per batch that the
    # round-2/3 escalation re-searches. Beyond it (a satellite STORM:
    # 31k/200k reads at 3.1 Gbp repeat text) flagged reads keep their
    # truncated round-1 sets and resolve via mate-window DP rescue —
    # the same storm posture as the host-realign budget
    # (options.host_realign_budget) and the reference's own small
    # fixed sa_range rounds. Measured: escalating the storm cost
    # 45.6k -> 156.0k reads/s (3.4x) for +0.18pp planted recall.

    @property
    def num_seeds(self) -> int:
        return self.k + 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HitArrays:
    """Compacted struct-of-arrays hit set for a batch.

    Entries are (oriented row, text position, mismatch count): row
    b = read b forward, row B + b = read b reverse-complement. Only
    `valid` entries are meaningful; rows are sorted by (row, tp).
    """

    row: jax.Array     # (K,) int32 oriented row id
    tp: jax.Array      # (K,) uint32 text position of the read start
    nmis: jax.Array    # (K,) int32 mismatch count
    valid: jax.Array   # (K,) bool
    flagged: jax.Array  # (B,) bool — needs a bigger-budget re-run

    def to_host(self):
        """Device->host with packed transfers.

        Every D2H transfer pays a fixed latency plus bandwidth, so
        entries ship as ONE array of two u32 words:
        [tp | row(24b) + nmis(7b) + valid(1b)].
        """
        if isinstance(self.row, jax.Array) and not isinstance(self.row, np.ndarray):
            meta = (jnp.clip(self.row, 0, (1 << 24) - 1).astype(jnp.uint32)
                    | (jnp.clip(self.nmis, 0, 127).astype(jnp.uint32) << 24)
                    | (self.valid.astype(jnp.uint32) << 31))
            ph = np.asarray(jnp.concatenate([self.tp, meta])).reshape(2, -1)
            meta_h = ph[1]
            return ((meta_h & 0xFFFFFF).astype(np.int32), ph[0],
                    ((meta_h >> 24) & 0x7F).astype(np.int32),
                    (meta_h >> 31).astype(bool),
                    np.asarray(self.flagged))
        return (np.asarray(self.row), np.asarray(self.tp),
                np.asarray(self.nmis), np.asarray(self.valid),
                np.asarray(self.flagged))


def _seed_bounds(lens: jax.Array, num_seeds: int, seed_q: int
                 ) -> tuple[jax.Array, jax.Array]:
    """Pigeonhole segments of [0, len), truncated to seed_q: (R,S) starts/lens."""
    j = jnp.arange(num_seeds, dtype=jnp.int32)[None, :]
    start = j * lens[:, None] // num_seeds
    end = (j + 1) * lens[:, None] // num_seeds
    length = end - start
    if seed_q > 0:
        length = jnp.minimum(length, seed_q)
    return start, length


def pack_read_matrix(reads: np.ndarray) -> np.ndarray:
    """Host-side 2-bit pack of a (B, L) code matrix into (B, ceil(L/16))
    uint32 — uploads shrink 4x.

    Stays in uint8: four strided shift-ors make each byte from 4 codes,
    then a little-endian u32 view stacks 4 bytes per word (byte 0 =
    bits 0-7 = codes 0-3, matching _unpack_read_matrix's shifts). The
    u32 broadcast + 16-way reduce this replaces was 0.38 s per 100k
    reads of per-batch host time; this is ~15x faster."""
    B, L = reads.shape
    W = (L + 15) // 16
    padded = np.zeros((B, W * 16), np.uint8)
    padded[:, :L] = reads
    by = (padded[:, 0::4] | (padded[:, 1::4] << 2)
          | (padded[:, 2::4] << 4) | (padded[:, 3::4] << 6))
    return np.ascontiguousarray(by).view("<u4")


def _unpack_read_matrix(words: jax.Array, L: int) -> jax.Array:
    """Device-side inverse of pack_read_matrix."""
    B, W = words.shape
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    codes = (words[:, :, None] >> shifts) & jnp.uint32(3)
    return codes.reshape(B, W * 16)[:, :L].astype(jnp.uint8)


@partial(jax.jit, static_argnames=("cfg", "cap", "seed_q", "max_seed_steps",
                                   "K", "L", "K2", "uniform_len",
                                   "seed_lo", "seed_hi"))
def _search_batch(
    idx: DeviceIndex,
    reads: jax.Array,   # (B, L) uint8 codes OR (B, W) uint32 packed (L given)
    lens: jax.Array,    # (B,) int32
    cfg: SearchConfig,
    cap: int,
    max_seed_steps: int,
    seed_q: int = 0,    # 0 = full pigeonhole segments
    K: int = 0,         # candidate-compaction budget (0 = R*S*cap, lossless)
    L: int = 0,         # read-matrix width when `reads` is packed uint32
    K2: int = 0,        # unique-placement budget (0 = lossless)
    uniform_len: int = 0,  # common read length when ALL reads share it
    seed_lo: int = 0,   # search only pigeonhole segments [seed_lo, seed_hi)
    seed_hi: int = 0,   # of the k+1-segmentation (0 = all). Segments
    # [0, m) are complete for <= m-1 mismatches — the basis of the
    # phased search (the reference's staged-phase scheme,
    # four_phases_alignment / all_best_alignment, alignment.cu:1119-1236)
) -> tuple[HitArrays, jax.Array]:
    if reads.dtype == jnp.uint32:
        reads = _unpack_read_matrix(reads, L)
    B, L = reads.shape
    S = cfg.num_seeds
    n = idx.n

    # oriented rows: forward then reverse-complement
    if uniform_len:
        rc = fmindex.revcomp_reads_uniform(reads, min(uniform_len, L))
    else:
        rc = fmindex.revcomp_reads(reads, lens)
    oriented = jnp.concatenate([reads, rc], axis=0)
    olens = jnp.concatenate([lens, lens])
    R = 2 * B
    if K <= 0:
        K = R * S * cap

    # (R, S) seed segments -> flat (R*S,) search lanes; a phased call
    # restricts to segment columns [seed_lo, seed_hi)
    sstart, slen = _seed_bounds(olens, S, seed_q)
    if seed_hi <= 0:
        seed_hi = S
    if (seed_lo, seed_hi) != (0, S):
        sstart = sstart[:, seed_lo:seed_hi]
        slen = slen[:, seed_lo:seed_hi]
        S = seed_hi - seed_lo
    seq_rows = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)
    if seed_q == idx.lut_k and max_seed_steps == 0:
        # LUT-only seeds: the whole FM extension collapses to one
        # table lookup per lane — no occ gathers at all
        km = fmindex.rolling_kmer_codes(oriented, idx.lut_k)
        m = jnp.take_along_axis(km, jnp.clip(sstart, 0, L - 1), axis=1)
        m = m.reshape(-1).astype(jnp.int32)
        l = idx.lut_lo[m]
        r = idx.lut_hi[m]
    elif 0 < seed_q <= idx.lut_k + 16 and idx.lut_k <= 16:
        # truncated seeds whose extension window fits one u32 word:
        # two element gathers per lane replace the per-lane read-row
        # materialization + per-character gathers (the hot round-1 path
        # for genomes whose seed prefix exceeds the LUT width)
        roll16 = fmindex.rolling_kmer_codes(oriented, 16)
        l, r = fmindex.backward_search_packed(
            idx, roll16, seq_rows, sstart.reshape(-1), slen.reshape(-1),
            max_steps=max_seed_steps)
    else:
        l, r = fmindex.backward_search(
            idx,
            oriented[seq_rows],
            sstart.reshape(-1),
            slen.reshape(-1),
            max_steps=max_seed_steps,
        )
    width = r - l
    overflow = width > U32(cap)
    flagged = overflow.reshape(B * 2, S).any(axis=1)
    flagged = flagged[:B] | flagged[B:]

    # enumerate up to cap slots per seed (skip overflowed seeds entirely;
    # their reads re-run in round 2 with full segments + a larger cap).
    # Compaction runs at LANE granularity — exclusive cumsum of per-lane
    # counts, a scatter-max of lane ids at each lane's output offset,
    # and a cummax fill over the K output slots — instead of
    # jnp.nonzero over the (R*S, cap) slot matrix: the scanned domain
    # shrinks ~cap x. A slot-0-direct + small-extras decomposition
    # does more work (the 1.4x larger candidate set costs more in
    # decode/dedupe gathers than it saves).
    RS = l.shape[0]
    cnt = jnp.where(overflow, U32(0), jnp.minimum(width, U32(cap))
                    ).astype(jnp.int32)                      # (R*S,)
    incl = scans.cumsum_1d(cnt)
    off = incl - cnt                                         # exclusive
    total = incl[-1]

    # expand: output slot k belongs to lane i iff off[i] <= k < incl[i]
    scat = jnp.where(cnt > 0, off, K).astype(jnp.int32)
    tbl = jnp.zeros(K + 1, jnp.int32).at[scat].max(
        jnp.arange(RS, dtype=jnp.int32) + 1, mode="drop")
    lane_p1 = scans.cummax_1d(tbl[:K])
    idxK = jnp.arange(K, dtype=jnp.int32)
    cvalid = (idxK < total) & (lane_p1 > 0)
    lane = jnp.maximum(lane_p1 - 1, 0)                       # (K,)
    cslot = jnp.where(cvalid, idxK - off[lane], 0).astype(jnp.uint32)
    rows_sa = l[lane] + cslot

    sa_pos = fmindex.sa_decode(idx, rows_sa, cvalid)

    # candidate read-start position; reject if the seed offset runs off
    # the front or the full read off the back of the genome
    st = sstart.reshape(-1).astype(U32)[lane]
    tp = sa_pos - st
    orow = seq_rows[lane]                                    # oriented row id
    ln = olens[orow].astype(U32)
    pos_ok = cvalid & (sa_pos >= st) & (tp + ln <= n)

    # dedupe BEFORE verification: a true placement is found by up to
    # k+1 exact seeds, so verifying the raw candidate list costs ~S x
    # the gather work of verifying unique (row, tp) placements.
    # Mechanism: scatter-min hash dedupe — one scatter + two gathers
    # instead of a device sort of the K candidates (whether a GPU radix
    # sort is cheaper is not measured yet).
    # Same-key losers of a rare slot collision survive here and are
    # removed by the host-side dedupe in hits_to_table.
    if K2 <= 0:
        K2 = K
    idxs = jnp.arange(K, dtype=jnp.int32)
    krow = jnp.where(pos_ok, orow.astype(U32), U32(0xFFFFFFFF))
    ktp = jnp.where(pos_ok, tp, SENTINEL)
    hb = max((K - 1).bit_length() + 1, 10)          # table = 2x candidates
    h = (krow * U32(0x9E3779B1)) ^ (ktp * U32(0x85EBCA77))
    hslot = ((h * U32(0xC2B2AE3D)) >> U32(32 - hb)).astype(jnp.int32)
    table = jnp.full((1 << hb,), K, jnp.int32).at[hslot].min(
        jnp.where(pos_ok, idxs, K))
    widx = jnp.minimum(table[hslot], K - 1)
    dup = pos_ok & (widx != idxs) & (krow[widx] == krow) & (ktp[widx] == ktp)
    first = pos_ok & ~dup
    uniq = first.sum(dtype=jnp.int32)
    idx2 = scans.nonzero_prefix(first, K2)
    uvalid = idx2 >= 0
    idx2s = jnp.where(uvalid, idx2, 0)
    urow = jnp.where(uvalid, orow[idx2s], ROW_SENTINEL)
    utp = ktp[idx2s]

    # verify unique placements in the packed domain
    read_words = fmindex.pack_reads(oriented)                # (R, W)
    urow_c = jnp.clip(urow, 0, R - 1)
    nmis = fmindex.count_mismatches_packed(
        idx,
        jnp.where(uvalid, utp, U32(0)),
        read_words[urow_c],
        olens[urow_c],
    )
    hit_ok = uvalid & (nmis <= cfg.k)

    return HitArrays(row=jnp.where(hit_ok, urow, ROW_SENTINEL),
                     tp=utp, nmis=nmis, valid=hit_ok,
                     flagged=flagged), jnp.stack([total, uniq])


@partial(jax.jit, static_argnames=("cfg", "cap", "seed_q", "max_seed_steps",
                                   "K", "L", "K2", "uniform_len",
                                   "seed_lo", "seed_hi"))
def _search_batch_wire(idx, reads, lens, cfg, cap, max_seed_steps,
                       seed_q=0, K=0, L=0, K2=0, uniform_len=0,
                       seed_lo=0, seed_hi=0):
    """_search_batch with everything the host needs in ONE u32 vector:
    [total, uniq | flagged bits | tp (K2) | meta (K2)].

    Every D2H sync has a fixed cost; the un-fused path pays one for the
    totals (retry check), one for the hit arrays and one for the flagged
    mask. meta packs
    row(24b) | nmis(7b) | valid(1b) as in HitArrays.to_host.
    """
    hits, totals = _search_batch(idx, reads, lens, cfg, cap, max_seed_steps,
                                 seed_q, K, L, K2, uniform_len,
                                 seed_lo, seed_hi)
    B = hits.flagged.shape[0]
    Bp = -(-B // 32) * 32
    fl = jnp.zeros(Bp, jnp.uint32).at[:B].set(hits.flagged.astype(jnp.uint32))
    fl_words = (fl.reshape(-1, 32)
                << jnp.arange(32, dtype=jnp.uint32)[None, :]).sum(
                    axis=1, dtype=jnp.uint32)
    meta = (jnp.clip(hits.row, 0, (1 << 24) - 1).astype(jnp.uint32)
            | (jnp.clip(hits.nmis, 0, 127).astype(jnp.uint32) << 24)
            | (hits.valid.astype(jnp.uint32) << 31))
    return jnp.concatenate([totals.astype(jnp.uint32), fl_words,
                            hits.tp, meta])


def _parse_wire(wire_h: np.ndarray, B: int, K2: int) -> tuple:
    """Host-side decode of _search_batch_wire's vector."""
    total, uniq = int(wire_h[0]), int(wire_h[1])
    nf = (-(-B // 32) * 32) // 32
    fl_words = wire_h[2:2 + nf]
    flagged = ((fl_words[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
               & 1).astype(bool).reshape(-1)[:B]
    tp = wire_h[2 + nf:2 + nf + K2]
    meta = wire_h[2 + nf + K2:2 + nf + 2 * K2]
    row = (meta & 0xFFFFFF).astype(np.int32)
    nmis = ((meta >> 24) & 0x7F).astype(np.int32)
    valid = (meta >> 31).astype(bool)
    return total, uniq, HitArrays(row=row, tp=tp, nmis=nmis, valid=valid,
                                  flagged=flagged)


def config_for(idx: DeviceIndex, k: int) -> SearchConfig:
    """Search config adapted to the index / environment.

    The escalation rounds are storm-gated per batch (see
    SearchConfig.escalate_budget): in a satellite storm flagged reads
    keep their truncated round-1 hit sets and resolve through
    mate-window DP rescue — the reference's own posture (its GPU
    rounds run small fixed sa_range budgets and over-budget reads get
    per-read-capped host completion, CPUfunctions.cpp:1287-1299; it
    never chases complete enumeration of satellite seeds). Measured at
    3.1 Gbp repeat-structured text, 100k-pair batches: escalating the
    storm cost 45.6k -> 156.0k reads/s (3.4x) while planted-truth
    recall moved 0.9975 -> 0.9957 and DP rescue absorbed the pairs
    BWT pairing lost. SOAP3DP_ESCALATE=1 forces full escalation;
    SOAP3DP_ESCALATE=0 disables the rounds entirely.
    """
    env = os.environ.get("SOAP3DP_ESCALATE")
    if env == "0":
        return SearchConfig(k=k, occ_cap_round2=0, occ_cap_round3=0)
    if env:
        return SearchConfig(k=k, escalate_budget=1 << 30)
    return SearchConfig(k=k)


def default_seed_q(idx: DeviceIndex, cfg: SearchConfig) -> int:
    """Genome-size-scaled seed prefix length: enough specificity that the
    expected random-hit count per seed stays ~O(1).

    When the LUT is at least as specific as the genome needs
    (4^lut_k >= n), use exactly lut_k so the seed search is LUT-only
    (zero FM extension steps).

    On repeat-heavy text (fmindex._repeat_heavy: >5% of positions in
    >50x-copy k-mers) random-hit expectation is meaningless — repeat
    seeds are wide at ANY prefix length — so use the full pigeonhole
    segment, bounded by the one-word packed-extension window
    (lut_k + 16). Measured at 3.1 Gbp repeat text, 200k-read batch:
    +0.3 s of FM steps, flagged 44.5k -> 31k, and escalation intervals
    narrow ~256x (22% of flagged reads' narrowest lane drops under the
    decode cap)."""
    n = int(np.asarray(idx.n))
    log4n = int(np.ceil(np.log2(max(n, 4)) / 2))
    if idx.repeat_heavy:
        return idx.lut_k + 16
    if idx.lut_k >= log4n:
        return idx.lut_k
    return max(log4n + cfg.seed_slack, idx.lut_k)


def _steps_for(idx: DeviceIndex, seed_q: int, min_seg: int) -> int:
    """Static FM-step bound for seeds truncated to seed_q."""
    if min_seg >= idx.lut_k:
        return max(seed_q - idx.lut_k, 0)
    return max(seed_q - idx.lut_k, min(idx.lut_k - 1, seed_q))


# Global candidate-work ceiling: no single search dispatch may budget
# more than this many compaction slots. When a round's lossless budget
# (2*B*S*cap) exceeds it, the per-seed cap is pre-scaled down — lanes
# wider than the reduced cap are flagged exactly as always and escalate
# to the next round / host re-alignment, so hit sets stay
# complete-or-flagged. Without this, thousands of satellite-repeat
# reads flagging at once (repeat-structured genomes) drive round 3 to
# K ~= 2*nb*S*4096 ~= 10^8+ slots: gigabytes of HBM and seconds of
# decode/dedupe work per batch (observed at 3.1 Gbp human-scale).
_K_CEIL = int(os.environ.get("SOAP3DP_K_CEIL", 1 << 24))


def _run_compacted(idx, reads, lens, cfg, cap, steps, seed_q, B, S,
                   uniform_len=0):
    """Dispatch _search_batch, growing the compaction budget on overflow.

    The returned arrays are sliced (device-side) to a bucketed prefix:
    compaction pushes pad entries to the end, so the prefix holds
    every valid hit and the host transfer shrinks to the real hit count.
    """
    cap = max(16, min(cap, _K_CEIL // max(2 * B * S, 1)))
    K = shapes.bucket(2 * B * S * 2, min_size=1024)
    K_max = 2 * B * S * cap
    while True:
        Kc = min(K, K_max)
        hits, totals = _search_batch(idx, reads, lens, cfg, cap, steps,
                                     seed_q, Kc, uniform_len=uniform_len)
        th = np.asarray(totals)
        t, u = int(th[0]), int(th[1])
        if t <= Kc or K >= K_max:  # kernel K2 defaults to K (lossless)
            break
        K = min(shapes.bucket(t), K_max)
    tb = min(shapes.bucket(u, min_size=1024), hits.row.shape[0])
    if tb < hits.row.shape[0]:
        hits = HitArrays(row=hits.row[:tb], tp=hits.tp[:tb],
                         nmis=hits.nmis[:tb], valid=hits.valid[:tb],
                         flagged=hits.flagged)
    return hits


class PendingSearch:
    """Async seed search: the round-1 dispatch happens at construction
    (the device works while the host does other things); `result()`
    syncs, grows the compaction budget if needed, and runs round 2.

    The analog of the reference's GPU/CPU double buffering
    (alignment.cu:554-561,1029-1033): dispatch batch i+1 before
    post-processing batch i on the host.
    """

    def __init__(self, idx: DeviceIndex, reads, lens,
                 cfg: SearchConfig = SearchConfig(),
                 seed_range: tuple[int, int] | None = None):
        from soap3dp_tpu.distributed import mesh as dmesh

        self.idx = idx
        self.cfg = cfg
        # phased search: restrict round 1 to segment columns [lo, hi) of
        # the k+1-segmentation (rounds 2/3 always use all segments)
        self.seed_lo, self.seed_hi = seed_range or (0, cfg.num_seeds)
        self.mesh = dmesh.mesh_of(idx)
        self.reads_h = np.asarray(reads)
        self.lens_h = np.asarray(lens).astype(np.int32)
        self.B_ext = self.reads_h.shape[0]
        if self.mesh is not None and self.B_ext:
            # shard the batch over the mesh (data parallel over reads);
            # pad to a mesh multiple with copies of read 0, stripped from
            # the results by _strip_pad
            Bp = dmesh.pad_to_mesh(self.mesh, self.B_ext)
            self.reads_h = shapes.pad_rows(self.reads_h, Bp)
            self.lens_h = shapes.pad_rows(self.lens_h, Bp)
        self.B, self.L = self.reads_h.shape
        # oriented row ids (2*B) pack into 24 bits on the result wire
        # (HitArrays.to_host / _search_batch_wire); a bigger batch would
        # silently alias read attribution, so fail loudly instead
        assert 2 * self.B < (1 << 24), (
            f"batch of {self.B} reads exceeds the 2^23-read wire limit; "
            "lower batch_size")
        S = cfg.num_seeds
        if self.B == 0:
            return
        if self.mesh is not None:
            self.lens = dmesh.shard_rows(self.mesh, self.lens_h)
        else:
            self.lens = jnp.asarray(self.lens_h)
        # 2-bit pack before upload: 4x less H2D traffic per batch
        with timers.stage("dispatch.pack"):
            packed_h = pack_read_matrix(self.reads_h)
        with timers.stage("dispatch.h2d"):
            self.packed = dmesh.shard_rows(self.mesh, packed_h) \
                if self.mesh is not None else jnp.asarray(packed_h)
        max_len = int(self.lens_h.max())
        min_len = int(self.lens_h.min())
        self.min_seg = min_len // S
        self.longest_seg = -(-max_len // S)
        self.seed_q = min(default_seed_q(idx, cfg), self.longest_seg)
        self.steps = _steps_for(idx, self.seed_q, min(self.min_seg, self.seed_q))
        # expected candidates ~= one per (read, seed) on the true strand
        # plus a little noise; unique placements ~= one per read. The
        # retry loop grows either budget if a batch beats the estimate,
        # so start tight — every padding slot costs real work
        S_eff = self.seed_hi - self.seed_lo
        self.K = shapes.bucket(self.B * S_eff * 5 // 4, min_size=1024)
        self.K2 = shapes.bucket(self.B * 2, min_size=1024)
        # round-1 cap pre-scaled so the lossless budget never exceeds
        # the global work ceiling (only binds on huge batches)
        self.cap1 = max(1, min(cfg.occ_cap,
                               _K_CEIL // max(2 * self.B * S_eff, 1)))
        self.K_max = self.K2_max = 2 * self.B * S_eff * self.cap1
        # uniform-length batches take the cheap lane-reversal revcomp
        self.uniform = int(self.lens_h[0]) \
            if (self.lens_h == self.lens_h[0]).all() else 0
        # async dispatch; no sync here. The wire variant fuses hits +
        # totals + flagged into one D2H transfer (one link sync/batch)
        with timers.stage("dispatch.jit"):
            self._wire = _search_batch_wire(
                idx, self.packed, self.lens, cfg, self.cap1, self.steps,
                self.seed_q, min(self.K, self.K_max), L=self.L,
                K2=min(self.K2, self.K2_max), uniform_len=self.uniform,
                seed_lo=self.seed_lo, seed_hi=self.seed_hi)
        # enqueue the D2H copy right behind the compute: by result()
        # time the bytes are already host-side, hiding the per-batch
        # transfer behind the host work of the previous batch
        try:
            self._wire.copy_to_host_async()
        except Exception:
            pass  # optional on this backend; np.asarray still syncs

    def _strip_pad(self, h: HitArrays) -> HitArrays:
        """Drop hits of mesh-padding rows and remap oriented row ids
        back to the caller's (unpadded) batch size."""
        if self.B == self.B_ext:
            return h
        row, tp, nm, va, fl = h.to_host()
        Bp, Be = self.B, self.B_ext
        strand = (row >= Bp) & va
        rid = row - strand.astype(np.int32) * Bp
        keep = va & (rid < Be)
        return HitArrays(
            row=(rid[keep] + strand[keep].astype(np.int32) * Be).astype(np.int32),
            tp=tp[keep], nmis=nm[keep],
            valid=np.ones(int(keep.sum()), bool), flagged=fl[:Be])

    def result(self) -> HitArrays:
        cfg = self.cfg
        B, S = self.B, self.cfg.num_seeds
        if B == 0:
            z = np.zeros(0, np.int32)
            return HitArrays(row=z, tp=z.astype(np.uint32), nmis=z,
                             valid=z.astype(bool), flagged=np.zeros(0, bool))
        K, K2 = self.K, self.K2
        t, u, hits = _parse_wire(np.asarray(self._wire), B,
                                 min(K2, self.K2_max))
        while ((t > min(K, self.K_max) or u > min(K2, self.K2_max))
               and (K < self.K_max or K2 < self.K2_max)):
            if t > min(K, self.K_max):
                K = min(shapes.bucket(t), self.K_max)
            if u > min(K2, self.K2_max):
                K2 = min(shapes.bucket(u), self.K2_max)
            wire = _search_batch_wire(
                self.idx, self.packed, self.lens, cfg, self.cap1,
                self.steps, self.seed_q, min(K, self.K_max), L=self.L,
                K2=min(K2, self.K2_max), uniform_len=self.uniform,
                seed_lo=self.seed_lo, seed_hi=self.seed_hi)
            t, u, hits = _parse_wire(np.asarray(wire), B,
                                     min(K2, self.K2_max))
        # unique placements are compaction-ordered (pads at the end), so
        # the prefix slice still covers every real hit
        tb = min(shapes.bucket(u, min_size=1024), hits.row.shape[0])
        if tb < hits.row.shape[0]:
            hits = HitArrays(row=hits.row[:tb], tp=hits.tp[:tb],
                             nmis=hits.nmis[:tb], valid=hits.valid[:tb],
                             flagged=hits.flagged)
        # escalating re-runs of still-flagged reads with full pigeonhole
        # segments: round 2 (the reference's bigger sa_range round) and a
        # bounded round 3 for super-repetitive reads — the analog of the
        # reference's host full re-alignment (ProcessReadDoubleStrand2,
        # CPUfunctions.cpp:555), which reports the full placement set
        # instead of dropping the read.
        from soap3dp_tpu.distributed import mesh as dmesh

        steps2 = _steps_for(self.idx, self.longest_seg,
                            min(self.min_seg, self.longest_seg))
        # when round 1 already searched every segment at full length,
        # an escalation only adds value through a bigger per-seed cap
        prev_cap_eff = self.cap1 if (
            (self.seed_lo, self.seed_hi) == (0, cfg.num_seeds)
            and self.seed_q >= self.longest_seg) else 0
        for cap in (cfg.occ_cap_round2, cfg.occ_cap_round3):
            if cap <= 0:  # escalation round disabled
                break
            flagged = np.asarray(hits.flagged)
            if not flagged.any():
                break
            sel = np.flatnonzero(flagged)
            if len(sel) > cfg.escalate_budget:
                break  # storm: keep truncated round-1 sets (see cfg)
            nb = min(shapes.bucket_quarter(len(sel), min_size=64), B)
            if self.mesh is not None:
                nb = min(dmesh.pad_to_mesh(self.mesh, nb), B)
            # the global work ceiling scales the requested cap down; if
            # that leaves no more budget per seed than the previous
            # round already ran with, this round is an exact re-run —
            # skip it (at 200k-read repeat batches BOTH rounds used to
            # collapse to cap 32, so round 3 duplicated round 2's 1.3 s
            # for zero new hits)
            cap_eff = max(16, min(cap, _K_CEIL // max(2 * nb * S, 1)))
            if cap_eff <= prev_cap_eff:
                break
            prev_cap_eff = cap_eff
            reads_h = self.reads_h
            sel_pad = np.concatenate([sel, np.zeros(nb - len(sel), np.int64)]) \
                if len(sel) < nb else sel[:nb]
            if self.mesh is not None:
                r2, l2 = dmesh.shard_rows(self.mesh, reads_h[sel_pad],
                                          self.lens_h[sel_pad])
            else:
                r2 = jnp.asarray(reads_h[sel_pad])
                l2 = jnp.asarray(self.lens_h[sel_pad])
            lh = self.lens_h[sel_pad]
            un2 = int(lh[0]) if (lh == lh[0]).all() else 0
            hits2 = _run_compacted(self.idx, r2, l2, cfg, cap, steps2, 0,
                                   nb, S, uniform_len=un2)
            hits = _merge_round2(hits, hits2, sel, B, nb)
        return self._strip_pad(hits)


def search_reads(
    idx: DeviceIndex,
    reads: np.ndarray | jax.Array,
    lens: np.ndarray | jax.Array,
    cfg: SearchConfig = SearchConfig(),
) -> HitArrays:
    """Two-round seed search over a read batch.

    Round 1 queries genome-scaled seed prefixes with a small per-seed
    budget; reads with an over-budget seed are re-run in round 2 with
    full pigeonhole segments and `occ_cap_round2`. Reads still over
    budget in round 2 keep `flagged=True` — the pipeline treats them
    like the reference's 0xFFFFFFFE "too many hits" sentinel
    (DV-Kernel.cu:4464-4486).
    """
    return PendingSearch(idx, reads, lens, cfg).result()


def _merge_round2(h1: HitArrays, h2: HitArrays, sel: np.ndarray, B: int,
                  nb: int) -> HitArrays:
    """Replace flagged reads' round-1 entries with their round-2 results
    (host-side concat; downstream grouping re-sorts anyway)."""
    row1, tp1, nm1, va1, _ = h1.to_host()
    row2, tp2, nm2, va2, fl2 = h2.to_host()
    n_sel = len(sel)

    # keep round-1 entries of non-flagged reads
    read1 = np.where(row1 >= B, row1 - B, row1)
    keep1 = va1.copy()
    keep1[va1] = ~np.isin(read1[va1], sel)

    # round-2 entries: drop pad reads, remap subset rows -> global rows
    read2 = np.where(row2 >= nb, row2 - nb, row2)
    keep2 = va2 & (read2 < n_sel)
    strand2 = (row2 >= nb).astype(np.int32)
    g_row = np.where(keep2, sel[np.minimum(read2, n_sel - 1)]
                     + strand2 * B, 0).astype(np.int32)

    row = np.concatenate([row1[keep1], g_row[keep2]])
    tp = np.concatenate([tp1[keep1], tp2[keep2]])
    nm = np.concatenate([nm1[keep1], nm2[keep2]])
    flagged = np.zeros(B, bool)
    flagged[sel] = fl2[:n_sel]
    return HitArrays(row=row, tp=tp, nmis=nm,
                     valid=np.ones(len(row), bool), flagged=flagged)
