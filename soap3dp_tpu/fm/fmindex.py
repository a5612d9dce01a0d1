"""Batched FM-index primitives in JAX (uint32 throughout).

These are the batched equivalents of the reference's GPU occ lookup and
backward search (GPUBWTOccValue, DV-Kernel.cu:256; contBackwardSearch,
DV-Kernel.cu:337-480) and of the host-side SA decode
(BWTSaValue, 2bwt-lib/BWT.c:1694) and check-and-extend verification
(CEPackedMismatchMatching, 2bwt-flex/SRA2BWTCheckAndExtend.h:57-66).

Design notes:

* Everything is batched over a leading axis; one "lane" = one search
  state. There is no per-lane control flow — loops run to static
  bounds with masked updates, so XLA sees fixed shapes only.
* One Occ query = TWO single-u32 element gathers (a cumulative count
  from the flat ``occ`` table and one 16-base BWT word) plus an
  in-register 2-bit popcount, where the reference reads one wide
  interleaved row (GPU_OCC_INTERVAL 128). Which layout is cheaper on
  a GPU, where a random access costs a 32-byte sector, is not measured
  yet.
* SA decode uses a value-sampled SA, so the LF walk is a static
  ``sa_rate``-iteration loop; every step is ~5 element gathers
  (mark word + rank + sample + BWT word + occ count).
* Positions/intervals are uint32 (4 Gbp limit, as the reference,
  README.md section 2.1).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from soap3dp_tpu.index.builder import Index

U32 = jnp.uint32
_LANES = jnp.uint32(0x5555_5555)  # one bit per 2-bit base slot


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceIndex:
    """HBM-resident index arrays. Host metadata stays on the Index."""

    occ: jax.Array         # (4 * nw,) uint32 flat: occ[4w+c]
    bwt: jax.Array         # (nw,) uint32 packed BWT words
    mark_rank: jax.Array   # (nmw,) uint32 exclusive rank per mark word
    mark_words: jax.Array  # (nmw,) uint32 SA-sample bitvector
    sa_samples: jax.Array  # (num_samples,) uint32
    counts: jax.Array      # (5,) uint32
    pac: jax.Array         # (n_words + pad,) uint32
    lut_lo: jax.Array      # (4^lut_k,) uint32
    lut_hi: jax.Array      # (4^lut_k,) uint32
    primary: jax.Array     # () uint32
    n: jax.Array           # () uint32
    # static (python) fields — part of the jit cache key
    sa_rate: int = dataclasses.field(metadata={"static": True})
    lut_k: int = dataclasses.field(metadata={"static": True})
    # repeat-heavy text (see _repeat_heavy): seed search uses FULL
    # pigeonhole segments instead of genome-scaled prefixes — measured
    # at 3.1 Gbp repeat-structured text: +0.3 s/batch of FM steps buys
    # 30% fewer flagged reads and ~256x narrower escalation intervals
    repeat_heavy: bool = dataclasses.field(metadata={"static": True},
                                           default=False)

    def tree_flatten(self):
        children = (self.occ, self.bwt, self.mark_rank, self.mark_words,
                    self.sa_samples, self.counts, self.pac, self.lut_lo,
                    self.lut_hi, self.primary, self.n)
        return children, (self.sa_rate, self.lut_k, self.repeat_heavy)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, sa_rate=aux[0], lut_k=aux[1],
                   repeat_heavy=aux[2])


def device_index(index: Index, sharding=None) -> DeviceIndex:
    """Upload a host Index to the accelerator (replicated by default).

    The analog of GPUINDEXUpload (alignment.cu:27-116).
    """
    put = partial(jax.device_put, device=sharding) \
        if sharding is not None else jnp.asarray
    return DeviceIndex(
        repeat_heavy=_repeat_heavy(index),
        occ=put(np.asarray(index.occ)),
        bwt=put(np.asarray(index.bwt)),
        mark_rank=put(np.asarray(index.mark_rank)),
        mark_words=put(np.asarray(index.mark_words)),
        sa_samples=put(np.asarray(index.sa_samples)),
        counts=put(np.asarray(index.counts)),
        pac=put(np.asarray(index.pac)),
        lut_lo=put(np.asarray(index.lut_lo)),
        lut_hi=put(np.asarray(index.lut_hi)),
        primary=jnp.uint32(index.primary),
        n=jnp.uint32(index.n),
        sa_rate=int(index.sa_rate),
        lut_k=int(index.lut_k),
    )


def _repeat_heavy(index: Index, thresh: float = 0.05,
                  heavy_x: float = 50.0) -> bool:
    """Is a material fraction of the TEXT inside high-copy repeats?

    Measured from the LUT: each k-mer's SA-interval width IS its exact
    occurrence count, and summing widths weights by text positions.
    `heavy` = mass of positions whose k-mer occurs > ``heavy_x`` times
    the uniform expectation. Uniform-random text measures ~0; the
    3.1 Gbp GRCh38-like repeat genome (tools/repeat_genome.py, ~31%
    Alu/LINE/satellite) measures far above ``thresh`` — satellite and
    young-SINE 13-mers occur 10^4-10^6 times. The flag is static (part
    of the jit key) and selects full-segment seeding (default_seed_q).

    SOAP3DP_REPEAT_HEAVY=0/1 overrides the detection.
    """
    env = os.environ.get("SOAP3DP_REPEAT_HEAVY")
    if env is not None:
        return env not in ("", "0")
    lo = np.asarray(index.lut_lo)
    hi = np.asarray(index.lut_hi)
    size = len(lo)
    if size < 2 or index.n < (1 << 20):
        return False
    # strided sample: 1M entries bound the host scan to ~10 ms while
    # every repeat family big enough to matter still lands thousands
    # of sampled k-mers
    step = max(size // (1 << 20), 1)
    w = (hi[::step] - lo[::step]).astype(np.float64)
    total = w.sum()
    if total <= 0:
        return False
    expect = max(float(index.n) / size, 1.0)
    heavy = w[w > heavy_x * expect].sum() / total
    return bool(heavy > thresh)


def is_oom_error(exc: BaseException) -> bool:
    """True for an XLA device-memory exhaustion error (any backend)."""
    msg = str(exc).upper()
    return ("RESOURCE_EXHAUSTED" in msg or "OUT OF MEMORY" in msg
            or "OOM" in msg.split() or "ALLOCATION FAILURE" in msg)


def index_hbm_bytes(index: Index) -> int:
    """Estimated HBM footprint of device_index(index)."""
    total = 0
    for name in ("occ", "bwt", "mark_rank", "mark_words", "sa_samples",
                 "counts", "pac", "lut_lo", "lut_hi"):
        total += int(np.asarray(getattr(index, name)).nbytes)
    return total


def device_index_ladder(index: Index, sharding=None,
                        hbm_budget: int | None = None,
                        max_rate: int = 256) -> tuple[DeviceIndex, Index]:
    """Upload with a degradation ladder: on device OOM (or a predicted
    over-budget upload), re-sample the SA to double the rate — halving
    the biggest degradable table — and retry, up to ``max_rate``.

    The analog of the reference's tryAlloc ladder, which walks GPU
    DP block counts {64,48,32,16,8,2} down until allocation succeeds
    (DV-DPfunctions.cu:554-612): correctness is preserved, throughput
    degrades gracefully, and the run proceeds instead of aborting.

    Returns (device index, possibly-resampled host index). hbm_budget
    (bytes) enables the proactive check; without it the ladder is
    purely reactive to allocation failures.
    """
    import sys

    from soap3dp_tpu.index.builder import resample_sa

    while True:
        try:
            if hbm_budget is not None and index_hbm_bytes(index) > hbm_budget:
                raise MemoryError(
                    f"predicted RESOURCE_EXHAUSTED: index needs "
                    f"{index_hbm_bytes(index) / 1e9:.2f} GB of "
                    f"{hbm_budget / 1e9:.2f} GB HBM")
            # wait for every table, so that an upload OOM surfaces
            # inside this handler and the ladder can fire
            didx = jax.block_until_ready(
                device_index(index, sharding=sharding))
            return didx, index
        except (MemoryError, Exception) as e:  # noqa: BLE001 — see below
            # XlaRuntimeError's concrete class moved across jaxlib
            # versions; recognize OOM by content, re-raise the rest
            if not (isinstance(e, MemoryError) or is_oom_error(e)):
                raise
            if index.sa_rate >= max_rate:
                raise
            new_rate = index.sa_rate * 2
            print(f"[soap3dp] device OOM uploading index "
                  f"(sa_rate={index.sa_rate}); degrading to "
                  f"sa_rate={new_rate} "
                  f"(~{index_hbm_bytes(index) / 1e9:.2f} GB -> retry)",
                  file=sys.stderr)
            index = resample_sa(index, new_rate)


# ------------------------------------------------------------------
# Occ queries
# ------------------------------------------------------------------

def _match_bits(word: jax.Array, c: jax.Array) -> jax.Array:
    """One bit per 2-bit base slot of `word` that equals base c."""
    x = word ^ (c.astype(U32) * _LANES)
    return (~(x | (x >> 1))) & _LANES


def _count_in_word(word: jax.Array, c: jax.Array, q: jax.Array) -> jax.Array:
    """#occurrences of base c in the first q (0..15) bases of a BWT word."""
    qm = jnp.where(q == 0, U32(0), _LANES >> (2 * (16 - q)).astype(U32))
    return jax.lax.population_count(_match_bits(word, c) & qm).astype(U32)


def occ(idx: DeviceIndex, c: jax.Array, k: jax.Array) -> jax.Array:
    """Occ(c, k): occurrences of base c in the conceptual BWT[0:k].

    k in [0, n+1); the sentinel row (primary) is skipped via the index
    adjustment, as in the reference (2bwt-lib/BWT.c BWTOccValue).
    Two u32 element gathers + an in-register popcount.
    """
    kp = k - (k > idx.primary).astype(U32)
    w = (kp >> 4).astype(jnp.int32)
    word = jnp.take(idx.bwt, w)
    base = jnp.take(idx.occ, w * 4 + c.astype(jnp.int32))
    return base + _count_in_word(word, c, kp & U32(15))


def backward_extend(idx: DeviceIndex, l: jax.Array, r: jax.Array, c: jax.Array
                    ) -> tuple[jax.Array, jax.Array]:
    """One backward-search step: prepend base c to the current pattern."""
    cc = idx.counts[c.astype(jnp.int32)]
    return cc + occ(idx, c, l), cc + occ(idx, c, r)


# ------------------------------------------------------------------
# Backward search over read segments (the seed search)
# ------------------------------------------------------------------

def backward_search(
    idx: DeviceIndex,
    seqs: jax.Array,     # (B, L) uint8 codes
    start: jax.Array,    # (B,) int32 segment start within the read
    length: jax.Array,   # (B,) int32 segment length (0 allowed -> full interval)
    max_steps: int,      # static bound: max segment length (after LUT jumpstart)
    use_lut: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """SA interval of each read segment, searched right-to-left.

    Fixed-shape: every lane runs ``max_steps`` iterations with masked
    updates. With the LUT jumpstart the first lut_k characters of the
    (right-to-left) search are replaced by one table lookup — the
    reference's LT (2bwt-flex/LT.h:49-56) plays the same role.
    """
    B, L = seqs.shape
    n1 = idx.n + U32(1)
    k = idx.lut_k

    if use_lut:
        # k-mer index of the segment's last k characters, MSB-first.
        tail = start + length - k
        j = jnp.arange(k, dtype=jnp.int32)
        pos = jnp.clip(tail[:, None] + j[None, :], 0, L - 1)
        ch = jnp.take_along_axis(seqs, pos, axis=1).astype(jnp.uint32)
        shifts = (2 * (k - 1 - j)).astype(jnp.uint32)
        m = (ch << shifts[None, :]).sum(axis=1, dtype=jnp.uint32)
        can_lut = length >= k
        l0 = jnp.where(can_lut, idx.lut_lo[m.astype(jnp.int32)], U32(0))
        r0 = jnp.where(can_lut, idx.lut_hi[m.astype(jnp.int32)], n1)
        rem = jnp.where(can_lut, length - k, length)
    else:
        l0 = jnp.zeros((B,), U32)
        r0 = jnp.broadcast_to(n1, (B,))
        rem = length

    def step(s, carry):
        l, r = carry
        # process character at start + rem - 1 - s (right-to-left)
        p = jnp.clip(start + rem - 1 - s, 0, L - 1)
        c = jnp.take_along_axis(seqs, p[:, None], axis=1)[:, 0].astype(U32)
        l2, r2 = backward_extend(idx, l, r, c)
        active = (s < rem) & (l < r)
        return jnp.where(active, l2, l), jnp.where(active, r2, r)

    l, r = jax.lax.fori_loop(0, max_steps, step, (l0, r0))
    return l, r


def rolling_kmer_codes(seqs: jax.Array, k: int) -> jax.Array:
    """(B, L) codes -> (B, L) uint32 MSB-first k-mer code starting at
    each position (positions past L-k are zero-filled = 'A' padded).

    Sequential shift-adds only — the LUT-only seed path uses this to
    avoid materializing per-lane seed characters."""
    B, L = seqs.shape
    s32 = seqs.astype(jnp.uint32)
    km = jnp.zeros((B, L), jnp.uint32)
    for j in range(k):
        shifted = jnp.concatenate(
            [s32[:, j:], jnp.zeros((B, j), jnp.uint32)], axis=1)
        km = km | (shifted << jnp.uint32(2 * (k - 1 - j)))
    return km


def backward_search_packed(
    idx: DeviceIndex,
    roll16: jax.Array,    # (R, L) uint32 rolling 16-char codes (MSB-first)
    seq_rows: jax.Array,  # (B,) int32 oriented-read row of each lane
    start: jax.Array,     # (B,) int32 segment start within the read
    length: jax.Array,    # (B,) int32 segment length (<= lut_k + 16)
    max_steps: int,
) -> tuple[jax.Array, jax.Array]:
    """Seed search where ALL per-lane characters come from TWO u32
    element gathers of a rolling 16-char code array: one word supplies
    the LUT k-mer (its top lut_k chars), one supplies every FM
    extension character in-register.

    Replaces the generic ``backward_search`` on the round-1 hot path:
    that version materializes the (lanes, L) read matrix (a ~100-byte
    row gather per lane) and gathers each k-mer/extension character
    individually. Requires length <= lut_k + 16 so the
    extension window fits one word (the round-2 full-segment re-runs
    keep the generic path).
    """
    k = idx.lut_k
    n1 = idx.n + U32(1)
    R, L = roll16.shape
    r16 = roll16.reshape(-1)
    flat = seq_rows * L
    tail = jnp.clip(start + length - k, 0, L - 1)
    wtail = jnp.take(r16, flat + tail)
    m = (wtail >> jnp.uint32(2 * (16 - k))).astype(jnp.int32)
    can_lut = length >= k
    l0 = jnp.where(can_lut, jnp.take(idx.lut_lo, m), U32(0))
    r0 = jnp.where(can_lut, jnp.take(idx.lut_hi, m), n1)
    # extension characters: positions [start, start + ext) with
    # ext <= 16 all live in the word starting at `start`
    wext = jnp.take(r16, flat + jnp.clip(start, 0, L - 1))
    ext = jnp.where(can_lut, length - k, length)

    def step(s, carry):
        l, r = carry
        d = jnp.clip(ext - 1 - s, 0, 15)
        c = (wext >> (2 * (15 - d)).astype(jnp.uint32)) & U32(3)
        l2, r2 = backward_extend(idx, l, r, c)
        active = (s < ext) & (l < r)
        return jnp.where(active, l2, l), jnp.where(active, r2, r)

    l, r = jax.lax.fori_loop(0, max_steps, step, (l0, r0))
    return l, r


# ------------------------------------------------------------------
# SA decode: row -> text position
# ------------------------------------------------------------------

def sa_decode(idx: DeviceIndex, rows: jax.Array, valid: jax.Array) -> jax.Array:
    """Text position of each SA row via a bounded LF walk.

    Replaces BWTSaValue (2bwt-lib/BWT.c:1694). The walk is exactly
    ``sa_rate`` masked iterations: SA values decrease by 1 per LF step,
    so a row whose value is a multiple of sa_rate is reached within
    sa_rate-1 steps and found via the mark bitvector.

    Full-SA fast path: with sa_rate == 1 every row is marked and
    ``sa_samples`` is the whole suffix array in row order, so the
    decode collapses to ONE u32 gather per row — the gather-friendly
    configuration (the reference's SaValueFreq=1 "full SA" build,
    README.md section 2.1, pays the same memory for the same win).
    """
    if idx.sa_rate == 1:
        # Keep the gather index unsigned: casting to int32 would wrap rows
        # above 2^31 negative at >2 Gbp genome scale and silently clamp.
        safe = jnp.where(valid, rows, U32(0))
        return jnp.where(valid, jnp.take(idx.sa_samples, safe), U32(0))
    rows = jnp.where(valid, rows, U32(0))
    done = ~valid
    # Defer the rank-directory + sample gathers out of the loop: each
    # iteration only needs the mark WORD to know a row is marked; the
    # in-word bit count below the row is in-register math, so recording
    # (mark-word index, bits-below, step) costs no gathers and the walk
    # is 3 element gathers per iteration (mark word + BWT word + occ)
    # instead of 5. One mark_rank + one sa_samples gather finish the job.
    mw_hit = jnp.zeros_like(rows, dtype=jnp.int32)
    below_hit = jnp.zeros_like(rows)
    t_hit = jnp.zeros_like(rows)

    def mark_probe(rows):
        mw = (rows >> 5).astype(jnp.int32)
        word = jnp.take(idx.mark_words, mw)
        bsel = rows & U32(31)
        is_marked = ((word >> bsel) & U32(1)) == U32(1)
        partial = jnp.where(bsel == 0, U32(0),
                            U32(0xFFFFFFFF) >> (U32(32) - bsel))
        below = jax.lax.population_count(word & partial).astype(U32)
        return mw, is_marked, below

    def record(newly, t, mw, below, carry):
        mw_hit, below_hit, t_hit = carry
        return (jnp.where(newly, mw, mw_hit),
                jnp.where(newly, below, below_hit),
                jnp.where(newly, U32(t), t_hit))

    def step(t, carry):
        rows, done, hits = carry
        mw, is_marked, below = mark_probe(rows)
        newly = is_marked & ~done
        hits = record(newly, t, mw, below, hits)
        done = done | is_marked
        # --- LF step (BWT word + occ count: 2 element gathers) ---
        kp = rows - (rows > idx.primary).astype(U32)
        wsel = (kp >> 4).astype(jnp.int32)
        word_b = jnp.take(idx.bwt, wsel)
        q = kp & U32(15)
        c = (word_b >> (2 * q)) & U32(3)
        base = jnp.take(idx.occ, wsel * 4 + c.astype(jnp.int32))
        lf = idx.counts[c.astype(jnp.int32)] + base + _count_in_word(word_b, c, q)
        rows = jnp.where(done, rows, lf)
        return rows, done, hits

    hits = (mw_hit, below_hit, t_hit)
    rows, done, hits = jax.lax.fori_loop(
        0, idx.sa_rate - 1, step, (rows, done, hits))
    # final iteration: a value-sampled SA guarantees a mark within
    # sa_rate steps, so the last LF would be dead work — probe only
    mw, is_marked, below = mark_probe(rows)
    hits = record(is_marked & ~done, idx.sa_rate - 1, mw, below, hits)
    mw_hit, below_hit, t_hit = hits

    rank = jnp.take(idx.mark_rank, mw_hit) + below_hit
    value = jnp.take(
        idx.sa_samples,
        jnp.minimum(rank, U32(len(idx.sa_samples) - 1)).astype(jnp.int32))
    return jnp.where(valid, value + t_hit, U32(0))


# ------------------------------------------------------------------
# Check-and-extend verification against the packed genome
# ------------------------------------------------------------------

def extract_genome(idx: DeviceIndex, tp: jax.Array, L: int) -> jax.Array:
    """Genome codes at [tp, tp+L) as (M, L) uint8-like uint32 values.

    One contiguous gather of ceil(L/16)+1 words per lane, then an
    in-register funnel shift to align to the 2-bit grid.
    """
    W = (L + 15) // 16 + 1
    w0 = (tp >> 4).astype(jnp.int32)
    j = jnp.arange(W, dtype=jnp.int32)[None, :]
    words = idx.pac[jnp.clip(w0[:, None] + j, 0, idx.pac.shape[0] - 1)]  # (M, W)
    sh = (2 * (tp & U32(15)))[:, None]
    lo = words[:, :-1] >> sh
    hi_sh = (U32(32) - sh) & U32(31)
    hi = jnp.where(sh == 0, U32(0), words[:, 1:] << hi_sh)
    aligned = lo | hi                                        # (M, W-1)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    codes = (aligned[:, :, None] >> shifts) & U32(3)
    return codes.reshape(codes.shape[0], -1)[:, :L]


def count_mismatches(
    idx: DeviceIndex,
    tp: jax.Array,        # (M,) uint32 candidate text positions
    reads: jax.Array,     # (M, L) uint8 codes (already strand-oriented)
    read_len: jax.Array,  # (M,) int32
) -> jax.Array:
    """Hamming distance between each read and the genome window at tp."""
    L = reads.shape[1]
    g = extract_genome(idx, tp, L)
    pos_ok = jnp.arange(L, dtype=jnp.int32)[None, :] < read_len[:, None]
    mism = (g != reads.astype(U32)) & pos_ok
    return mism.sum(axis=1).astype(jnp.int32)


def pack_reads(codes: jax.Array, max_len: int | None = None) -> jax.Array:
    """Pack (B, L) uint8 codes into (B, ceil(L/16)) uint32 words (device).

    Same LSB-first 2-bit layout as the genome, so verification is a
    pure word-domain XOR/popcount (the batched equivalent of the
    reference's SSE check-and-extend, ssse3_popcount.cpp).
    """
    B, L = codes.shape
    W = ((max_len or L) + 15) // 16
    padded = jnp.zeros((B, W * 16), dtype=U32).at[:, :L].set(codes.astype(U32))
    lanes = padded.reshape(B, W, 16)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    return (lanes << shifts).sum(axis=-1, dtype=U32)


def aligned_genome_words(idx: DeviceIndex, tp: jax.Array, W: int) -> jax.Array:
    """Packed genome words for [tp, tp+16*W), funnel-shifted to the 2-bit grid."""
    w0 = (tp >> 4).astype(jnp.int32)
    j = jnp.arange(W + 1, dtype=jnp.int32)[None, :]
    words = idx.pac[jnp.clip(w0[:, None] + j, 0, idx.pac.shape[0] - 1)]  # (M, W+1)
    sh = (2 * (tp & U32(15)))[:, None]
    lo = words[:, :-1] >> sh
    hi = jnp.where(sh == 0, U32(0), words[:, 1:] << ((U32(32) - sh) & U32(31)))
    return lo | hi  # (M, W)


def count_mismatches_packed(
    idx: DeviceIndex,
    tp: jax.Array,          # (M,) uint32 candidate text positions
    read_words: jax.Array,  # (M, W) uint32 packed oriented reads
    read_len: jax.Array,    # (M,) int32
) -> jax.Array:
    """Hamming distance in the packed 2-bit domain: one XOR+popcount per word."""
    M, W = read_words.shape
    g = aligned_genome_words(idx, tp, W)
    x = g ^ read_words
    bits = (x | (x >> 1)) & _LANES  # one bit per mismatching base slot
    j16 = jnp.arange(W, dtype=jnp.int32)[None, :] * 16
    m = jnp.clip(read_len[:, None] - j16, 0, 16)
    lane_mask = jnp.where(m == 0, U32(0), _LANES >> (2 * (16 - m)).astype(U32))
    return jax.lax.population_count(bits & lane_mask).sum(axis=1).astype(jnp.int32)


def revcomp_reads(reads: jax.Array, lens: jax.Array) -> jax.Array:
    """Reverse-complement length-aware: rc[i] = 3 - read[len-1-i], zero-padded."""
    B, L = reads.shape
    i = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = jnp.clip(lens[:, None] - 1 - i, 0, L - 1)
    vals = 3 - jnp.take_along_axis(reads, src, axis=1)
    return jnp.where(i < lens[:, None], vals, 0).astype(reads.dtype)


def revcomp_reads_uniform(reads: jax.Array, n: int) -> jax.Array:
    """revcomp_reads for a batch whose reads ALL have length ``n``
    (static): a lane reversal instead of a per-element gather.
    Callers check uniformity host-side."""
    B, L = reads.shape
    rc = (3 - jnp.flip(reads[:, :n], axis=1)).astype(reads.dtype)
    if n == L:
        return rc
    return jnp.concatenate(
        [rc, jnp.zeros((B, L - n), reads.dtype)], axis=1)
