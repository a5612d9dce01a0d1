"""End-to-end pipeline tests: reads in, SAM records out."""

import io

import numpy as np
import pytest

from soap3dp_tpu.io.fastq import ReadBatch
from soap3dp_tpu.io.sam import SamWriter
from soap3dp_tpu.pipeline.options import AlignOptions
from soap3dp_tpu.pipeline.pair import align_pair_batch
from soap3dp_tpu.pipeline.single import align_single_batch
from soap3dp_tpu.utils import dna


def make_batch(seqs: list[np.ndarray], max_len=64) -> ReadBatch:
    B = len(seqs)
    codes = np.zeros((B, max_len), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = s
        lens[i] = len(s)
    names = [f"r{i}".encode() for i in range(B)]
    return ReadBatch(names=names, codes=codes, lens=lens, quals=None)


def run_single(index, didx, batch, **kw):
    opts = AlignOptions(**kw)
    buf = io.BytesIO()
    w = SamWriter(buf, index)
    summary = align_single_batch(index, didx, batch, opts, w)
    return summary, parse_sam(buf.getvalue())


def run_pair(index, didx, b1, b2, **kw):
    opts = AlignOptions(**kw)
    buf = io.BytesIO()
    w = SamWriter(buf, index)
    summary = align_pair_batch(index, didx, b1, b2, opts, w)
    return summary, parse_sam(buf.getvalue())


def parse_sam(data: bytes):
    recs = []
    for line in data.decode().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        recs.append(dict(
            qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]),
            mapq=int(f[4]), cigar=f[5], rnext=f[6], pnext=int(f[7]),
            tlen=int(f[8]), seq=f[9], qual=f[10],
            tags={t.split(":")[0]: t.split(":", 2)[2] for t in f[11:]}))
    return recs


def cigar_read_span(cigar: str) -> int:
    span = n = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            if ch in "MIS=X":
                span += n
            n = 0
    return span


@pytest.fixture(scope="module")
def planted(small_genome):
    codes = small_genome.codes
    L = 50
    # dedicated rng: planted positions must not depend on test order
    pos = np.random.default_rng(777).integers(100, len(codes) - 200, size=8)
    return codes, L, pos


def test_single_exact_and_mismatch(small_index, small_device_index, planted, rng):
    codes, L, pos = planted
    seqs = []
    for i, p in enumerate(pos[:4]):
        s = codes[p:p + L].copy()
        if i >= 2:
            s[10] = (s[10] + 1) % 4  # one planted mismatch
        if i % 2 == 1:
            s = dna.revcomp_codes(s)
        seqs.append(s)
    seqs.append(rng.integers(0, 4, L).astype(np.uint8))  # junk, likely unmapped
    batch = make_batch(seqs)
    summary, recs = run_single(small_index, small_device_index, batch,
                               max_mismatches=2, output_md=True)
    assert summary.num_reads == 5
    byname = {r["qname"]: r for r in recs}
    for i, p in enumerate(pos[:4]):
        r = byname[f"r{i}"]
        assert r["pos"] == p + 1, i
        assert (r["flag"] & 0x10 != 0) == (i % 2 == 1)
        assert r["cigar"] == f"{L}M"
        assert int(r["tags"]["XM"]) == (1 if i >= 2 else 0)
        assert int(r["tags"]["NM"]) == (1 if i >= 2 else 0)
        assert r["mapq"] == 37  # unique hits, bwa-like
        # SEQ is output in reference orientation
        assert cigar_read_span(r["cigar"]) == len(r["seq"])


def test_single_dp_rescues_indel(small_index, small_device_index, planted):
    codes, L, pos = planted
    p = int(pos[4])
    s = codes[p:p + L].copy()
    s = np.concatenate([s[:35], s[38:]])  # 3bp deletion in the read
    batch = make_batch([s])
    summary, recs = run_single(small_index, small_device_index, batch,
                               output_md=True)  # DP enabled (no -s)
    assert summary.aligned_dp == 1
    r = recs[0]
    assert r["pos"] == p + 1
    assert "D" in r["cigar"]
    assert r["cigar"] == "35M3D12M"
    assert int(r["tags"]["NM"]) == 3
    assert r["tags"]["MD"].startswith("35^")


def test_single_insertion(small_index, small_device_index, planted):
    codes, L, pos = planted
    p = int(pos[5])
    s = codes[p:p + L].copy()
    s = np.concatenate([s[:30], np.array([(s[30] + 2) % 4] * 2, np.uint8), s[30:]])
    batch = make_batch([s])
    summary, recs = run_single(small_index, small_device_index, batch)
    assert summary.aligned_dp == 1
    assert recs[0]["pos"] == p + 1
    assert "I" in recs[0]["cigar"]


def test_single_output_modes(small_index, small_device_index, small_genome, rng):
    codes = small_genome.codes
    # construct a read that occurs at 2+ places: append a repeat to test
    p = int(rng.integers(0, len(codes) - 40))
    s = codes[p:p + 30]
    batch = make_batch([s.copy()])
    for mode in (1, 2, 3, 4):
        summary, recs = run_single(small_index, small_device_index, batch,
                                   max_mismatches=0, output_mode=mode)
        assert len(recs) == 1
        assert recs[0]["flag"] & 0x4 == 0


def test_pair_proper(small_index, small_device_index, small_genome, rng):
    codes = small_genome.codes
    L = 40
    insert = 200
    p = int(rng.integers(100, len(codes) - 500))
    left = codes[p:p + L].copy()
    right = dna.revcomp_codes(codes[p + insert - L:p + insert])
    b1 = make_batch([left])
    b2 = make_batch([right])
    summary, recs = run_pair(small_index, small_device_index, b1, b2,
                             min_insert=100, max_insert=300)
    assert summary.paired_bwt == 1
    r1 = next(r for r in recs if r["flag"] & 0x40)
    r2 = next(r for r in recs if r["flag"] & 0x80)
    assert r1["flag"] & 0x2 and r2["flag"] & 0x2
    assert r1["pos"] == p + 1
    assert r2["pos"] == p + insert - L + 1
    assert r1["tlen"] == insert and r2["tlen"] == -insert
    assert not r1["flag"] & 0x10 and r2["flag"] & 0x10
    assert r1["rnext"] == "="


def test_pair_proper_variable_lengths(small_index, small_device_index,
                                      small_genome, rng):
    """PE fast path with ragged read lengths AND paired != arange.

    Regression (ADVICE r4 high): the columnar fast path indexed the
    full-batch lens arrays with positions in the `paired` subset, so
    when an earlier pair fails, later pairs got the WRONG read's
    length for CIGAR/SEQ/QUAL truncation."""
    codes = small_genome.codes
    insert = 200
    lens = [36, 44, 52, 60]
    seqs1, seqs2 = [], []
    # pair 0: unmappable garbage so `paired` skips index 0
    seqs1.append(np.asarray(rng.integers(0, 4, 36), np.uint8))
    seqs2.append(np.asarray(rng.integers(0, 4, 36), np.uint8))
    starts = []
    for L in lens[1:]:
        p = int(rng.integers(100, len(codes) - 500))
        starts.append(p)
        seqs1.append(codes[p:p + L].copy())
        seqs2.append(dna.revcomp_codes(codes[p + insert - L:p + insert]))
    b1 = make_batch(seqs1)
    b2 = make_batch(seqs2)
    summary, recs = run_pair(small_index, small_device_index, b1, b2,
                             min_insert=100, max_insert=300)
    assert summary.paired_bwt >= 3
    for i, L in enumerate(lens[1:], start=1):
        r1 = next(r for r in recs
                  if r["qname"] == f"r{i}" and r["flag"] & 0x40)
        r2 = next(r for r in recs
                  if r["qname"] == f"r{i}" and r["flag"] & 0x80)
        for r in (r1, r2):
            assert cigar_read_span(r["cigar"]) == L, (i, L, r["cigar"])
            assert len(r["seq"]) == L, (i, L, len(r["seq"]))
        assert r1["pos"] == starts[i - 1] + 1


def test_pair_half_aligned_rescue(small_index, small_device_index,
                                  small_genome, rng):
    codes = small_genome.codes
    L = 40
    insert = 180
    p = int(rng.integers(100, len(codes) - 500))
    left = codes[p:p + L].copy()
    right_src = codes[p + insert - L:p + insert].copy()
    # give the mate an indel so the BWT stage can't place it
    right_src = np.concatenate([right_src[:15], right_src[18:]])
    right = dna.revcomp_codes(right_src)
    b1 = make_batch([left])
    b2 = make_batch([right])
    summary, recs = run_pair(small_index, small_device_index, b1, b2,
                             min_insert=100, max_insert=300)
    assert summary.paired_dp == 1
    r2 = next(r for r in recs if r["flag"] & 0x80)
    assert "D" in r2["cigar"]
    assert r2["pos"] == p + insert - L + 1
    assert r2["flag"] & 0x2


def test_pair_deep_dp(small_index, small_device_index, small_genome, rng):
    codes = small_genome.codes
    L = 48
    insert = 220
    p = int(rng.integers(100, len(codes) - 500))
    left = codes[p:p + L].copy()
    right_src = codes[p + insert - L:p + insert].copy()
    # both ends get indels -> deep DP path
    left = np.concatenate([left[:22], left[24:]])
    right_src = np.concatenate([right_src[:25], right_src[27:]])
    right = dna.revcomp_codes(right_src)
    b1 = make_batch([left])
    b2 = make_batch([right])
    summary, recs = run_pair(small_index, small_device_index, b1, b2,
                             min_insert=100, max_insert=300)
    assert summary.paired_dp == 1
    r1 = next(r for r in recs if r["flag"] & 0x40)
    assert r1["pos"] == p + 1
    assert "D" in r1["cigar"]


def test_pair_single_salvage(small_index, small_device_index, small_genome,
                             rng):
    """Phase E: one end real, mate garbage and no insert-window rescue —
    the real end must come back as an unpaired aligned record."""
    codes = small_genome.codes
    L = 50
    p = 5000
    good = codes[p:p + L].copy()
    good[7] = (good[7] + 1) % 4
    junk = rng.integers(0, 4, L).astype(np.uint8)
    summary, recs = run_pair(small_index, small_device_index,
                             make_batch([good]), make_batch([junk]),
                             min_insert=1, max_insert=60)  # window too tight
    r1 = next(r for r in recs if r["flag"] & 0x40)
    assert not r1["flag"] & 0x4, "real end must align"
    assert r1["pos"] == p + 1
    assert r1["flag"] & 0x1  # still flagged paired
    assert summary.single_rescued >= 1


def test_pair_unmapped(small_index, small_device_index, rng):
    b1 = make_batch([rng.integers(0, 4, 40).astype(np.uint8)])
    b2 = make_batch([rng.integers(0, 4, 40).astype(np.uint8)])
    summary, recs = run_pair(small_index, small_device_index, b1, b2)
    assert len(recs) == 2
    # ends may DP-salvage by chance on a 20kb genome; just require both
    # records present with pair flags
    assert all(r["flag"] & 0x1 for r in recs)


def test_long_reads_200bp(small_index, small_device_index, small_genome):
    """Long-read path (reference: >120bp reads seed on a prefix then DP,
    alignment.cu:2475-2491; here the pigeonhole segments scale and the
    DP falls back to the scan kernel for Lr+1 > 128)."""
    codes = small_genome.codes
    rng2 = np.random.default_rng(42)
    L = 200
    pos = rng2.integers(100, len(codes) - 400, 3)
    seqs = []
    for i, p in enumerate(pos):
        s = codes[p:p + L].copy()
        s[50] = (s[50] + 1) % 4
        if i == 2:  # 4bp deletion: needs DP rescue
            s = np.concatenate([s[:80], codes[p + 84:p + 84 + L - 80]])
        seqs.append(s)
    batch = make_batch(seqs, max_len=256)
    summary, recs = run_single(small_index, small_device_index, batch,
                               max_read_len=256)
    byname = {r["qname"]: r for r in recs}
    for i, p in enumerate(pos):
        r = byname[f"r{i}"]
        assert not r["flag"] & 0x4, i
        assert r["pos"] == p + 1, i
        if i == 2:
            assert "D" in r["cigar"]
        else:
            assert r["cigar"] == f"{L}M"


def test_long_reads_250bp_pair(small_index, small_device_index, small_genome):
    """250bp paired-end: the fused DP kernel's lane-budget boundary
    (256-lane state covers Lr <= 255) end-to-end through phases A-E."""
    codes = small_genome.codes
    rng2 = np.random.default_rng(43)
    L, insert = 250, 700
    pos = rng2.integers(100, len(codes) - insert - 100, 4)
    s1, s2 = [], []
    for i, p in enumerate(pos):
        left = codes[p:p + L].copy()
        right = dna.revcomp_codes(codes[p + insert - L:p + insert])
        left[30] = (left[30] + 1) % 4
        if i == 3:  # 5bp deletion in the mate: half-aligned DP rescue
            right = np.concatenate(
                [right[:100], dna.revcomp_codes(
                    codes[p + insert - L - 5:p + insert - 105])])[:L]
        s1.append(left)
        s2.append(right)
    b1 = make_batch(s1, max_len=256)
    b2 = make_batch(s2, max_len=256)
    summary, recs = run_pair(small_index, small_device_index, b1, b2,
                             max_read_len=256, min_insert=400,
                             max_insert=1000)
    assert summary.paired_bwt + summary.paired_dp == 4
    byname = {}
    for r in recs:
        byname.setdefault(r["qname"], []).append(r)
    for i, p in enumerate(pos):
        rr = sorted(byname[f"r{i}"], key=lambda r: r["pos"])
        assert len(rr) == 2
        assert rr[0]["pos"] == p + 1, i
        assert not (rr[0]["flag"] & 0x4) and not (rr[1]["flag"] & 0x4)


def test_long_reads_300bp_scan_fallback(small_index, small_device_index,
                                        small_genome):
    """Reads past the 255bp fused-kernel cap still align end-to-end via
    the scan DP path (VERDICT r2 item 8)."""
    codes = small_genome.codes
    rng2 = np.random.default_rng(44)
    L = 300
    pos = rng2.integers(100, len(codes) - 400, 3)
    seqs = []
    for i, p in enumerate(pos):
        s = codes[p:p + L].copy()
        s[123] = (s[123] + 1) % 4
        if i == 1:  # 6bp insertion: DP rescue
            s = np.concatenate([s[:150], rng2.integers(0, 4, 6).astype(np.uint8),
                                s[150:]])[:L]
        seqs.append(s)
    batch = make_batch(seqs, max_len=L)
    summary, recs = run_single(small_index, small_device_index, batch,
                               max_read_len=L)
    byname = {r["qname"]: r for r in recs}
    for i, p in enumerate(pos):
        r = byname[f"r{i}"]
        assert not r["flag"] & 0x4, i
        assert r["pos"] == p + 1, i
        if i == 1:
            assert "I" in r["cigar"]


def test_pair_half_rescue_seeded_round(small_index, small_device_index,
                                       small_genome, rng):
    """Optional phase-B seeded mate rescue (half_rescue_seeded=True)."""
    codes = small_genome.codes
    L = 40
    insert = 180
    p = int(rng.integers(100, len(codes) - 500))
    left = codes[p:p + L].copy()
    right_src = codes[p + insert - L:p + insert].copy()
    right_src[5] = (right_src[5] + 1) % 4
    right_src[15] = (right_src[15] + 1) % 4
    right_src[25] = (right_src[25] + 1) % 4  # 3 mismatches: BWT misses at k=2
    right = dna.revcomp_codes(right_src)
    summary, recs = run_pair(small_index, small_device_index,
                             make_batch([left]), make_batch([right]),
                             min_insert=100, max_insert=300,
                             half_rescue_seeded=True)
    assert summary.paired_dp == 1
    r2 = next(r for r in recs if r["flag"] & 0x80)
    assert r2["pos"] == p + insert - L + 1
    assert r2["flag"] & 0x2


def test_repetitive_genome_full_hit_sets_and_pairing(rng):
    """Reference semantics for super-repetitive reads (VERDICT r1 item 4):

    - reads whose seed intervals overflow even the round-2 budget get a
      bounded third pass (the analog of the reference's host full
      re-alignment, ProcessReadDoubleStrand2, CPUfunctions.cpp:555), so
      their full placement set is reported instead of zero hits;
    - pairing honors MaxHitsEachEndForPairing (default 8000, not a
      64-hit cap): each of the ~400 per-end placements pairs with its
      window mates (PEMappingOccurrences, PEAlgnmt.cpp:480).
    """
    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.fm.search import SearchConfig, search_reads
    from soap3dp_tpu.index.builder import build_index
    from soap3dp_tpu.pipeline import hits as H
    from soap3dp_tpu.pipeline.pair import pair_hits
    from tests.conftest import make_genome

    copies, unit_len = 400, 200
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    flank1 = rng.integers(0, 4, 4000).astype(np.uint8)
    flank2 = rng.integers(0, 4, 4000).astype(np.uint8)
    codes = np.concatenate([flank1, np.tile(unit, copies), flank2])
    from soap3dp_tpu.index.packing import PackedGenome
    genome = PackedGenome(
        codes=codes, pac=dna.pack_codes(codes), length=len(codes),
        names=["chrR"], offsets=np.asarray([0, len(codes)], np.uint64),
        amb_starts=np.zeros(0, np.uint64), amb_lengths=np.zeros(0, np.uint64))
    index = build_index(genome, sa_rate=4, lut_k=8)
    didx = device_index(index)

    # a proper pair inside one unit: insert 150, both ends 36bp
    L, insert = 36, 150
    off = 4000 + 7 * unit_len + 10
    left = codes[off:off + L]
    right = dna.revcomp_codes(codes[off + insert - L:off + insert])
    b1 = make_batch([left], max_len=L)
    b2 = make_batch([right], max_len=L)

    # every end must report ~`copies` placements (round 3 resolved them)
    h = search_reads(didx, b1.codes, b1.lens.astype(np.int32),
                     SearchConfig(k=2))
    t = H.hits_to_table(h, 1, index, b1.lens.astype(np.int32))
    assert not t.flagged[0], "round 3 must resolve a 400-copy repeat"
    assert t.counts()[0] >= copies - 1
    exp = 4000 + 10 + unit_len * np.arange(copies)
    assert set(exp.tolist()) <= set(t.pos[t.strand == 0].tolist())

    # pairing: full per-end hit sets, one proper pair per copy
    summary, recs = run_pair(index, didx, b1, b2,
                             min_insert=100, max_insert=300)
    assert summary.paired_bwt == 1
    t1 = H.hits_to_table(h, 1, index, b1.lens.astype(np.int32))
    h2 = search_reads(didx, b2.codes, b2.lens.astype(np.int32),
                      SearchConfig(k=2))
    t2 = H.hits_to_table(h2, 1, index, b2.lens.astype(np.int32))
    combos = pair_hits(t1, t2, 1, b1.lens.astype(np.int32),
                       b2.lens.astype(np.int32),
                       AlignOptions(min_insert=100, max_insert=300))
    n_pairs = int(combos.start[1] - combos.start[0])
    assert n_pairs >= copies - 1, n_pairs
    assert (combos.insert == insert).all()


def test_table_mapq_uses_real_mismatch_qualities(small_index,
                                                 small_device_index,
                                                 small_genome, rng):
    """Table-mode MAPQ must feed the REAL average mismatch base quality
    (BGS-IO.cpp:2331-2367), not a constant: the same 2-mismatch read
    scores differently with low- vs high-quality mismatched bases."""
    codes = small_genome.codes
    L = 40
    p = int(rng.integers(0, len(codes) - L))
    read = codes[p:p + L].copy()
    read[10] = (read[10] + 1) % 4
    read[25] = (read[25] + 2) % 4

    def run(mis_q):
        quals = np.full((1, L), 33 + 38, np.uint8)   # high everywhere
        quals[0, 10] = quals[0, 25] = 33 + mis_q
        b = ReadBatch(names=[b"r0"], codes=read[None, :].copy(),
                      lens=np.full(1, L, np.int32), quals=quals)
        _, recs = run_single(small_index, small_device_index, b,
                             bwa_like_score=False)
        return recs[0]["mapq"]

    lo, hi = run(2), run(38)
    assert lo != hi, (lo, hi)
    # low-quality mismatches are more forgivable -> higher MAPQ
    assert lo > hi


def test_rescue_queue_matches_inline():
    """Deferred cross-batch rescue (RescueQueue) must produce exactly
    the records of the inline phases, just in flushed order."""
    import __graft_entry__ as g
    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.pipeline.pair import RescueQueue, align_pair_batch

    index, b1, b2, opts = g.make_tiny_pair_workload(n_pairs=36, seed=3)
    didx = device_index(index)

    w_in = g._CollectWriter()
    s_in = align_pair_batch(index, didx, b1, b2, opts, w_in)

    def half(b, sl):
        return type(b)(names=b.names[sl], codes=b.codes[sl],
                       lens=b.lens[sl], quals=None)

    w_q = g._CollectWriter()
    rq = RescueQueue(index, didx, opts)
    s_q = align_pair_batch(index, didx, half(b1, slice(0, 18)),
                           half(b2, slice(0, 18)), opts, w_q,
                           rescue_queue=rq)
    s_q.add(align_pair_batch(index, didx, half(b1, slice(18, 36)),
                             half(b2, slice(18, 36)), opts, w_q,
                             rescue_queue=rq))
    s_q.add(rq.flush(w_q))

    assert (s_in.paired_bwt, s_in.paired_dp, s_in.single_rescued,
            s_in.unaligned, s_in.num_records) == \
           (s_q.paired_bwt, s_q.paired_dp, s_q.single_rescued,
            s_q.unaligned, s_q.num_records)

    def keyset(w):
        return sorted((r.qname, r.flag, r.chrom, r.pos, r.mapq, r.cigar,
                       r.mate_chrom, r.mate_pos, r.tlen, tuple(r.tags))
                      for r in w.records)

    assert keyset(w_in) == keyset(w_q)


def test_salvage_queue_matches_inline(small_index, small_device_index,
                                      small_genome, rng):
    """Single-end deferred salvage must match the inline path."""
    from soap3dp_tpu.pipeline.single import SalvageQueue, align_single_batch

    codes = small_genome.codes
    L = 40
    seqs = []
    for i in range(24):
        p = int(rng.integers(0, len(codes) - L))
        s = codes[p:p + L].copy()
        if i % 3 == 1:   # indel -> BWT fails, DP salvage succeeds
            s = np.concatenate([s[:15], s[18:], rng.integers(0, 4, 3)
                                .astype(np.uint8)])[:L]
        elif i % 3 == 2:  # garbage -> unmapped
            s = rng.integers(0, 4, L).astype(np.uint8)
        seqs.append(s)
    b = make_batch(seqs, max_len=L)
    opts = AlignOptions()

    import io as _io
    w1 = SamWriter(_io.BytesIO(), small_index)
    s1 = align_single_batch(small_index, small_device_index, b, opts, w1)

    w2 = SamWriter(_io.BytesIO(), small_index)
    sq = SalvageQueue(small_index, small_device_index, opts)
    s2 = align_single_batch(small_index, small_device_index, b, opts, w2,
                            salvage_queue=sq)
    s2.add(sq.flush(w2))

    assert (s1.aligned_bwt, s1.aligned_dp, s1.unaligned, s1.num_records) == \
           (s2.aligned_bwt, s2.aligned_dp, s2.unaligned, s2.num_records)
    r1 = sorted(l for l in w1._fh.getvalue().decode().splitlines()
                if not l.startswith("@"))
    r2 = sorted(l for l in w2._fh.getvalue().decode().splitlines()
                if not l.startswith("@"))
    assert r1 == r2


@pytest.mark.parametrize("k", [2, 3, 4])
def test_phased_search_matches_full(small_index, small_device_index,
                                    small_genome, rng, k):
    """The phased scheme (segments {0,1} first, escalate unresolved
    pairs to the remaining segments — the reference's staged phases,
    all_best_alignment alignment.cu:1236) must produce the same records
    as the one-shot full search: escalated pairs see the complete <= k
    set by construction, and resolved pairs are complete at their
    phase-1 level. Parametrized over the -s range the bench and the
    reference use (k = 2..4, DV-Kernel.cu:4505-4741)."""
    from soap3dp_tpu.fm.search import PendingSearch, SearchConfig
    from soap3dp_tpu.pipeline.pair import align_pair_batch as apb

    codes = small_genome.codes
    L, insert, N = 60, 200, 48
    seqs1, seqs2 = [], []
    for i in range(N):
        p = int(rng.integers(100, len(codes) - 400))
        left = codes[p:p + L].copy()
        right = codes[p + insert - L:p + insert].copy()
        # plant 0..k mismatches per end: pairs with ends >= 2 exercise
        # the escalation path, <= 1 the resolved path
        for seq, m in ((left, i % (k + 1)), (right, (i // 3) % (k + 1))):
            for pos in rng.choice(L, size=m, replace=False):
                seq[pos] = (seq[pos] + 1 + rng.integers(3)) % 4
        seqs1.append(left)
        seqs2.append(dna.revcomp_codes(right))
    b1 = make_batch(seqs1, max_len=L)
    b2 = make_batch(seqs2, max_len=L)

    outs = []
    for phased in (False, True):
        opts = AlignOptions(min_insert=100, max_insert=300,
                            soap3_mismatch_allow=k)
        pend = None
        if phased:
            lens1 = b1.lens.astype(np.int32)
            lens2 = b2.lens.astype(np.int32)
            cfg = SearchConfig(k=opts.effective_mismatches(L))
            assert cfg.num_seeds > 2  # (0, 2) must be a real restriction
            pend = PendingSearch(
                small_device_index,
                np.concatenate([b1.codes, b2.codes]),
                np.concatenate([lens1, lens2]), cfg, seed_range=(0, 2))
        buf = io.BytesIO()
        w = SamWriter(buf, small_index)
        summary = apb(small_index, small_device_index, b1, b2, opts, w,
                      pending_search=pend)
        outs.append((summary, sorted(
            l for l in buf.getvalue().decode().splitlines()
            if not l.startswith("@"))))
    (s_full, r_full), (s_ph, r_ph) = outs
    assert s_ph.paired_bwt == s_full.paired_bwt == N
    assert s_ph.num_records == s_full.num_records
    assert r_ph == r_full


def test_phased_single_matches_full(small_index, small_device_index,
                                    small_genome, rng):
    """Single-end phased search must emit the same records as the
    one-shot full search (same construction as the PE equivalence)."""
    from soap3dp_tpu.fm.search import PendingSearch, SearchConfig
    from soap3dp_tpu.pipeline.single import align_single_batch as asb

    codes = small_genome.codes
    L, N = 60, 48
    seqs = []
    for i in range(N):
        p = int(rng.integers(100, len(codes) - 200))
        s = codes[p:p + L].copy()
        for pos in rng.choice(L, size=i % 3, replace=False):
            s[pos] = (s[pos] + 1 + rng.integers(3)) % 4
        seqs.append(s)
    batch = make_batch(seqs, max_len=L)

    outs = []
    for phased in (False, True):
        opts = AlignOptions()
        pend = None
        if phased:
            cfg = SearchConfig(k=opts.effective_mismatches(L))
            assert cfg.num_seeds > 2
            pend = PendingSearch(small_device_index, batch.codes,
                                 batch.lens.astype(np.int32), cfg,
                                 seed_range=(0, 2))
        buf = io.BytesIO()
        w = SamWriter(buf, small_index)
        summary = asb(small_index, small_device_index, batch, opts, w,
                      pending_search=pend)
        outs.append((summary, sorted(
            l for l in buf.getvalue().decode().splitlines()
            if not l.startswith("@"))))
    (s_full, r_full), (s_ph, r_ph) = outs
    assert s_ph.aligned_bwt == s_full.aligned_bwt == N
    assert r_ph == r_full


def test_phase2_queue_deferred(small_index, small_device_index,
                               small_genome, rng):
    """The deferred Phase2Queue path (escalations finished one batch
    later + drained at end) must emit the same records as the inline
    phased path."""
    from soap3dp_tpu.fm.search import PendingSearch, SearchConfig
    from soap3dp_tpu.pipeline.pair import (Phase2Queue, RescueQueue,
                                           align_pair_batch as apb)

    codes = small_genome.codes
    L, insert, N = 60, 200, 40
    seqs1, seqs2 = [], []
    for i in range(N):
        p = int(rng.integers(100, len(codes) - 400))
        left = codes[p:p + L].copy()
        right = codes[p + insert - L:p + insert].copy()
        for seq, m in ((left, i % 3), (right, (i // 2) % 3)):
            for pos in rng.choice(L, size=m, replace=False):
                seq[pos] = (seq[pos] + 1 + rng.integers(3)) % 4
        seqs1.append(left)
        seqs2.append(dna.revcomp_codes(right))
    b1 = make_batch(seqs1, max_len=L)
    b2 = make_batch(seqs2, max_len=L)
    opts = AlignOptions(min_insert=100, max_insert=300)
    lens1 = b1.lens.astype(np.int32)
    lens2 = b2.lens.astype(np.int32)
    cfg = SearchConfig(k=opts.effective_mismatches(L))

    def run(deferred):
        buf = io.BytesIO()
        w = SamWriter(buf, small_index)
        rq = RescueQueue(small_index, small_device_index, opts)
        p2q = Phase2Queue(small_index, small_device_index, opts) \
            if deferred else None
        total = None
        for _ in range(2):  # two identical batches through the pipeline
            pend = PendingSearch(
                small_device_index,
                np.concatenate([b1.codes, b2.codes]),
                np.concatenate([lens1, lens2]), cfg, seed_range=(0, 2))
            s = apb(small_index, small_device_index, b1, b2, opts, w,
                    pending_search=pend, rescue_queue=rq,
                    phase2_queue=p2q)
            total = s if total is None else (total.add(s) or total)
        if p2q is not None:
            total.add(p2q.process(w, rq))
        total.add(rq.flush(w))
        return total, sorted(
            l for l in buf.getvalue().decode().splitlines()
            if not l.startswith("@"))

    (t_in, r_in), (t_df, r_df) = run(False), run(True)
    assert t_df.paired_bwt == t_in.paired_bwt
    assert t_df.num_records == t_in.num_records == 4 * N
    assert r_df == r_in


def test_single_phase2_queue_deferred(small_index, small_device_index,
                                      small_genome, rng):
    """The deferred SE phase-2 path (escalations finished one batch
    later + drained at end) must emit the same records as the inline
    phased path."""
    from soap3dp_tpu.fm.search import PendingSearch, SearchConfig
    from soap3dp_tpu.pipeline.single import (SalvageQueue,
                                             SinglePhase2Queue,
                                             align_single_batch as asb)

    codes = small_genome.codes
    L, N = 60, 40
    seqs = []
    for i in range(N):
        p = int(rng.integers(100, len(codes) - 200))
        s = codes[p:p + L].copy()
        for pos in rng.choice(L, size=i % 3, replace=False):
            s[pos] = (s[pos] + 1 + rng.integers(3)) % 4
        seqs.append(s)
    batch = make_batch(seqs, max_len=L)
    opts = AlignOptions()
    cfg = SearchConfig(k=opts.effective_mismatches(L))

    def run(deferred):
        buf = io.BytesIO()
        w = SamWriter(buf, small_index)
        sq = SalvageQueue(small_index, small_device_index, opts)
        p2q = SinglePhase2Queue(small_index, small_device_index, opts) \
            if deferred else None
        total = None
        for _ in range(2):
            pend = PendingSearch(small_device_index, batch.codes,
                                 batch.lens.astype(np.int32), cfg,
                                 seed_range=(0, 2))
            s = asb(small_index, small_device_index, batch, opts, w,
                    salvage_queue=sq, pending_search=pend,
                    phase2_queue=p2q)
            total = s if total is None else (total.add(s) or total)
        if p2q is not None:
            total.add(p2q.process(w, sq))
        total.add(sq.flush(w))
        return total, sorted(
            l for l in buf.getvalue().decode().splitlines()
            if not l.startswith("@"))

    (t_in, r_in), (t_df, r_df) = run(False), run(True)
    assert t_df.aligned_bwt == t_in.aligned_bwt
    assert t_df.num_records == t_in.num_records == 2 * N
    assert r_df == r_in


def test_no_cross_chromosome_proper_pairs(rng):
    """Ends landing on different chromosomes within the global insert
    window must NOT pair as FLAG_PROPER: the concatenated genome has no
    separators, so pairing must compare chromosomes explicitly."""
    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.index.builder import build_index
    from tests.conftest import make_genome

    g = make_genome(rng, 8000, num_chrom=2)  # boundary at 4000
    index = build_index(g, sa_rate=4, lut_k=6)
    didx = device_index(index)
    codes = g.codes
    L = 50
    # end1 ends 60bp before the chr1/chr2 boundary; end2 begins 90bp
    # after it: global distance ~200 (within [100, 300]) but the
    # chromosomes differ
    p1 = 4000 - 60 - L
    p2 = 4000 + 90
    b1 = make_batch([codes[p1:p1 + L].copy()])
    b2 = make_batch([dna.revcomp_codes(codes[p2:p2 + L])])
    summary, recs = run_pair(index, didx, b1, b2,
                             min_insert=100, max_insert=300,
                             max_mismatches=2)  # -s: no DP rescue
    assert summary.paired_bwt == 0
    for r in recs:
        assert not (r["flag"] & 0x2), f"cross-chromosome proper pair: {r}"


def test_mixed_length_pair_outer_span_insert(small_index,
                                             small_device_index,
                                             small_genome, rng):
    """Insert filtering uses the outer span (the emitted |TLEN|): a
    short mate contained in the long read's span must pair when the
    outer span is inside the window (the old p2+l2-p1 form understated
    it and disagreed with TLEN)."""
    codes = small_genome.codes
    l1, l2 = 60, 24
    p = int(rng.integers(100, len(codes) - 300))
    # end2 (reverse leg) placed INSIDE end1's span: outer span == l1
    p2 = p + l1 - l2 - 4
    b1 = make_batch([codes[p:p + l1].copy()], max_len=64)
    b2 = make_batch([dna.revcomp_codes(codes[p2:p2 + l2])], max_len=64)
    summary, recs = run_pair(small_index, small_device_index, b1, b2,
                             min_insert=l1 - 5, max_insert=l1 + 5,
                             max_mismatches=0)
    assert summary.paired_bwt == 1
    r1 = next(r for r in recs if r["flag"] & 0x40)
    assert abs(r1["tlen"]) == l1  # outer span, == the filter's insert


def test_phase2_queue_survives_fetch_failure(small_index,
                                             small_device_index,
                                             small_genome, rng,
                                             monkeypatch):
    """If finishing a deferred phase-2 item raises (e.g. a device OOM
    surfacing at the fetch), the queue must keep the item so a retry
    emits every pair exactly once — no drops, no double emission."""
    from soap3dp_tpu.fm.search import PendingSearch, SearchConfig
    from soap3dp_tpu.pipeline import pair as pairmod

    codes = small_genome.codes
    L, insert, N = 60, 200, 24
    seqs1, seqs2 = [], []
    for i in range(N):
        p = int(rng.integers(100, len(codes) - 400))
        left = codes[p:p + L].copy()
        right = codes[p + insert - L:p + insert].copy()
        for pos in rng.choice(L, size=2, replace=False):  # all escalate
            left[pos] = (left[pos] + 1 + rng.integers(3)) % 4
        seqs1.append(left)
        seqs2.append(dna.revcomp_codes(right))
    b1 = make_batch(seqs1, max_len=L)
    b2 = make_batch(seqs2, max_len=L)
    opts = AlignOptions(min_insert=100, max_insert=300)
    cfg = SearchConfig(k=opts.effective_mismatches(L))

    buf = io.BytesIO()
    w = SamWriter(buf, small_index)
    p2q = pairmod.Phase2Queue(small_index, small_device_index, opts)
    pend = PendingSearch(small_device_index,
                         np.concatenate([b1.codes, b2.codes]),
                         np.concatenate([b1.lens, b2.lens]).astype(np.int32),
                         cfg, seed_range=(0, 2))
    s = pairmod.align_pair_batch(small_index, small_device_index, b1, b2,
                                 opts, w, pending_search=pend,
                                 phase2_queue=p2q)
    assert len(p2q._items) == 1  # the 2-mismatch pairs escalated

    real = pairmod._phase2_finish
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("RESOURCE_EXHAUSTED (simulated)")
        return real(*a, **kw)

    monkeypatch.setattr(pairmod, "_phase2_finish", flaky)
    import pytest as _pytest
    with _pytest.raises(RuntimeError):
        p2q.process(w, None)
    assert len(p2q._items) == 1  # failed item kept
    s.add(p2q.process(w, None))  # retry succeeds
    assert len(p2q._items) == 0
    recs = [l for l in buf.getvalue().decode().splitlines()
            if not l.startswith("@")]
    assert s.num_records == 2 * N
    assert len(recs) == 2 * N
    assert len({r.split("\t")[0] + r.split("\t")[1] for r in recs}) == 2 * N


def test_long_reads_500bp(small_index, small_device_index, small_genome):
    """500bp reads end-to-end: on the GPU these take the fused DP
    kernel's 512-lane tile; on the CPU test backend the same shapes
    drive the scan path. SE + PE, with indels so DP rescue actually
    fires."""
    codes = small_genome.codes
    rng2 = np.random.default_rng(45)
    L, insert = 500, 1400
    pos = rng2.integers(100, len(codes) - insert - 100, 3)
    seqs = []
    for i, p in enumerate(pos):
        s = codes[p:p + L].copy()
        s[222] = (s[222] + 1) % 4
        if i == 1:  # 7bp deletion: DP rescue
            s = np.concatenate([s[:250], codes[p + 257:p + 257 + L - 250]])
        seqs.append(s)
    batch = make_batch(seqs, max_len=L)
    summary, recs = run_single(small_index, small_device_index, batch,
                               max_read_len=L)
    byname = {r["qname"]: r for r in recs}
    for i, p in enumerate(pos):
        r = byname[f"r{i}"]
        assert not r["flag"] & 0x4, i
        assert r["pos"] == p + 1, i
        assert cigar_read_span(r["cigar"]) == L, i
        if i == 1:
            assert "D" in r["cigar"]

    # paired: one mate needs half-aligned DP rescue (3bp insertion)
    s1, s2 = [], []
    for i, p in enumerate(pos):
        left = codes[p:p + L].copy()
        right = dna.revcomp_codes(codes[p + insert - L:p + insert])
        if i == 0:
            right = np.concatenate(
                [right[:200], rng2.integers(0, 4, 3).astype(np.uint8),
                 right[200:]])[:L]
        s1.append(left)
        s2.append(right)
    b1 = make_batch(s1, max_len=L)
    b2 = make_batch(s2, max_len=L)
    summary, recs = run_pair(small_index, small_device_index, b1, b2,
                             max_read_len=L, min_insert=800,
                             max_insert=2000)
    assert summary.paired_bwt + summary.paired_dp == 3
    byname = {}
    for r in recs:
        byname.setdefault(r["qname"], []).append(r)
    for i, p in enumerate(pos):
        rr = sorted(byname[f"r{i}"], key=lambda r: r["pos"])
        assert len(rr) == 2
        assert rr[0]["pos"] == p + 1, i
        assert not (rr[0]["flag"] & 0x4) and not (rr[1]["flag"] & 0x4)


def test_long_reads_1024bp(small_index, small_device_index, small_genome):
    """1024bp reads end-to-end — the reference's MAX_READ_LENGTH
    (definitions.h:38). On the GPU these take the fused DP kernel's
    2048-lane, one-problem tile; on the CPU test backend the same
    shapes drive the scan path."""
    codes = small_genome.codes
    rng2 = np.random.default_rng(47)
    L, insert = 1024, 2700
    pos = rng2.integers(100, len(codes) - insert - 100, 3)
    seqs = []
    for i, p in enumerate(pos):
        s = codes[p:p + L].copy()
        s[444] = (s[444] + 1) % 4
        if i == 1:  # 9bp deletion: DP rescue
            s = np.concatenate([s[:500], codes[p + 509:p + 509 + L - 500]])
        seqs.append(s)
    batch = make_batch(seqs, max_len=L)
    summary, recs = run_single(small_index, small_device_index, batch,
                               max_read_len=L)
    byname = {r["qname"]: r for r in recs}
    for i, p in enumerate(pos):
        r = byname[f"r{i}"]
        assert not r["flag"] & 0x4, i
        assert r["pos"] == p + 1, i
        assert cigar_read_span(r["cigar"]) == L, i
        if i == 1:
            assert "D" in r["cigar"]

    # paired: one mate needs half-aligned DP rescue (5bp insertion)
    s1, s2 = [], []
    for i, p in enumerate(pos):
        left = codes[p:p + L].copy()
        right = dna.revcomp_codes(codes[p + insert - L:p + insert])
        if i == 0:
            right = np.concatenate(
                [right[:300], rng2.integers(0, 4, 5).astype(np.uint8),
                 right[300:]])[:L]
        s1.append(left)
        s2.append(right)
    b1 = make_batch(s1, max_len=L)
    b2 = make_batch(s2, max_len=L)
    summary, recs = run_pair(small_index, small_device_index, b1, b2,
                             max_read_len=L, min_insert=2000,
                             max_insert=3500)
    assert summary.paired_bwt + summary.paired_dp == 3
    byname = {}
    for r in recs:
        byname.setdefault(r["qname"], []).append(r)
    for i, p in enumerate(pos):
        rr = sorted(byname[f"r{i}"], key=lambda r: r["pos"])
        assert len(rr) == 2
        assert rr[0]["pos"] == p + 1, i
        assert not (rr[0]["flag"] & 0x4) and not (rr[1]["flag"] & 0x4)


def test_k4_end_to_end(small_index, small_device_index, small_genome):
    """k=4 through the FULL pipeline (VERDICT r3 item 6; the reference
    ships dedicated 4-mismatch kernels, DV-Kernel.cu:4505-4741 /
    definitions.h:116-121): reads with exactly 4 planted substitutions
    must align via the BWT phase at k=4 (NM:i:4, full-length M CIGAR,
    no DP), and pairs with 4+4 mismatches must pair in phase A."""
    codes = small_genome.codes
    rng2 = np.random.default_rng(46)
    L, insert = 64, 200
    pos = rng2.integers(100, len(codes) - insert - 100, 6)

    def plant4(s):
        s = s.copy()
        for off in (7, 21, 38, 55):  # spread over all 5 pigeonhole segs
            s[off] = (s[off] + 1 + (off % 3)) % 4
        return s

    seqs = [plant4(codes[p:p + L]) for p in pos]
    batch = make_batch(seqs)
    summary, recs = run_single(small_index, small_device_index, batch,
                               soap3_mismatch_allow=4)
    assert summary.aligned_bwt == 6 and summary.aligned_dp == 0
    byname = {r["qname"]: r for r in recs}
    for i, p in enumerate(pos):
        r = byname[f"r{i}"]
        assert r["pos"] == p + 1 and r["cigar"] == f"{L}M", i
        assert r["tags"]["XM"] == "4", r["tags"]

    # same reads at k=3 must NOT come from the BWT phase (DP salvage
    # picks them up instead) — proving k=4 actually widened the search
    summary3, recs3 = run_single(small_index, small_device_index, batch,
                                 soap3_mismatch_allow=3)
    assert summary3.aligned_bwt == 0

    s1 = [plant4(codes[p:p + L]) for p in pos]
    s2 = [plant4(dna.revcomp_codes(codes[p + insert - L:p + insert]))
          for p in pos]
    b1, b2 = make_batch(s1), make_batch(s2)
    summary, recs = run_pair(small_index, small_device_index, b1, b2,
                             soap3_mismatch_allow=4, min_insert=100,
                             max_insert=300)
    assert summary.paired_bwt == 6
    for r in recs:
        assert not r["flag"] & 4
        assert r["tags"]["XM"] == "4"


def test_async_flusher_matches_sync_flush(small_index, small_device_index,
                                          small_genome):
    """AsyncFlusher (rescue flush on a worker thread overlapping the
    main loop, pipeline/overlap.py) must emit exactly the records a
    synchronous flush emits — order-insensitive, SO:unsorted output."""
    from soap3dp_tpu.io.aio import AsyncWriter
    from soap3dp_tpu.pipeline.overlap import AsyncFlusher
    from soap3dp_tpu.pipeline.pair import PairSummary, RescueQueue

    codes = small_genome.codes
    L, insert, N, NB = 60, 200, 48, 3

    def run(use_async):
        rng2 = np.random.default_rng(61)  # same reads both runs
        opts = AlignOptions(min_insert=100, max_insert=300)
        buf = io.BytesIO()
        w = AsyncWriter(SamWriter(buf, small_index))
        rq = RescueQueue(small_index, small_device_index, opts,
                         flush_pairs=32)  # tiny: force mid-run flushes
        total = PairSummary()
        # eager_min=8 exercises the idle-worker eager drain alongside
        # the flush_pairs threshold path
        fl = AsyncFlusher(rq, w, eager_min=8) if use_async else None
        for _ in range(NB):
            s1, s2 = [], []
            for i in range(N):
                p = int(rng2.integers(100, len(codes) - 400))
                left = codes[p:p + L].copy()
                right = dna.revcomp_codes(codes[p + insert - L:p + insert])
                if i % 3 == 0:  # indels -> rescue path
                    left = np.concatenate(
                        [left[:20], left[26:],
                         rng2.integers(0, 4, 6).astype(np.uint8)])
                s1.append(left)
                s2.append(right)
            b1, b2 = make_batch(s1, max_len=L), make_batch(s2, max_len=L)
            total.add(align_pair_batch(small_index, small_device_index,
                                       b1, b2, opts, w, rescue_queue=rq))
            if use_async:
                fl.maybe_submit()
            elif rq.should_flush():
                total.add(rq.flush(w))
        if use_async:
            fl.submit()
            fl.join(total.add)
        else:
            total.add(rq.flush(w))
        w.close()
        recs = sorted(l for l in buf.getvalue().decode().splitlines()
                      if not l.startswith("@"))
        return total, recs

    t_sync, r_sync = run(False)
    t_async, r_async = run(True)
    assert r_sync == r_async
    assert t_sync.num_records == t_async.num_records
    assert t_sync.paired_dp == t_async.paired_dp
    assert t_sync.unaligned == t_async.unaligned
