"""End-to-end alignment accuracy on simulated paired-end reads.

Simulates reads from a (synthetic or cached) genome with substitution
SNPs, small indels, and quality-dependent sequencing errors, runs the
FULL pair pipeline (phases A-E, the path `soap3dp pair` drives), and
reports:

  - recall: fraction of pairs whose primary records land on the
    planted locus (+/- a small indel tolerance)
  - wrong-by-MAPQ: misplacement rate per MAPQ bucket (calibration —
    high-MAPQ records should essentially never be wrong; the
    reference's BWA-like scores have the same contract,
    BGS-IO.cpp:2415-2463)
  - unaligned / flagged counts

Usage:
  python tools/evaluate_accuracy.py [n_pairs=20000] [sub_rate=0.01] \
      [indel_rate=0.001] [genome_mbp=5]

CI exercises the same harness via tests/test_accuracy.py with fixed
thresholds, so a recall regression fails the suite rather than only
showing up in benchmarks.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def simulate_pairs(codes: np.ndarray, n_pairs: int, read_len: int,
                   insert: int, sub_rate: float, indel_rate: float,
                   rng: np.random.Generator, excluded=None):
    """Returns (left, right, lens, true_pos1, true_pos2).

    Mutations model a diploid-ish donor: per-base substitutions at
    sub_rate, and per-read single 1-3bp indels at indel_rate, plus
    Q30-equivalent sequencing errors (1e-3) on top.
    """
    n = len(codes)
    L = read_len
    pos = rng.integers(0, n - insert - 1, n_pairs)
    if excluded is not None and len(excluded[0]):
        # real reads never come from assembly gaps (N runs): reject
        # inserts overlapping an excluded region and resample
        starts, ends = excluded
        for _ in range(64):
            i = np.searchsorted(ends, pos, side="right")
            bad = (i < len(starts)) & (
                starts[np.minimum(i, len(starts) - 1)] < pos + insert)
            nb = int(bad.sum())
            if not nb:
                break
            pos[bad] = rng.integers(0, n - insert - 1, nb)
    left = np.empty((n_pairs, L), np.uint8)
    right = np.empty((n_pairs, L), np.uint8)
    tp1 = pos.copy()
    tp2 = pos + insert - L
    for i in range(n_pairs):
        p = int(pos[i])
        seg = np.array(codes[p:p + insert], np.uint8)
        left[i] = seg[:L]
        right[i] = (3 - seg[insert - L:][::-1])

    def mutate(reads: np.ndarray) -> None:
        # substitutions (donor SNPs + sequencing error)
        rate = sub_rate + 1e-3
        m = rng.random(reads.shape) < rate
        reads[m] = (reads[m] + rng.integers(1, 4, int(m.sum()))) % 4
        # single small indel per selected read: delete d bases mid-read
        # and shift (read tail refills from noise — conservative: the
        # aligner must recover the locus from the intact prefix/suffix)
        sel = np.flatnonzero(rng.random(len(reads)) < indel_rate)
        for i in sel:
            d = int(rng.integers(1, 4))
            at = int(rng.integers(10, reads.shape[1] - 10 - d))
            reads[i, at:-d] = reads[i, at + d:].copy()
            reads[i, -d:] = rng.integers(0, 4, d)

    mutate(left)
    mutate(right)
    lens = np.full(n_pairs, L, np.int32)
    return left, right, lens, tp1, tp2


def run_eval(codes: np.ndarray, index, didx, n_pairs: int,
             sub_rate: float, indel_rate: float, read_len: int = 100,
             insert: int = 300, tol: int = 8, seed: int = 7,
             excluded=None) -> dict:
    from soap3dp_tpu.io.fastq import ReadBatch
    from soap3dp_tpu.pipeline.options import AlignOptions
    from soap3dp_tpu.pipeline.pair import (RescueQueue, align_pair_batch,
                                           dispatch_pair_search)

    rng = np.random.default_rng(seed)
    left, right, lens, tp1, tp2 = simulate_pairs(
        codes, n_pairs, read_len, insert, sub_rate, indel_rate, rng,
        excluded=excluded)
    names = np.array([b"e%07d" % i for i in range(n_pairs)])
    b1 = ReadBatch(names=names, codes=left, lens=lens, quals=None)
    b2 = ReadBatch(names=names, codes=right, lens=lens.copy(), quals=None)
    opts = AlignOptions(min_insert=insert // 2, max_insert=insert * 2,
                        soap3_mismatch_allow=3)

    records = []  # (pair_idx, is_first, GLOBAL pos, mapq, flag)
    # record positions are chromosome-local; truth positions live in the
    # concatenated coordinate space — translate back through offsets
    # (single-chromosome genomes masked this before the multi-chromosome
    # repeat genome existed)
    offs = np.asarray(index.offsets, np.int64)

    class Collect:
        needs_seq = False
        needs_tags = False

        def write(self, rec):
            if rec.flag & 0x4:
                return
            records.append((int(rec.qname[1:]), bool(rec.flag & 0x40),
                            int(offs[rec.chrom]) + rec.pos, rec.mapq,
                            rec.flag))

        def write_block(self, names_, flags, chroms, poss, mapqs, cigars,
                        nms, **kw):
            for j in range(len(names_)):
                f = int(flags[j])
                if f & 0x4:
                    continue
                records.append((int(bytes(names_[j])[1:]), bool(f & 0x40),
                                int(offs[int(chroms[j])]) + int(poss[j]),
                                int(mapqs[j]), f))

    out = Collect()
    rq = RescueQueue(index, didx, opts)
    # same dispatch path as the CLI (phased search where the index
    # qualifies; pass a small lut_k to exercise it on a small genome)
    pend = dispatch_pair_search(didx, b1, b2, opts)
    summary = align_pair_batch(index, didx, b1, b2, opts, out,
                               pending_search=pend, rescue_queue=rq)
    summary.add(rq.flush(out))

    # primary record per (pair, end): first occurrence (phases emit
    # primary before XA-style extras; Collect sees only main records)
    best = {}
    for pid, is_first, pos_, mq, f in records:
        key = (pid, is_first)
        if key not in best:
            best[key] = (pos_, mq)
    buckets = [(0, 0), (1, 9), (10, 29), (30, 255)]
    stats = {f"mapq{lo}-{hi}": [0, 0] for lo, hi in buckets}
    found = wrong = missing = 0
    for pid in range(n_pairs):
        for is_first, want in ((True, tp1[pid]), (False, tp2[pid])):
            got = best.get((pid, is_first))
            if got is None:
                missing += 1
                continue
            pos_, mq = got
            okp = abs(int(pos_) - int(want)) <= tol
            found += okp
            wrong += not okp
            for lo, hi in buckets:
                if lo <= mq <= hi:
                    s = stats[f"mapq{lo}-{hi}"]
                    s[0] += okp
                    s[1] += not okp
    n_ends = 2 * n_pairs
    hi = stats["mapq30-255"]
    return {
        "n_ends": n_ends,
        "recall": found / n_ends,
        "wrong": wrong / n_ends,
        "unaligned": missing / n_ends,
        # the calibration contract: high-MAPQ records are ~never wrong
        # (BGS-IO.cpp:2415-2463); on repeat genomes overall `wrong`
        # includes legitimately ambiguous low-MAPQ placements
        "mapq30_wrong_rate": (hi[1] / max(hi[0] + hi[1], 1)),
        "mapq_buckets": {k: {"right": v[0], "wrong": v[1]}
                         for k, v in stats.items()},
        "still_flagged": int(getattr(summary, "still_flagged", 0)),
        "capped_anchors": int(getattr(summary, "capped_anchors", 0)),
        "summary": str(summary),
    }


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    if os.environ["JAX_PLATFORMS"] == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.index.builder import build_index
    from soap3dp_tpu.index.packing import PackedGenome
    from soap3dp_tpu.utils.dna import pack_codes

    args = sys.argv[1:]
    hg = "--hg" in args
    if hg:
        args.remove("--hg")
    n_pairs = int(args[0]) if len(args) > 0 else 20_000
    sub_rate = float(args[1]) if len(args) > 1 else 0.01
    indel_rate = float(args[2]) if len(args) > 2 else 0.001
    mbp = float(args[3]) if len(args) > 3 else 5
    lut_k = int(args[4]) if len(args) > 4 else 13

    excluded = None
    if hg and abs(mbp - 3100) < 1:
        # the cached human-scale repeat index (built by
        # tools/build_bench_indexes.py); runs on the GPU
        import bench
        got = bench.get_hg_index()
        assert got is not None, "build the 3.1Gbp hg index first"
        index, codes, excluded = got
        codes = np.asarray(codes)
    elif hg:
        # small-scale repeat-structured genome, generated in process
        from tools import repeat_genome
        genome = repeat_genome.generate(int(mbp * 1e6), seed=5)
        st, ln = genome.amb_starts.astype(np.int64),             genome.amb_lengths.astype(np.int64)
        keep = ln > 10
        excluded = (st[keep], st[keep] + ln[keep])
        codes = genome.codes
        index = build_index(genome, sa_rate=2, lut_k=lut_k)
    else:
        rng = np.random.default_rng(3)
        n = int(mbp * 1e6)
        codes = rng.integers(0, 4, n).astype(np.uint8)
        genome = PackedGenome(
            codes=codes, pac=pack_codes(codes), length=n, names=["chr1"],
            offsets=np.array([0, n], np.uint64),
            amb_starts=np.zeros(0, np.uint64),
            amb_lengths=np.zeros(0, np.uint64))
        index = build_index(genome, sa_rate=2, lut_k=lut_k)
    didx = device_index(index)

    import json
    res = run_eval(codes, index, didx, n_pairs, sub_rate, indel_rate,
                   excluded=excluded)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
