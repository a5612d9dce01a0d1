"""Benchmark: end-to-end 100bp alignment throughput on one chip.

Prints a cumulative JSON summary line on stdout after EVERY profile
(each line is self-contained; the LAST line is the artifact), so a
driver timeout part-way through still leaves a parseable result.
SIGTERM/SIGINT are caught and trigger a final flush (VERDICT r3 #1).

  {"metric": ..., "value": reads/s, "unit": "reads/s", "vs_baseline": r,
   "profiles": {...}}

Baseline: the reference aligns 1M x 100bp single-end reads against the
human genome (<=3 mismatches) in 37.04s on its GPU (BGS-Experiment.log:
8-11), i.e. ~27,000 reads/s/device. With zero egress (no GRCh38), the
human-scale profile uses a 3.1 Gbp REPEAT-STRUCTURED synthetic genome
(tools/repeat_genome.py: ~31% Alu/LINE/satellite/segdup repeats + N
runs — the pathology the reference's occ caps and ambiguity handling
exist for, HSP.c:849-896), not uniform-random text.

Profiles, in the order run (sam_out directly after main so their
ratio — the SAM-output tax — is measured back-to-back on the same
card; human_scale next so the headline number survives a tight
budget):
  main        40Mbp index, full SA + LUT-only seeding, succinct output
  sam_out     40Mbp index with SAM text output (the default -b 2 path)
  human_scale 3.1Gbp repeat-structured genome, sa_rate=2, lut_k=13 —
              THE HEADLINE when its cached index exists (build with
              tools/build_bench_indexes.py; hour-class host job)
  human_sam   3.1Gbp index with SAM text output — right after
              human_scale, sharing its ~550s device-index upload
  chr1_scale  250Mbp index, sa_rate=2, lut_k=13 — real FM extension
              steps past the LUT + sampled-SA LF walks on the hot path
  se_scale    the reference's own headline shape: 1M x 100bp SE

`value` (headline) = median of the warm-pass elapsed rates of the best
available profile (human_scale > main), pass 0 dropped (residual
compiles). BENCH_PASSES (default 4 = three timed passes, whose median
resists run-to-run variance) counts total passes per profile.
BENCH_BUDGET seconds (default 2400) skips remaining profiles when the
clock runs low — each already-finished profile was already emitted.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")
READ_LEN = 100
INSERT = 400
BASELINE_READS_PER_S = 27_000.0  # 1M reads / 37.04s (BGS-Experiment.log:8-11)

N_PAIRS = int(os.environ.get("BENCH_PAIRS", 400_000))
BATCH = int(os.environ.get("BENCH_BATCH", 100_000))
# 16 batches: the pipeline defers Phase2/rescue work one batch and
# drains the remainder after the last batch, so a 2-batch profile
# would charge much of its wall time to an end-of-run tail that a
# production-sized run amortizes away. The reference's own experiment
# shape is 1M+ reads end-to-end.
SCALE_PAIRS = int(os.environ.get("BENCH_SCALE_PAIRS", 1_600_000))
# total passes per profile; pass 0 absorbs residual compiles and is
# dropped from the stats, so 4 = three clean timed passes
PASSES = max(2, int(os.environ.get("BENCH_PASSES", 4)))
BUDGET_S = float(os.environ.get("BENCH_BUDGET", 2400))

START = time.time()

HUMAN_BP = 3_100_000_000

_DESC = {
    "main": "40Mbp synthetic index",
    "chr1_scale": "250Mbp synthetic index",
    "sam_out": "40Mbp synthetic index, SAM text output",
    "se_scale": "250Mbp synthetic index, single-end",
    "human_scale": "3.1Gbp repeat-structured genome (~31% repeats + N runs)",
    "human_sam": "3.1Gbp repeat-structured genome, SAM text output",
}


def get_index(genome_bp: int, sa_rate: int, lut_k: int):
    from soap3dp_tpu.index.builder import build_index_to, load_index
    from soap3dp_tpu.index.packing import PackedGenome
    from soap3dp_tpu.utils import dna

    tag = f"synth{genome_bp}.sa{sa_rate}k{lut_k}"
    path = os.path.join(CACHE, tag + ".t3i")
    codes_path = os.path.join(CACHE, f"synth{genome_bp}.codes.npy")
    if not os.path.exists(os.path.join(path, "meta.json")):
        _restore_keep()
    if os.path.exists(os.path.join(path, "meta.json")):
        return load_index(path), np.load(codes_path, mmap_mode="r")
    os.makedirs(CACHE, exist_ok=True)
    print(f"[bench] building {genome_bp / 1e6:.0f}Mbp index "
          f"(sa_rate={sa_rate}, lut_k={lut_k}; one-time)...", file=sys.stderr)
    t0 = time.time()
    rng = np.random.default_rng(7)
    if os.path.exists(codes_path):
        codes = np.load(codes_path)
    else:
        codes = rng.integers(0, 4, genome_bp, dtype=np.uint8)
        np.save(codes_path, codes)
    genome = PackedGenome(
        codes=codes, pac=dna.pack_codes(codes), length=genome_bp,
        names=["synth1"], offsets=np.asarray([0, genome_bp], np.uint64),
        amb_starts=np.zeros(0, np.uint64), amb_lengths=np.zeros(0, np.uint64))
    # resumable per-stage build: an interrupted hour-class build picks
    # up after its last completed stage (build_state.json in the dir)
    index = build_index_to(genome, path, sa_rate=sa_rate, lut_k=lut_k)
    print(f"[bench] index built in {time.time() - t0:.0f}s", file=sys.stderr)
    return index, np.load(codes_path, mmap_mode="r")


def _restore_keep() -> None:
    """Re-link a human-scale index kept in .bench_keep into the cache.

    .bench_cache is wiped between rounds while the hour-class 3.1 Gbp
    index build is the single point of failure for the headline number
    (VERDICT r4 #1). .bench_keep holds hard links (zero extra disk) to
    every completed human index; restoring is instant."""
    keep = os.path.join(os.path.dirname(CACHE), ".bench_keep")
    if not os.path.isdir(keep):
        return
    os.makedirs(CACHE, exist_ok=True)
    for name in os.listdir(keep):
        src = os.path.join(keep, name)
        dst = os.path.join(CACHE, name)
        try:
            if os.path.isdir(src):
                os.makedirs(dst, exist_ok=True)
                for f in os.listdir(src):
                    if not os.path.exists(os.path.join(dst, f)):
                        os.link(os.path.join(src, f), os.path.join(dst, f))
            elif not os.path.exists(dst):
                os.link(src, dst)
        except OSError:
            pass  # cross-device or perms: fall through to a rebuild


def get_hg_index(sa_rate: int = 2, lut_k: int = 13):
    """The repeat-structured human-scale index; None if not cached.

    Returns (index, codes mmap, excluded (starts, ends)) — excluded
    regions are the N runs; read simulation must avoid them just as
    real reads never come from gaps."""
    from soap3dp_tpu.index.builder import load_index
    from tools import repeat_genome

    import glob

    tag = repeat_genome.tag_for(HUMAN_BP)
    path = os.path.join(CACHE, f"{tag}.sa{sa_rate}k{lut_k}.t3i")
    codes_path = os.path.join(CACHE, tag + ".codes.npy")
    meta_path = os.path.join(CACHE, tag + ".genome.json")
    if not os.path.exists(os.path.join(path, "meta.json")):
        _restore_keep()
    if not (os.path.exists(os.path.join(path, "meta.json"))
            and os.path.exists(codes_path)):
        # fallback (VERDICT r4 #1): if the current tag is mid-build but
        # ANY complete human-scale repeat index exists, use it — a
        # generator revision must never erase the headline again
        for p in sorted(glob.glob(os.path.join(CACHE, "hg*.t3i")),
                        reverse=True):
            t = os.path.basename(p).split(".")[0]
            cp = os.path.join(CACHE, t + ".codes.npy")
            mp = os.path.join(CACHE, t + ".genome.json")
            if (os.path.exists(os.path.join(p, "meta.json"))
                    and os.path.exists(cp) and os.path.exists(mp)):
                print(f"[bench] human_scale: tag {tag} incomplete, "
                      f"falling back to cached {t}", file=sys.stderr)
                tag, path, codes_path, meta_path = t, p, cp, mp
                break
        else:
            return None
    with open(meta_path) as fh:
        gmeta = json.load(fh)
    starts = np.asarray(gmeta["amb_starts"], np.int64)
    lengths = np.asarray(gmeta["amb_lengths"], np.int64)
    keep = lengths > 10
    excluded = (starts[keep], starts[keep] + lengths[keep])
    return load_index(path), np.load(codes_path, mmap_mode="r"), excluded


def _sample_positions(rng, n_pos: int, hi: int, excluded) -> np.ndarray:
    """Sample insert start positions avoiding excluded (N-run) spans.

    Real reads never originate from assembly gaps; rejection-resample
    any insert overlapping an excluded run (and chromosome boundaries
    are handled downstream by the pairing filter)."""
    pos = rng.integers(0, hi, n_pos)
    if excluded is None or not len(excluded[0]):
        return pos
    starts, ends = excluded
    for _ in range(64):
        # insert [pos, pos+INSERT) overlaps run i iff
        # starts[i] < pos+INSERT and ends[i] > pos
        i = np.searchsorted(ends, pos, side="right")
        bad = (i < len(starts)) & (starts[np.minimum(i, len(starts) - 1)]
                                   < pos + INSERT)
        nbad = int(bad.sum())
        if not nbad:
            break
        pos[bad] = rng.integers(0, hi, nbad)
    return pos


def make_pairs(codes, n_pairs, rng, excluded=None):
    from soap3dp_tpu.io.fastq import ReadBatch

    n = len(codes)
    pos = _sample_positions(rng, n_pairs, n - INSERT - 1, excluded)
    idx = pos[:, None] + np.arange(READ_LEN)
    left = np.asarray(codes)[idx]
    ridx = (pos + INSERT - READ_LEN)[:, None] + np.arange(READ_LEN)
    right = (3 - np.asarray(codes)[ridx])[:, ::-1]
    # ~0.5% per-base mismatches
    for mat in (left, right):
        mask = rng.random(mat.shape) < 0.005
        mat[mask] = (mat[mask] + rng.integers(1, 4, int(mask.sum()))) % 4
    lens = np.full(n_pairs, READ_LEN, np.int32)
    names = [b"p%d" % i for i in range(n_pairs)]
    b1 = ReadBatch(names=names, codes=np.ascontiguousarray(left), lens=lens,
                   quals=None)
    b2 = ReadBatch(names=names, codes=np.ascontiguousarray(right),
                   lens=lens.copy(), quals=None)
    return b1, b2


def _pass_stats(pass_times: list[tuple[float, list[float]]], reads: int,
                batch_reads: int) -> dict:
    """Headline = MEDIAN warm-pass elapsed rate (best-of-N flatters a
    noisy run; all passes recorded)."""
    elapsed_sorted = sorted(e for e, _ in pass_times)
    med_elapsed = elapsed_sorted[(len(elapsed_sorted) - 1) // 2]
    _, batch_times = min(pass_times, key=lambda x: x[0])
    med_batch = sorted(batch_times)[len(batch_times) // 2]
    return {
        "reads_per_s": round(reads / med_elapsed, 1),
        "best_pass_reads_per_s": round(reads / elapsed_sorted[0], 1),
        "median_batch_reads_per_s": round(batch_reads / med_batch, 1),
        "batches": [round(b, 2) for b in batch_times],
        "warm_pass_seconds": [round(e, 2) for e, _ in pass_times],
    }


def run_profile(name, index, codes, writer_factory, n_pairs, batch,
                excluded=None, didx=None) -> dict:
    import jax

    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.io.fastq import ReadBatch
    from soap3dp_tpu.pipeline.options import AlignOptions
    from soap3dp_tpu.pipeline.overlap import AsyncFlusher
    from soap3dp_tpu.pipeline.pair import (PairSummary, Phase2Queue,
                                           RescueQueue, align_pair_batch,
                                           dispatch_pair_search)
    from soap3dp_tpu.utils import timers

    if didx is None:
        t0 = time.time()
        # wait for the upload, so that it does not bleed into the
        # warmup (compile) figure below
        didx = jax.block_until_ready(device_index(index))
        print(f"[bench:{name}] index upload: {time.time() - t0:.1f}s",
              file=sys.stderr)

    rng = np.random.default_rng(11)
    # Soap3MisMatchAllow=3: comparable with the reference's <=3-mismatch
    # 37.04s baseline (BGS-Experiment.log:8-11; VERDICT r2 item 6)
    opts = AlignOptions(min_insert=INSERT // 2, max_insert=INSERT * 2,
                        soap3_mismatch_allow=int(os.environ.get("BENCH_K", 3)),
                        half_rescue_seeded=bool(
                            os.environ.get("BENCH_HALF_SEEDED")))
    out = writer_factory(index)

    # warmup (jit compile) mirroring the timed loop EXACTLY — same batch
    # shape, same number of RescueQueue adds and the same flush points —
    # so the timed region never sees a fresh XLA compile
    wb1, wb2 = make_pairs(codes, batch, rng, excluded)
    n_batches = -(-n_pairs // batch)
    t0 = time.time()
    wq = RescueQueue(index, didx, opts)
    wp2 = Phase2Queue(index, didx, opts)
    wpend = dispatch_pair_search(didx, wb1, wb2, opts)
    for _ in range(n_batches):
        align_pair_batch(index, didx, wb1, wb2, opts, out,
                         pending_search=wpend, rescue_queue=wq,
                         phase2_queue=wp2)
        wpend = dispatch_pair_search(didx, wb1, wb2, opts)
        if wq.should_flush():
            wq.flush(out)
    wp2.process(out, wq)
    wq.flush(out)
    print(f"[bench:{name}] warmup (compile): {time.time() - t0:.1f}s",
          file=sys.stderr)
    timers.report(f"[bench:{name} warmup]")

    b1, b2 = make_pairs(codes, n_pairs, rng, excluded)
    batches = []
    for s in range(0, n_pairs, batch):
        sl = slice(s, s + batch)
        batches.append((ReadBatch(b1.names[sl], b1.codes[sl], b1.lens[sl], None),
                        ReadBatch(b2.names[sl], b2.codes[sl], b2.lens[sl], None)))
    pass_times = []
    for p in range(PASSES):
        total = PairSummary()
        t0 = time.time()
        # double-buffered: dispatch batch i+1's device search before
        # doing batch i's host work (the reference's GPU/CPU overlap,
        # alignment.cu:554-561); DP rescue defers via the RescueQueue
        batch_times = []
        rq = RescueQueue(index, didx, opts)
        p2q = Phase2Queue(index, didx, opts)
        flusher = AsyncFlusher(rq, out)
        pending = dispatch_pair_search(didx, *batches[0], opts)
        for i, (sb1, sb2) in enumerate(batches):
            tb = time.time()
            nxt = dispatch_pair_search(didx, *batches[i + 1], opts) \
                if i + 1 < len(batches) else None
            total.add(align_pair_batch(index, didx, sb1, sb2, opts, out,
                                       pending_search=pending,
                                       rescue_queue=rq,
                                       phase2_queue=p2q))
            if i + 1 == len(batches):
                # flush the backlog on the worker FIRST so it overlaps
                # the last batch's deferred escalations (p2q host work)
                flusher.submit()
                total.add(p2q.process(out, rq))
                flusher.submit()
                flusher.join(total.add)
            else:
                flusher.maybe_submit()
            pending = nxt
            batch_times.append(time.time() - tb)
        elapsed = time.time() - t0
        timers.report(f"[bench:{name} pass{p}]")
        print(f"[bench:{name} pass{p}] {2 * n_pairs} reads in "
              f"{elapsed:.2f}s", file=sys.stderr)
        if p > 0:  # pass 0 may still hit residual compiles
            pass_times.append((elapsed, batch_times))
    out.close()

    res = _pass_stats(pass_times, 2 * n_pairs, 2 * batch)
    print(f"[bench:{name}] {total}", file=sys.stderr)
    print(f"[bench:{name}] median warm pass -> {res['reads_per_s']:.0f} "
          f"reads/s elapsed (median batch "
          f"{res['median_batch_reads_per_s']:.0f})", file=sys.stderr)
    return res


def run_profile_single(name, index, codes, writer_factory, n_reads,
                       batch, excluded=None) -> dict:
    """Single-end profile: the reference's own headline workload is
    1M x 100bp SE <= 3 mismatches in 37.04s (BGS-Experiment.log:8-11)."""
    import jax

    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.io.fastq import ReadBatch
    from soap3dp_tpu.pipeline.options import AlignOptions
    from soap3dp_tpu.pipeline.overlap import AsyncFlusher
    from soap3dp_tpu.pipeline.single import (BatchSummary, SalvageQueue,
                                             SinglePhase2Queue,
                                             align_single_batch,
                                             dispatch_single_search)
    from soap3dp_tpu.utils import timers

    t0 = time.time()
    didx = jax.block_until_ready(device_index(index))
    print(f"[bench:{name}] index upload: {time.time() - t0:.1f}s",
          file=sys.stderr)

    rng = np.random.default_rng(13)
    opts = AlignOptions(
        soap3_mismatch_allow=int(os.environ.get("BENCH_K", 3)))
    out = writer_factory(index)

    reads, _ = make_pairs(codes, batch, rng, excluded)
    n_batches = -(-n_reads // batch)
    t0 = time.time()
    wq = SalvageQueue(index, didx, opts)
    wp2 = SinglePhase2Queue(index, didx, opts)
    wpend = dispatch_single_search(didx, reads, opts)
    for _ in range(n_batches):
        align_single_batch(index, didx, reads, opts, out,
                           salvage_queue=wq, pending_search=wpend,
                           phase2_queue=wp2)
        wpend = dispatch_single_search(didx, reads, opts)
        if wq.should_flush():
            wq.flush(out)
    wp2.process(out, wq)
    wq.flush(out)
    print(f"[bench:{name}] warmup (compile): {time.time() - t0:.1f}s",
          file=sys.stderr)
    timers.report(f"[bench:{name} warmup]")

    big, _ = make_pairs(codes, n_reads, rng, excluded)
    batches = []
    for st in range(0, n_reads, batch):
        sl = slice(st, st + batch)
        batches.append(ReadBatch(big.names[sl], big.codes[sl],
                                 big.lens[sl], None))
    pass_times = []
    for p in range(PASSES):
        total = BatchSummary()
        t0 = time.time()
        batch_times = []
        sq = SalvageQueue(index, didx, opts)
        p2q = SinglePhase2Queue(index, didx, opts)
        flusher = AsyncFlusher(sq, out)
        pending = dispatch_single_search(didx, batches[0], opts)
        for i, sb in enumerate(batches):
            tb = time.time()
            nxt = dispatch_single_search(didx, batches[i + 1], opts) \
                if i + 1 < len(batches) else None
            total.add(align_single_batch(index, didx, sb, opts, out,
                                         salvage_queue=sq,
                                         pending_search=pending,
                                         phase2_queue=p2q))
            if i + 1 == len(batches):
                flusher.submit()
                total.add(p2q.process(out, sq))
                flusher.submit()
                flusher.join(total.add)
            else:
                flusher.maybe_submit()
            pending = nxt
            batch_times.append(time.time() - tb)
        elapsed = time.time() - t0
        timers.report(f"[bench:{name} pass{p}]")
        print(f"[bench:{name} pass{p}] {n_reads} reads in "
              f"{elapsed:.2f}s", file=sys.stderr)
        if p > 0:
            pass_times.append((elapsed, batch_times))
    out.close()

    res = _pass_stats(pass_times, n_reads, batch)
    print(f"[bench:{name}] {total}", file=sys.stderr)
    print(f"[bench:{name}] median warm pass -> {res['reads_per_s']:.0f} "
          f"reads/s elapsed (median batch "
          f"{res['median_batch_reads_per_s']:.0f})", file=sys.stderr)
    return res


def emit(profiles: dict) -> None:
    """Print the cumulative self-contained summary JSON line.

    Called after every finished profile AND from the final flush, so
    the last stdout JSON line always reflects everything measured so
    far — a driver timeout can no longer erase the run (VERDICT r3 #1).
    Headline: human_scale (the reference's own regime) > main."""
    if not profiles:
        return
    head = "human_scale" if "human_scale" in profiles \
        else ("main" if "main" in profiles else next(iter(profiles)))
    rate = profiles[head]["reads_per_s"]
    kind = "SE" if head == "se_scale" else "PE"
    print(json.dumps({
        "metric": f"{kind} 100bp end-to-end reads/s/chip "
                  f"({_DESC.get(head, head)}, k=3 + DP rescue; median "
                  "warm-pass total-elapsed rate incl. rescue flushes)",
        "value": rate,
        "unit": "reads/s",
        "vs_baseline": round(rate / BASELINE_READS_PER_S, 3),
        "profiles": profiles,
    }), flush=True)


def main() -> int:
    from soap3dp_tpu.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()
    import jax

    from soap3dp_tpu.io.sam import SamWriter
    from soap3dp_tpu.io.succinct import SuccinctWriter

    print(f"[bench] devices: {jax.devices()}", file=sys.stderr)

    from soap3dp_tpu.io.aio import AsyncWriter

    def succ(index):
        return AsyncWriter(SuccinctWriter(os.path.join(CACHE, "bench.gout"),
                                          index))

    def samw(index):
        # BENCH_SAM_PATH=/dev/null isolates serialization CPU from the
        # disk byte-output cost (diagnostic; default measures both)
        path = os.environ.get("BENCH_SAM_PATH",
                              os.path.join(CACHE, "bench.sam"))
        return AsyncWriter(SamWriter(path, index))

    # BENCH_ONLY=chr1_scale (or main/sam_out/human_scale, comma-separated)
    # runs a subset — for profiling iteration; the driver runs all five
    only = set(filter(None, os.environ.get("BENCH_ONLY", "").split(",")))

    def want(name):
        if only:
            return name in only
        return time.time() - START < BUDGET_S

    profiles: dict = {}

    def terminate(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, terminate)
    signal.signal(signal.SIGINT, terminate)

    try:
        index40 = codes40 = None
        if want("main") or want("sam_out"):
            index40, codes40 = get_index(40_000_000, sa_rate=1, lut_k=14)
        if want("main"):
            profiles["main"] = run_profile("main", index40, codes40, succ,
                                           N_PAIRS, BATCH)
            emit(profiles)
        if want("sam_out"):
            if index40 is None:
                index40, codes40 = get_index(40_000_000, sa_rate=1, lut_k=14)
            # directly after main — the sam_out/main ratio IS the
            # SAM-serialization tax; same workload as main (N_PAIRS)
            profiles["sam_out"] = run_profile("sam_out", index40, codes40,
                                              samw, N_PAIRS, BATCH)
            emit(profiles)
        # human_scale runs next: it is the headline and must land
        # inside the budget. human_sam follows immediately, reusing the
        # SAME device index, so the 3.1Gbp upload is paid once.
        if want("human_scale") or want("human_sam"):
            hg = get_hg_index()
            if hg is not None:
                from soap3dp_tpu.fm.fmindex import device_index
                indexh, codesh, excl = hg
                t0 = time.time()
                didxh = jax.block_until_ready(device_index(indexh))
                print(f"[bench:human] index upload: {time.time() - t0:.1f}s",
                      file=sys.stderr)
                if want("human_scale"):
                    profiles["human_scale"] = run_profile(
                        "human_scale", indexh, codesh, succ, SCALE_PAIRS,
                        BATCH, excluded=excl, didx=didxh)
                    emit(profiles)
                if want("human_sam"):
                    profiles["human_sam"] = run_profile(
                        "human_sam", indexh, codesh, samw, SCALE_PAIRS,
                        BATCH, excluded=excl, didx=didxh)
                    emit(profiles)
                del indexh, codesh, didxh
            else:
                print("[bench] human profiles skipped: no cached 3.1Gbp "
                      "repeat-genome index (tools/build_bench_indexes.py)",
                      file=sys.stderr)
        if want("chr1_scale") or want("se_scale"):
            # sa_rate=2 measured +10% over rate 4 at this scale (the
            # decode walk halves; docs/SCALING.md)
            index250, codes250 = get_index(250_000_000, sa_rate=2, lut_k=13)
            if want("chr1_scale"):
                profiles["chr1_scale"] = run_profile(
                    "chr1_scale", index250, codes250, succ, SCALE_PAIRS,
                    BATCH)
                emit(profiles)
            if want("se_scale"):
                # the reference's own headline shape: 1M x 100bp SE
                profiles["se_scale"] = run_profile_single(
                    "se_scale", index250, codes250, succ, 1_000_000,
                    2 * BATCH)
                emit(profiles)
            del index250, codes250
    finally:
        # final flush: identical to the last incremental emit, but it
        # also covers a SIGTERM mid-profile (timeout(1) sends TERM)
        emit(profiles)

    if not profiles:
        print("[bench] no profiles ran (check BENCH_ONLY / cached "
              "indexes)", file=sys.stderr)
        return 1
    skipped = [n for n in _DESC if n not in profiles]
    if skipped:
        print(f"[bench] skipped (budget {BUDGET_S:.0f}s / missing index): "
              f"{skipped}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
