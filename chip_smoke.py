#!/usr/bin/env python3
"""Prove the aligner's main path on one NVIDIA GPU.

    python chip_smoke.py [--seed N] [--genome-mbp M] [--pairs K]
    python chip_smoke.py --devices 4

Phases, each fatal on failure:

1. device: JAX must see a GPU; prints the card's name and power limit.
2. data: a synthetic genome (250 Mbp by default, with N runs) written as
   FASTA and indexed with ``soap3dp-builder`` (sa_rate 2, lut_k 13;
   cached under ``.bench_cache/smoke/`` by seed and size), and read
   pairs (200,000 x 2 x 100 bp by default) simulated with the donor
   model of ``tools/evaluate_accuracy.py`` (1% SNPs, 0.1% indels, Q30
   errors) written as FASTQ.gz.
3. align: ``soap3dp pair`` through ``soap3dp_tpu.cli.main.main`` in this
   process. Recall and misplacement against the planted loci must meet
   the bounds of ``tests/test_accuracy.py``; DP rescue must have paired
   and singly rescued reads; every DP batch must have run through the
   fused GPU kernel (``banded_dp.dp_path_calls``), none through the scan.
4. dp: rescue problem batches packed from these reads and this index
   the way ``run_banded_dp`` packs them, at the rescue flush size, for
   the narrow half-rescue window and the full insert window, run through
   the GPU kernel and through ``dp_forward`` + ``dp_traceback``; every
   output must be equal. Prints both warm times and the kernel's
   ``memory_analysis()``.

With ``--devices N`` only the multi-card path runs: the same CLI input
aligned with ``--devices N`` and with one card, in this process; the SAM
records must be equal.

The last line of stdout is one JSON object: ``{"ok": true, "device":
{...}}`` after every phase passed, else ``{"ok": false, "error": ...}``
with a non-zero exit.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench_cache", "smoke")
READ_LEN = 100
INSERT = 300
SUB_RATE, INDEL_RATE = 0.01, 0.001   # the donor model of tests/test_accuracy.py
CONTAM_RATE = 0.005                  # pairs whose second read is not genomic
MIN_RECALL, MAX_WRONG = 0.999, 0.0005  # test_recall_easy's bounds
TOL = 8                              # bp of slack around the planted locus
DP_FLUSH_PROBLEMS = 16384            # RescueQueue's flush size, in problems


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ---------------------------------------------------------------- data

def make_genome(seed: int, length: int, n_runs: int = 64):
    """(codes, n_starts, n_lens): uniform random bases and ``n_runs``
    N runs of 100 bp to 20 kbp at seeded positions (runs may touch)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, length, dtype=np.uint8)
    n_lens = rng.integers(100, 20_000, n_runs).astype(np.int64)
    n_starts = np.sort(rng.integers(0, length - 20_000, n_runs)).astype(np.int64)
    return codes, n_starts, n_lens


def write_fasta(path: str, codes: np.ndarray, n_starts, n_lens,
                name: str = "synth1", width: int = 80) -> None:
    text = np.frombuffer(b"ACGT", np.uint8)[codes]
    for s, n in zip(n_starts, n_lens):
        text[s:s + n] = ord("N")
    pad = -len(text) % width
    lines = np.concatenate([text, np.full(pad, ord("\n"), np.uint8)])
    lines = lines.reshape(-1, width)
    body = np.concatenate(
        [lines, np.full((len(lines), 1), ord("\n"), np.uint8)], axis=1)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(f">{name}\n".encode())
        # the last row's padding newlines read as empty lines
        fh.write(body.tobytes())
    os.replace(tmp, path)


def excluded_spans(n_starts, n_lens):
    """Sorted (starts, ends) of the N runs, merged where they touch."""
    starts, ends = [], []
    for s, e in sorted(zip(n_starts, np.asarray(n_starts) + n_lens)):
        if starts and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def simulate(codes, n_pairs: int, seed: int, excluded):
    """(left, right, true_pos1, true_pos2) from the accuracy harness's
    donor model, plus CONTAM_RATE of pairs whose second read is random
    sequence (contamination, as real libraries carry; true_pos2 = -1):
    their first read has no mate to pair with and must be salvaged
    alone."""
    sys.path.insert(0, ROOT)
    from tools.evaluate_accuracy import simulate_pairs

    rng = np.random.default_rng(seed + 1)
    left, right, _, tp1, tp2 = simulate_pairs(
        codes, n_pairs, READ_LEN, INSERT, SUB_RATE, INDEL_RATE, rng,
        excluded=excluded)
    contam = rng.random(n_pairs) < CONTAM_RATE
    right[contam] = rng.integers(0, 4, (int(contam.sum()), READ_LEN))
    tp2[contam] = -1
    return left, right, tp1, tp2


def write_fastq_gz(path: str, codes: np.ndarray) -> None:
    seq = np.frombuffer(b"ACGT", np.uint8)[codes]
    qual = b"I" * codes.shape[1]
    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(b"".join(
            b"@e%07d\n%s\n+\n%s\n" % (i, row.tobytes(), qual)
            for i, row in enumerate(seq)))


def recall_of_sam(sam_path: str, tp1, tp2, offsets, tol: int = TOL) -> dict:
    """Recall, misplacement and unaligned share of the first record of
    each end against the planted loci (the accuracy harness's rule);
    ends with no locus (-1) are left out."""
    chrom, first = {}, {}
    with open(sam_path, "rb") as fh:
        for line in fh:
            if line.startswith(b"@SQ"):
                chrom[line.split(b"\tSN:")[1].split(b"\t")[0]] = len(chrom)
            if line.startswith(b"@"):
                continue
            f = line.split(b"\t", 5)
            flag = int(f[1])
            if flag & 0x4:
                continue
            key = (int(f[0][1:]), bool(flag & 0x40))
            if key not in first:
                first[key] = int(offsets[chrom[f[2]]]) + int(f[3]) - 1
    found = wrong = missing = n = 0
    for pid in range(len(tp1)):
        for is_first, want in ((True, tp1[pid]), (False, tp2[pid])):
            if want < 0:
                continue
            n += 1
            got = first.get((pid, is_first))
            if got is None:
                missing += 1
                continue
            ok = abs(got - int(want)) <= tol
            found += ok
            wrong += not ok
    n = max(n, 1)
    return {"recall": found / n, "wrong": wrong / n, "unaligned": missing / n}


def sam_records(path: str) -> list[bytes]:
    with open(path, "rb") as fh:
        return sorted(l for l in fh if not l.startswith(b"@"))


# -------------------------------------------------------------- phases

def check_device(want: int = 1):
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's devices are {devs}")
    if len(devs) < want:
        raise RuntimeError(f"{want} GPUs wanted, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    log(f"device: {d.platform} {d.device_kind} x{len(devs)}, "
        f"jax {jax.__version__}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def prepare_data(seed: int, genome_bp: int, n_pairs: int):
    """FASTA + cached index + FASTQ.gz; returns paths and the truth."""
    from soap3dp_tpu.cli import builder

    os.makedirs(CACHE, exist_ok=True)
    tag = f"s{seed}_{genome_bp}"
    fasta = os.path.join(CACHE, f"genome_{tag}.fa")
    t0 = time.time()
    codes, n_starts, n_lens = make_genome(seed, genome_bp)
    excluded = excluded_spans(n_starts, n_lens)
    if not os.path.exists(os.path.join(fasta + ".index.t3i", "meta.json")):
        write_fasta(fasta, codes, n_starts, n_lens)
        log(f"genome: {genome_bp} bp, {len(n_starts)} N runs, FASTA in "
            f"{time.time() - t0:.1f}s")
        t0 = time.time()
        if builder.main([fasta, "--sa-rate", "2", "--lut-k", "13"]) != 0:
            raise RuntimeError("soap3dp-builder failed")
        log(f"index: built in {time.time() - t0:.1f}s")
    else:
        log(f"index: cached at {fasta}.index.t3i")
    t0 = time.time()
    left, right, tp1, tp2 = simulate(codes, n_pairs, seed, excluded)
    r1 = os.path.join(CACHE, f"reads_{tag}_{n_pairs}_1.fq.gz")
    r2 = os.path.join(CACHE, f"reads_{tag}_{n_pairs}_2.fq.gz")
    write_fastq_gz(r1, left)
    write_fastq_gz(r2, right)
    log(f"reads: {n_pairs} pairs of 2 x {READ_LEN} bp, insert {INSERT}, "
        f"FASTQ.gz in {time.time() - t0:.1f}s")
    return {"fasta": fasta, "r1": r1, "r2": r2, "left": left,
            "right": right, "tp1": tp1, "tp2": tp2}


def align(data, out_prefix: str, devices: int = 1):
    """``soap3dp pair`` through the CLI entry point; returns the run's
    summary and the DP path counts it added."""
    from soap3dp_tpu.cli import main as cli, runner
    from soap3dp_tpu.kernels import banded_dp

    before = dict(banded_dp.dp_path_calls)
    argv = ["pair", data["fasta"] + ".index", data["r1"], data["r2"],
            "-o", out_prefix, "-v", str(INSERT // 2), "-u", str(INSERT * 2)]
    if devices != 1:
        argv += ["--devices", str(devices)]
    t0 = time.time()
    if cli.main(argv) != 0:
        raise RuntimeError(f"soap3dp {' '.join(argv)} failed")
    wall = time.time() - t0
    calls = {k: v - before.get(k, 0)
             for k, v in banded_dp.dp_path_calls.items()}
    log(f"align: soap3dp {' '.join(argv[:1] + argv[4:])} "
        f"({len(data['tp1'])} pairs, {devices} device(s)) in {wall:.2f}s "
        "wall, compilation and index upload included")
    return runner.last_summary, calls


def check_alignment(data, out_prefix: str, summary, calls) -> None:
    from soap3dp_tpu.index.builder import load_index

    log(f"summary: {summary}")
    log(f"dp path calls: {calls}")
    offsets = load_index(data["fasta"] + ".index.t3i").offsets
    acc = recall_of_sam(out_prefix + ".sam", data["tp1"], data["tp2"],
                        offsets)
    log(f"accuracy: recall {acc['recall']:.6f} (>= {MIN_RECALL}), wrong "
        f"{acc['wrong']:.6f} (<= {MAX_WRONG}), unaligned "
        f"{acc['unaligned']:.6f}")
    if acc["recall"] < MIN_RECALL or acc["wrong"] > MAX_WRONG:
        raise RuntimeError(f"accuracy out of bounds: {acc}")
    if summary.paired_dp <= 0 or summary.single_rescued <= 0:
        raise RuntimeError("DP rescue did no work: "
                           f"paired_dp={summary.paired_dp}, "
                           f"single_rescued={summary.single_rescued}")
    if calls.get("kernel", 0) <= 0 or calls.get("scan", 0) != 0:
        raise RuntimeError(f"DP did not run on the GPU kernel alone: {calls}")


def rescue_batch(didx, data, n: int, win_len: int, pad: int, seed: int):
    """``n`` rescue problems the way run_banded_dp packs them: mate reads
    oriented on device against genome windows gathered on device. Most
    windows hold the planted locus (``pad`` bp either side, shifted at
    random within the window); a fifth hold random genome."""
    import jax.numpy as jnp

    from soap3dp_tpu.pipeline import dp_rescue
    from soap3dp_tpu.utils import shapes

    rng = np.random.default_rng(seed)
    B = len(data["tp1"])
    pair = rng.integers(0, B, n)
    end2 = rng.random(n) < 0.5            # mate = right read (reverse strand)
    reads = np.concatenate([data["left"], data["right"]])
    cread = np.where(end2, pair + B, pair).astype(np.int32)
    tp = np.where(end2, data["tp2"][pair], data["tp1"][pair]).astype(np.int64)
    shift = rng.integers(0, max(win_len - READ_LEN - 2 * pad, 0) + 1, n)
    ws = np.maximum(tp - pad - shift, 0)
    decoy = rng.random(n) < 0.2
    ws[decoy] = rng.integers(0, int(data["tp1"].max()), int(decoy.sum()))
    max_win = shapes.bucket_multiple(win_len, 128)
    oriented, wins = dp_rescue._pack_problems(
        didx, jnp.asarray(reads), jnp.full(2 * B, READ_LEN, jnp.int32),
        jnp.asarray(cread), jnp.asarray(end2), jnp.asarray(ws, jnp.uint32),
        READ_LEN, max_win)
    clip = jnp.full(n, 49, jnp.int32)     # max_front_clip = max_end_clip
    return [oriented, jnp.full(n, READ_LEN, jnp.int32), wins,
            jnp.full(n, win_len, jnp.int32), clip, clip,
            jnp.full(n, max_win + 1, jnp.int32), jnp.zeros(n, jnp.int32)], \
        np.full(n, int(0.3 * READ_LEN), np.int32)


def best_of(f, n: int = 3) -> float:
    f()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        f()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def compare_dp(name: str, prob, cutoff) -> None:
    """Fused kernel vs dp_forward + dp_traceback on one batch: exact."""
    import jax
    import jax.numpy as jnp

    from soap3dp_tpu.kernels import banded_dp as bd

    sc = bd.DPScores()
    P, Lr = prob[0].shape
    Lw = prob[2].shape[1]
    pt = bd.kernel_tile(P, Lr, Lw, platform="gpu")
    mr = bd._max_runs_bound(Lr)
    cut = jnp.asarray(cutoff)

    def kernel():
        return jax.block_until_ready(bd._dp_align_call(
            *prob, cut, sc=sc, pt=pt, mr=mr))

    def scan():
        bS, bI, bJ, bC, dirs = bd.dp_forward(*prob, sc=sc)
        return jax.block_until_ready(
            (bS, bI, bJ, bC, dirs) + bd._traceback_scan(dirs, bI, bJ, bS >= cut))

    stats, runs = map(np.asarray, kernel())
    bS, bI, bJ, bC, dirs = scan()[:5]
    bS, bI, bJ, bC = map(np.asarray, (bS, bI, bJ, bC))
    active = bS >= cutoff
    ops, cnts, nrun, startj = bd.dp_traceback(
        dirs, prob[0], prob[1], prob[2], bI, bJ, prob[4], jnp.asarray(active))
    del dirs
    if not (np.array_equal(stats[:, 0], bS) and np.array_equal(stats[:, 1], bI)
            and np.array_equal(stats[:, 2], bJ)
            and np.array_equal(stats[:, 3], bC)):
        raise RuntimeError(f"dp {name}: kernel stats differ from the scan")
    if stats[:, 6].any():
        raise RuntimeError(f"dp {name}: run budget overflow")
    if not np.array_equal(np.where(active, stats[:, 5], 0),
                          np.where(active, nrun, 0)) \
            or not np.array_equal(stats[active, 4], startj[active]):
        raise RuntimeError(f"dp {name}: kernel nrun/startj differ")
    k_ops, k_cnts = runs >> 12, runs & 0xFFF
    w = max(k_ops.shape[1], ops.shape[1])
    for a, b in ((k_ops, ops), (k_cnts, cnts)):
        a = np.pad(a, ((0, 0), (0, w - a.shape[1])))[active]
        b = np.pad(b, ((0, 0), (0, w - b.shape[1])))[active]
        lane = np.arange(w)[None, :] < nrun[active][:, None]
        if not np.array_equal(np.where(lane, a, 0), np.where(lane, b, 0)):
            raise RuntimeError(f"dp {name}: kernel runs differ from the scan")
    tk, ts = best_of(kernel), best_of(scan)
    dk = best_of(lambda: bd.dp_align(*prob, cutoff, sc=sc))
    ds = best_of(lambda: bd._dp_align_scan(*prob, cutoff, sc))
    log(f"dp {name}: P={P} Lr={Lr} Lw={Lw} tile={pt}: kernel == scan "
        f"(score, hit_i, hit_j, n_best, startj, runs; {int(active.sum())} "
        f"above cutoff). device warm: kernel {tk * 1e3:.3f} ms, scan "
        f"{ts * 1e3:.3f} ms; host-ready dp_align: kernel {dk * 1e3:.3f} "
        f"ms, scan {ds * 1e3:.3f} ms")
    c = jax.jit(lambda *a: bd._dp_align_call(
        *a, sc=sc, pt=pt, mr=mr)).lower(*prob, cut).compile()
    log(f"dp {name}: kernel memory_analysis {c.memory_analysis()}")


def dp_phase(data, seed: int) -> None:
    import jax

    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.index.builder import load_index

    didx = device_index(load_index(data["fasta"] + ".index.t3i"))
    nbytes = sum(x.nbytes for x in jax.tree.leaves(didx)
                 if isinstance(x, jax.Array))
    log(f"index on device: {nbytes} bytes")
    # narrow half rescue: read + 2 x 32 bp pad; full insert window
    n = DP_FLUSH_PROBLEMS
    narrow, cut = rescue_batch(didx, data, n, READ_LEN + 64, 32, seed)
    compare_dp("narrow", narrow, cut)
    deep, cut = rescue_batch(didx, data, n // 4, 2 * INSERT - INSERT // 2
                             + READ_LEN, 0, seed + 1)
    compare_dp("deep", deep, cut)


def run(args) -> dict:
    sys.path.insert(0, ROOT)
    import soap3dp_tpu

    if os.path.dirname(os.path.dirname(os.path.abspath(
            soap3dp_tpu.__file__))) != ROOT:
        raise RuntimeError(f"soap3dp_tpu imported from {soap3dp_tpu.__file__},"
                           f" not from {ROOT}")
    device = check_device(args.devices)
    data = prepare_data(args.seed, int(args.genome_mbp * 1e6), args.pairs)
    out = os.path.join(CACHE, f"out_s{args.seed}")
    if args.devices > 1:
        for n in (1, args.devices):
            _, calls = align(data, out + f"_{n}dev", devices=n)
            log(f"dp path calls, {n} device(s): {calls}")
            if calls.get("kernel", 0) <= 0 or calls.get("scan", 0) != 0:
                raise RuntimeError(f"DP did not run on the GPU kernel alone "
                                   f"on {n} device(s): {calls}")
        one = sam_records(out + "_1dev.sam")
        many = sam_records(out + f"_{args.devices}dev.sam")
        if one != many:
            diff = len(set(one) ^ set(many))
            raise RuntimeError(f"{args.devices}-device SAM differs from the "
                               f"1-device SAM ({diff} records differ)")
        log(f"{args.devices} devices: {len(many)} SAM records, equal to "
            "the 1-device run")
        return device
    summary, calls = align(data, out)
    check_alignment(data, out, summary, calls)
    dp_phase(data, args.seed)
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-mbp", type=float, default=250.0)
    ap.add_argument("--pairs", type=int, default=200_000)
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the N-device CLI path against 1 device")
    args = ap.parse_args(argv)
    try:
        device = run(args)
    except Exception as e:  # noqa: BLE001 — every failure fails the smoke
        traceback.print_exc()
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}))
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
