"""chip_smoke.py's own logic, on the CPU: refusal without a GPU or
without the package, seeded data generators, and the recall check."""

import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    last = json.loads(p.stdout.strip().splitlines()[-1])
    return p.returncode, last


def test_refuses_cpu_only_run():
    rc, last = _run_smoke(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert rc != 0
    assert last["ok"] is False and "no GPU" in last["error"]


def test_refuses_without_the_package(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
    rc, last = _run_smoke(str(script), str(tmp_path))
    assert rc != 0 and last["ok"] is False


def test_genome_is_seeded():
    a = chip_smoke.make_genome(5, 200_000)
    b = chip_smoke.make_genome(5, 200_000)
    c = chip_smoke.make_genome(6, 200_000)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    codes, starts, lens = a
    assert codes.max() <= 3 and len(starts) == 64
    assert (starts + lens <= len(codes)).all()


def test_reads_are_seeded_and_avoid_n_runs():
    codes, starts, lens = chip_smoke.make_genome(1, 300_000)
    excl = chip_smoke.excluded_spans(starts, lens)
    r1 = chip_smoke.simulate(codes, 400, 2, excl)
    r2 = chip_smoke.simulate(codes, 400, 2, excl)
    for x, y in zip(r1, r2):
        assert np.array_equal(x, y)
    left, right, tp1, tp2 = r1
    assert left.shape == right.shape == (400, chip_smoke.READ_LEN)
    s, e = excl
    insert_end = tp1 + chip_smoke.INSERT
    i = np.searchsorted(e, tp1, side="right")
    hit = (i < len(s)) & (s[np.minimum(i, len(s) - 1)] < insert_end)
    assert not hit.any()
    assert (tp2[tp2 >= 0] == tp1[tp2 >= 0] + chip_smoke.INSERT
            - chip_smoke.READ_LEN).all()


def test_excluded_spans_merge_touching_runs():
    s, e = chip_smoke.excluded_spans(np.array([50, 10, 30]),
                                     np.array([5, 25, 10]))
    assert s.tolist() == [10, 50] and e.tolist() == [40, 55]


def test_fasta_and_fastq_round_trip(tmp_path):
    from soap3dp_tpu.index.packing import pack_fasta
    from soap3dp_tpu.io.fastq import read_single

    codes, starts, lens = chip_smoke.make_genome(3, 100_000, n_runs=4)
    fa = str(tmp_path / "g.fa")
    chip_smoke.write_fasta(fa, codes, starts, lens)
    g = pack_fasta(fa)
    assert g.length == len(codes) and g.names == ["synth1"]
    n_mask = np.zeros(len(codes), bool)
    for s, n in zip(starts, lens):
        n_mask[s:s + n] = True
    assert np.array_equal(g.codes[~n_mask], codes[~n_mask])
    assert int(g.amb_lengths.sum()) == int(n_mask.sum())

    reads = np.random.default_rng(0).integers(0, 4, (7, 100)).astype(np.uint8)
    fq = str(tmp_path / "r.fq.gz")
    chip_smoke.write_fastq_gz(fq, reads)
    with gzip.open(fq) as fh:
        assert fh.readline() == b"@e0000000\n"
    (batch,) = list(read_single(fq, 64, 120))
    assert np.array_equal(batch.codes[:, :100], reads)


def test_recall_of_sam(tmp_path):
    sam = tmp_path / "o.sam"
    sam.write_text(
        "@HD\tVN:1.4\n@SQ\tSN:a\tLN:1000\n@SQ\tSN:b\tLN:1000\n"
        # pair 0: both ends right (end 2 on the second sequence)
        "e0000000\t65\ta\t101\t60\n"
        "e0000000\t129\tb\t6\t60\n"
        # pair 1: end 1 placed 20 bp off, then a later duplicate record
        "e0000001\t65\ta\t221\t60\n"
        "e0000001\t65\ta\t201\t60\n"
        # pair 1 end 2 unmapped; pair 2 end 2 is contamination
        "e0000001\t141\t*\t0\t0\n"
        "e0000002\t65\ta\t301\t60\n")
    offsets = np.array([0, 1000, 2000], np.uint64)
    tp1 = np.array([100, 200, 300])
    tp2 = np.array([1005, 400, -1])
    acc = chip_smoke.recall_of_sam(str(sam), tp1, tp2, offsets)
    assert acc == pytest.approx({"recall": 3 / 5, "wrong": 1 / 5,
                                 "unaligned": 1 / 5})
