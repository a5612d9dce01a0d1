"""A/B the phased BWT search against the single-phase search.

The phased scheme (segments {0,1} first, escalate unresolved pairs;
pair.py:_phase1_range, the analog of the reference's staged phases in
alignment.cu:1119-1236) can resolve a pair in phase 1 with a complete
best-score hit set but an INCOMPLETE suboptimal set — so X1 can
undercount and MAPQ can read high for phase-1-resolved pairs
(PARITY.md "Phased search"). This tool MEASURES that divergence
(VERDICT r3 item 5): align the same pairs with phased_search on/off
and count records differing in each SAM field.

Usage (on the GPU; needs the cached 250Mbp bench index where phasing engages —
LUT-only configs auto-disable it):

    python tools/measure_phased_divergence.py [n_pairs=100000]

Prints a JSON line with per-field divergence rates. The CI bound lives
in tests/test_phased.py (CPU, smaller N, same harness via run_ab).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_records(sam_bytes: bytes) -> dict:
    """(qname, end) -> (pos, mapq, cigar, flag, X0, X1, XA)."""
    recs = {}
    for line in sam_bytes.decode().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        tags = dict(t.split(":", 2)[::2] for t in f[11:])
        key = (f[0], int(f[1]) & 0xC0)
        recs[key] = {
            "pos": int(f[3]), "mapq": int(f[4]), "cigar": f[5],
            "flag": int(f[1]), "x0": tags.get("X0"), "x1": tags.get("X1"),
            "xa": tags.get("XA"),
        }
    return recs


def run_ab(index, didx, b1, b2, opts_kw: dict) -> tuple[dict, dict]:
    """Align the same batch twice (phased on/off); return both record
    maps. Works on any backend — the e2e CI test reuses it on CPU."""
    import io

    from soap3dp_tpu.io.sam import SamWriter
    from soap3dp_tpu.pipeline.options import AlignOptions
    from soap3dp_tpu.pipeline.pair import (Phase2Queue, RescueQueue,
                                           align_pair_batch,
                                           dispatch_pair_search)

    out = {}
    for phased in (True, False):
        opts = AlignOptions(phased_search=phased, **opts_kw)
        buf = io.BytesIO()
        w = SamWriter(buf, index)
        rq = RescueQueue(index, didx, opts)
        p2q = Phase2Queue(index, didx, opts)
        pend = dispatch_pair_search(didx, b1, b2, opts)
        align_pair_batch(index, didx, b1, b2, opts, w,
                         pending_search=pend, rescue_queue=rq,
                         phase2_queue=p2q)
        p2q.process(w, rq)
        rq.flush(w)
        out[phased] = parse_records(buf.getvalue())
    return out[True], out[False]


def divergence(a: dict, b: dict) -> dict:
    keys = set(a) | set(b)
    n = max(len(keys), 1)
    miss = sum(1 for k in keys if k not in a or k not in b)
    fields = ("pos", "mapq", "cigar", "flag", "x0", "x1", "xa")
    diff = {f: 0 for f in fields}
    any_diff = 0
    for k in keys:
        if k not in a or k not in b:
            any_diff += 1
            continue
        d = False
        for f in fields:
            if a[k][f] != b[k][f]:
                diff[f] += 1
                d = True
        any_diff += d
    return {
        "records": len(keys), "missing_either": miss,
        "any_field_rate": round(any_diff / n, 6),
        **{f + "_rate": round(diff[f] / n, 6) for f in fields},
    }


def main() -> int:
    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    from bench import INSERT, get_index, make_pairs
    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    index, codes = get_index(250_000_000, sa_rate=2, lut_k=13)
    didx = device_index(index)
    rng = np.random.default_rng(17)
    b1, b2 = make_pairs(codes, n_pairs, rng)
    a, b = run_ab(index, didx, b1, b2,
                  dict(min_insert=INSERT // 2, max_insert=INSERT * 2,
                       soap3_mismatch_allow=3))
    res = divergence(a, b)
    print(json.dumps({"n_pairs": n_pairs, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
