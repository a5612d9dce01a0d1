"""CLI execution: load index, stream batches, drive pipelines, write outputs.

The rebuild of the reference main loop (SOAP3-DP.cu:607-1138):
per-batch dispatch to the single/pair pipelines, per-run summary on
stderr, and a `.done` marker file at the end for external orchestration
(SOAP3-DP.cu:892-901). Multi-file mode reads the same list-file format
(README.md section 2.2 cases 3/4/6).
"""

from __future__ import annotations

import sys
import time

# the summary of the last run_single/run_pair in this process (read by
# callers that drive main() in-process, such as chip_smoke.py)
last_summary = None


def _init_hosts(args) -> tuple[int, int]:
    """Multi-host mode: initialize jax.distributed from flags/env.

    The analog of the reference's documented multi-GPU operation — one
    process per device with the index shared between them (README
    section 3, IndexHandler.cpp:180-226): one JAX process per host,
    each reading its stride of the input batches and writing its own
    output shard, merged like the reference's .gout.N files.
    """
    import os

    hosts = getattr(args, "hosts", None)
    if hosts is None:
        hosts = int(os.environ.get("SOAP3DP_NUM_HOSTS", "1"))
    if hosts <= 1:
        return 1, 0
    host_id = getattr(args, "host_id", None)
    if host_id is None:
        host_id = int(os.environ["SOAP3DP_HOST_ID"])
    coord = getattr(args, "coordinator", None) \
        or os.environ.get("SOAP3DP_COORDINATOR")
    import jax

    if coord:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=hosts, process_id=host_id)
    else:
        jax.distributed.initialize()  # env/cluster auto-detection
    print(f"[soap3dp] multi-host: process {host_id}/{hosts}, "
          f"{len(jax.local_devices())} local device(s)", file=sys.stderr)
    return hosts, host_id


def _stride(it, hosts: int, host_id: int):
    """Each host takes every hosts-th input batch (its input shard)."""
    for i, item in enumerate(it):
        if i % hosts == host_id:
            yield item


def _merge_summary(total, hosts: int) -> None:
    """Sum the per-host summary counters across processes and print the
    global totals (the DCN-collective merge from docs/SCALING.md)."""
    import dataclasses

    import numpy as np
    from jax.experimental import multihost_utils

    fields = [f.name for f in dataclasses.fields(total)]
    local = np.asarray([getattr(total, f) for f in fields], np.int64)
    all_counts = multihost_utils.process_allgather(local)
    merged = type(total)(**{f: int(v) for f, v in
                            zip(fields, all_counts.sum(axis=0))})
    print(f"[soap3dp] global (all {hosts} hosts): {merged}", file=sys.stderr)


def _hbm_budget():
    """Per-device HBM byte limit when the backend reports one (leave
    ~20% headroom for batch arrays), else None (reactive ladder only)."""
    import jax

    try:
        stats = jax.devices()[0].memory_stats()
        limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
        return int(limit * 0.8) if limit else None
    except Exception:  # noqa: BLE001 — backends without memory_stats
        return None


def _load(index_arg: str, devices: int = 1, local_only: bool = False):
    from soap3dp_tpu.fm.fmindex import device_index_ladder
    from soap3dp_tpu.index.builder import load_index
    from soap3dp_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    path = index_arg if index_arg.endswith(".t3i") else index_arg + ".t3i"
    t0 = time.time()
    index = load_index(path)
    if devices == 1:
        # degradation ladder: on device OOM the SA re-samples coarser
        # until the index fits (the reference's tryAlloc analog)
        didx, index = device_index_ladder(index, hbm_budget=_hbm_budget())
    else:
        # multi-chip: replicate the index into every chip's HBM and let
        # every pipeline stage shard its batches over the mesh
        # (discovered downstream via distributed.mesh.mesh_of)
        import jax

        from soap3dp_tpu.distributed import mesh as dmesh

        avail = jax.local_devices() if local_only else jax.devices()
        n = len(avail) if devices == 0 else min(devices, len(avail))
        m = dmesh.make_mesh(avail[:n])
        didx = dmesh.replicate_index(index, m)
        print(f"[soap3dp] device mesh: {n} chips", file=sys.stderr)
    print(f"[soap3dp] index loaded in {time.time() - t0:.2f}s "
          f"({index.n} bp, {len(index.names)} sequences)", file=sys.stderr)
    return index, didx


def _fix_quals(opts, *batches):
    """Illumina 1.3+ (-I): shift phred+64 qualities to phred+33
    (the reference converts at parse time, QueryParser.cpp)."""
    import numpy as np

    if not opts.illumina13:
        return
    for b in batches:
        if b.quals is not None:
            # rebind rather than mutate: batch matrices are sealed
            # read-only at ingest (they cross the writer-thread
            # boundary uncopied)
            q = np.where(b.quals != 0,
                         np.maximum(b.quals.astype(np.int16) - 31, 33),
                         0).astype(b.quals.dtype)
            q.flags.writeable = False
            b.quals = q


def _slice_batch(b, sl: slice):
    return b.take(sl)


def _align_backoff(align_one, summary_cls, batches, min_reads=1024,
                   pending=None):
    """Align one batch; on device OOM, halve and retry (recursively).

    The batch-level rung of the degradation ladder (the reference
    degrades GPU DP block counts the same way, tryAlloc
    DV-DPfunctions.cu:554-612): a batch too big for the device's free
    HBM is split until it fits, with a floor of ``min_reads``.
    ``pending`` (an already-dispatched search) is only usable by the
    full-size attempt; halves re-dispatch.
    """
    from soap3dp_tpu.fm.fmindex import is_oom_error

    n = len(batches[0].names)
    try:
        return align_one(*batches, pending)
    except Exception as e:  # noqa: BLE001 — only OOM is handled
        if not is_oom_error(e) or n <= min_reads:
            raise
    mid = n // 2
    print(f"[soap3dp] device OOM on a {n}-read batch; retrying as "
          f"2 x {mid}", file=sys.stderr)
    s = summary_cls()
    for sl in (slice(0, mid), slice(mid, None)):
        s.add(_align_backoff(align_one, summary_cls,
                             tuple(_slice_batch(b, sl) for b in batches),
                             min_reads=min_reads))
    return s


def _writer(opts, index, path):
    from soap3dp_tpu.io.aio import AsyncWriter
    from soap3dp_tpu.io.sam import SamWriter
    from soap3dp_tpu.io.succinct import SuccinctWriter, BamWriter
    from soap3dp_tpu.pipeline import options as opt

    if opts.output_format == opt.FORMAT_SUCCINCT:
        w = SuccinctWriter(path + ".gout", index)
    elif opts.output_format == opt.FORMAT_BAM:
        w = BamWriter(path + ".bam", index, read_group=opts.read_group,
                      sample=opts.sample_name, rg_option=opts.rg_option)
    else:
        w = SamWriter(path + ".sam", index, read_group=opts.read_group,
                      sample=opts.sample_name, rg_option=opts.rg_option)
    # serialization + file IO run on an output thread (the reference's
    # output pthreads, alignment.cu:1005-1027)
    return AsyncWriter(w)


def run_single(args) -> int:
    # distributed init must precede any import that touches the XLA
    # backend (pipeline modules query it at import time)
    hosts, host_id = _init_hosts(args)

    from soap3dp_tpu.cli.main import _build_options
    from soap3dp_tpu.io.fastq import read_single
    from soap3dp_tpu.pipeline.single import (BatchSummary,
                                             align_single_batch,
                                             dispatch_single_search)

    from soap3dp_tpu.io.aio import prefetch

    from soap3dp_tpu.pipeline.single import SalvageQueue

    from soap3dp_tpu.utils import timers

    opts = _build_options(args, args.reads)
    if hosts > 1:
        opts.output_prefix += f".{host_id}"
    index, didx = _load(args.index, getattr(args, "devices", 1),
                        local_only=hosts > 1)
    total = BatchSummary()
    with _writer(opts, index, opts.output_prefix) as w:
        from soap3dp_tpu.pipeline.single import SinglePhase2Queue

        from soap3dp_tpu.pipeline.overlap import AsyncFlusher

        sq = SalvageQueue(index, didx, opts)
        spq = SinglePhase2Queue(index, didx, opts)
        flusher = AsyncFlusher(sq, w)
        # double-buffered batch loop (same pattern as run_pair): the
        # next batch's device search runs during this batch's host work
        it = prefetch(_stride(read_single(args.reads, opts.batch_size,
                                          opts.max_read_len),
                              hosts, host_id))
        cur = next(it, None)
        if cur is not None:
            _fix_quals(opts, cur)
        pending = dispatch_single_search(didx, cur, opts) \
            if cur is not None else None
        while cur is not None:
            w.poll()  # stop aligning as soon as output is failing
            nxt = next(it, None)
            if nxt is not None:
                _fix_quals(opts, nxt)
            with timers.stage("runner.dispatch"):
                nxt_pending = dispatch_single_search(didx, nxt, opts) \
                    if nxt is not None else None
            t0 = time.time()
            s = _align_backoff(
                lambda b, p: align_single_batch(index, didx, b, opts, w,
                                                salvage_queue=sq,
                                                pending_search=p,
                                                phase2_queue=spq),
                BatchSummary, (cur,), pending=pending)
            total.add(s)
            flusher.maybe_submit()
            print(f"[soap3dp] batch: {s.num_reads} reads, "
                  f"{s.aligned_bwt} BWT-aligned ({time.time() - t0:.2f}s)",
                  file=sys.stderr)
            cur, pending = nxt, nxt_pending
        # end-of-run drain: flush the salvage backlog on the worker
        # FIRST so it overlaps the last batch's deferred escalations
        # (spq host work), then flush what those escalations re-queued
        flusher.submit()
        total.add(spq.process(w, sq))
        flusher.submit()
        flusher.join(total.add)
    _summary(opts, total)
    if hosts > 1:
        _merge_summary(total, hosts)
    return 0


def run_pair(args) -> int:
    # distributed init must precede any import that touches the XLA
    # backend (pipeline modules query it at import time)
    hosts, host_id = _init_hosts(args)

    from soap3dp_tpu.cli.main import _build_options
    from soap3dp_tpu.io.fastq import read_pairs
    from soap3dp_tpu.pipeline.pair import PairSummary, align_pair_batch

    from soap3dp_tpu.pipeline.pair import dispatch_pair_search

    from soap3dp_tpu.pipeline.pair import RescueQueue

    opts = _build_options(args, args.reads1)
    if hosts > 1:
        opts.output_prefix += f".{host_id}"
    index, didx = _load(args.index, getattr(args, "devices", 1),
                        local_only=hosts > 1)
    total = PairSummary()
    with _writer(opts, index, opts.output_prefix) as w:
        # double-buffered batch loop: the next batch's device search runs
        # while this batch's host post-processing/output happens; a
        # reader thread prefetches/parses input batches (AIO analog);
        # DP rescue of phase-A failures accumulates across batches and
        # flushes as one large batch (RescueQueue)
        from soap3dp_tpu.io.aio import prefetch

        from soap3dp_tpu.pipeline.pair import Phase2Queue

        rq = RescueQueue(index, didx, opts)
        p2q = Phase2Queue(index, didx, opts)
        it = prefetch(_stride(read_pairs(args.reads1, args.reads2,
                                         opts.batch_size, opts.max_read_len),
                              hosts, host_id))
        from soap3dp_tpu.utils import timers

        from soap3dp_tpu.pipeline.overlap import AsyncFlusher

        def _report_flush(qn, fs):
            if qn:
                print(f"[soap3dp] rescue flush: {qn} pairs -> "
                      f"{fs.paired_dp} DP-paired, "
                      f"{fs.single_rescued} singly aligned, "
                      f"{fs.unaligned} unaligned", file=sys.stderr)

        # rescue flushes run on a worker thread: their wall time is
        # mostly device waits, which now overlap the next batches'
        # dispatch + host work (pipeline/overlap.py)
        flusher = AsyncFlusher(rq, w, on_flush=_report_flush)
        cur = next(it, None)
        if cur:
            _fix_quals(opts, *cur)
        pending = dispatch_pair_search(didx, *cur, opts) if cur else None
        while cur is not None:
            w.poll()  # stop aligning as soon as output is failing
            b1, b2 = cur
            nxt = next(it, None)
            if nxt:
                _fix_quals(opts, *nxt)
            with timers.stage("runner.dispatch"):
                nxt_pending = dispatch_pair_search(didx, *nxt, opts) \
                    if nxt else None
            t0 = time.time()
            s = _align_backoff(
                lambda x1, x2, p: align_pair_batch(index, didx, x1, x2, opts,
                                                   w, pending_search=p,
                                                   rescue_queue=rq,
                                                   phase2_queue=p2q),
                PairSummary, (b1, b2), pending=pending)
            total.add(s)
            flusher.maybe_submit()
            cur, pending = nxt, nxt_pending
            print(f"[soap3dp] batch: {s.num_pairs} pairs, "
                  f"{s.paired_bwt} BWT-paired ({time.time() - t0:.2f}s)",
                  file=sys.stderr)
        # end-of-run drain: flush the rescue backlog on the worker FIRST
        # so it overlaps the last batch's deferred escalations (p2q host
        # work), then flush what those escalations re-queued
        flusher.submit()
        total.add(p2q.process(w, rq))
        flusher.submit()
        flusher.join(total.add)
    _summary(opts, total)
    if hosts > 1:
        _merge_summary(total, hosts)
    return 0


def run_multi(cmd: str, args) -> int:
    """Multi-file list mode: one line per read set (README section 2.2)."""
    import copy

    rc = 0
    with open(args.listfile) as fh:
        lines = [l.rstrip("\n").split("\t") for l in fh if l.strip()]
    for cols in lines:
        sub = copy.copy(args)
        if cmd == "pair-multi":
            sub.reads1, sub.reads2 = cols[0], cols[1]
            sub.min_insert, sub.max_insert = int(cols[2]), int(cols[3])
            sub.output_prefix = cols[4]
            if len(cols) > 5:
                sub.read_group = cols[5]
            if len(cols) > 6:
                sub.sample_name = cols[6]
            if len(cols) > 7:
                sub.rg_option = cols[7]
            rc |= run_pair(sub)
        else:
            sub.reads = cols[0]
            sub.output_prefix = cols[1] if len(cols) > 1 else cols[0]
            rc |= run_single(sub)
    return rc


def _summary(opts, total) -> None:
    from soap3dp_tpu.utils import timers

    global last_summary
    last_summary = total
    timers.report()
    print(f"[soap3dp] done: {total}", file=sys.stderr)
    flagged = getattr(total, "still_flagged", 0)
    capped = getattr(total, "capped_anchors", 0)
    if flagged or capped:
        # the reference re-aligns such reads fully on the host
        # (ProcessReadDoubleStrand2, CPUfunctions.cpp:555); here
        # truncation past round 3 is bounded but must not be silent
        print(f"[soap3dp] warning: incomplete hit sets — "
              f"{flagged} read(s) still over the round-3 placement budget"
              + (f", {capped} anchor(s) hit the pairing fan-out cap"
                 if capped else ""),
              file=sys.stderr)
    with open(opts.output_prefix + ".done", "w") as fh:
        fh.write("done\n")
