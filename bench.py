"""Benchmark: single-device trim throughput of the batched engine.

Reports one JSON line. ``value`` (``reads/s/chip``) is the **median** of
``TRIALS`` pipelined windows of the core device kernel (semi-global
adapter DP, SE adapter trim, 100 bp reads, TruSeq 33 bp adapter, e=0.1)
— ``ITERS`` launches chained through a zero-valued data dependency, one
bytes-fetching synchronization per window. The per-window distribution
ships in ``extra.kernel_window_trials_mreads``; ``extra.kernel_best`` is
the best window. ``extra.device`` names the device JAX reports and
``extra.card`` the card's name and power limit.

Extras:

- ``dp_cell_updates_per_sec``: median reads/s x m x L (classic DP measure).
- ``end_to_end_reads_per_sec``: the FULL turbo trim pipeline on a real
  on-disk FASTQ via the real CLI.
- ``end_to_end_quality_only_reads_per_sec``: the quality-trim-only turbo
  pipeline (no adapter stage) via the real CLI.
- ``pe_insert_pairs_per_sec``: the paired-end insert-overlap matcher's
  diagonal counts, same pipelined-window methodology, median-of-trials.
- ``end_to_end_pe_pairs_per_sec`` / ``end_to_end_pe_insert_pairs_per_sec``:
  the full PAIRED turbo pipeline via the real CLI, both aligners.
- ``host_path_reads_per_sec`` (+ ``_per_core``): the standalone native
  host path — FASTQ parse -> bit-pack gather -> trimmed-record format,
  no device — single-core and all-core (the product overlaps these
  phases across threads via the prefetch/lazy-format pipeline in
  engine/turbo.py).

Baseline: the reference trims ~800k simulated 125 bp pairs in 32.7-43.5 s
using 4 CPU cores (PeerJ paper TableS2; see BASELINE.md) — about 42k
reads/s end to end. ``vs_baseline`` compares like with like: the
end-to-end paired-end CLI rate here (reads = 2 x pairs, adapter aligner)
over that end-to-end rate. (The headline kernel window is not comparable
to an end-to-end rate and is not divided by it.)

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_READS_PER_SEC = 42_000.0  # reference: ~800k pairs / ~38 s on 4 cores

ADAPTER = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"  # TruSeq, 33 bp
BATCH = 65536  # reads per kernel call in the kernel windows
READ_LEN = 100
ITERS = 64
TRIALS = 7
E2E_READS = 500_000


def make_read_matrix(batch, read_len, adapter, seed=0):
    """[batch, read_len] uint8 random reads, ~50% carrying the adapter."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    arr = bases[rng.integers(0, 4, size=(batch, read_len))]
    ad = np.frombuffer(adapter.encode(), np.uint8)
    has = rng.random(batch) < 0.5
    pos = rng.integers(20, read_len - 5, size=batch)
    for i in np.nonzero(has)[0]:
        p = int(pos[i])
        alen = min(len(ad), read_len - p)
        arr[i, p : p + alen] = ad[:alen]
    return arr


def write_fastq(path, arr):
    import numpy as np

    batch, read_len = arr.shape
    qual = b"I" * read_len
    with open(path, "wb") as fh:
        chunks = []
        for i in range(batch):
            chunks.append(
                b"@r%d\n%s\n+\n%s\n" % (i, arr[i].tobytes(), qual)
            )
            if len(chunks) >= 50000:
                fh.write(b"".join(chunks))
                chunks = []
        fh.write(b"".join(chunks))


def _scan_runner(arr, jax, jnp):
    """Window of the XLA column scan (``BatchAligner.locate_device``)
    over device-resident inputs."""
    import numpy as np

    from atropos_tpu.align.batched import BatchAligner
    from atropos_tpu.align.flags import (
        START_WITHIN_SEQ2,
        STOP_WITHIN_SEQ1,
        STOP_WITHIN_SEQ2,
    )

    back = START_WITHIN_SEQ2 | STOP_WITHIN_SEQ2 | STOP_WITHIN_SEQ1
    aligner = BatchAligner(ADAPTER, 0.1, back, min_overlap=3)
    d_reads = jax.device_put(aligner._query_lut_np[arr])
    d_len = jax.device_put(np.full(arr.shape[0], arr.shape[1], np.int32))

    # Chain ITERS launches through a zero-valued data dependency
    # (cost>>31 == 0) so no call can be elided or reordered; the window
    # ends in a bytes-fetching np.asarray.
    @jax.jit
    def window(reads, lens):
        def cost(lens):
            return aligner.locate_device(reads, lens)["cost"]

        def body(_, out):
            return cost(lens + jnp.right_shift(out, 31))

        return jax.lax.fori_loop(0, ITERS - 1, body, cost(lens))

    def run():
        return np.asarray(window(d_reads, d_len))

    return run, ITERS


def _window_rates(run, batches_per_call, trials=TRIALS):
    """Per-trial window throughput (batches/s), sorted ascending."""
    rates = []
    for _ in range(trials):
        t0 = time.time()
        run()
        rates.append(batches_per_call / (time.time() - t0))
    return sorted(rates)


def _median(rates):
    n = len(rates)
    mid = n // 2
    return rates[mid] if n % 2 else (rates[mid - 1] + rates[mid]) / 2


def bench_kernel(arr, jax, jnp):
    """(median reads/s, best reads/s, per-trial reads/s list)."""
    run, batches_per_call = _scan_runner(arr, jax, jnp)
    run()  # compile (the fetch synchronizes)
    rates = [r * BATCH for r in _window_rates(run, batches_per_call)]
    return _median(rates), rates[-1], rates


def bench_pe_insert(jax, jnp):
    """Paired-end insert-overlap matcher window (median pairs/s) of the
    diagonal counts the fused pair step runs."""
    import numpy as np

    from atropos_tpu.align.batched import _diagonal_match_counts as counts_core

    rng = np.random.default_rng(1)
    bases = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    r1 = bases[rng.integers(0, 4, size=(BATCH, READ_LEN))]
    # half the pairs read through: read2 = rc(read1) with sprinkled errors
    r2 = comp[r1[:, ::-1]].copy()
    noise = rng.random((BATCH, READ_LEN)) < 0.02
    r2[noise] = bases[rng.integers(0, 4, size=int(noise.sum()))]
    refs_T = jnp.asarray(comp[r2[:, ::-1]].T.astype(np.int32))
    reads_T = jnp.asarray(r1.T.astype(np.int32))
    len_row = jnp.asarray(np.full((1, BATCH), READ_LEN, np.int32))

    @jax.jit
    def window(refs, reads, lens):
        def body(_, out):
            dep = jnp.right_shift(out[0:1, :], 31)
            return counts_core(refs, reads, lens + dep)

        return jax.lax.fori_loop(
            0, ITERS - 1, body, counts_core(refs, reads, lens)
        )

    def run():
        return np.asarray(window(refs_T, reads_T, len_row))

    run()
    return _median(_window_rates(run, ITERS)) * BATCH


def bench_host_path():
    """Standalone native host path (parse -> packed gather -> format),
    no device: (single_core_reads_per_sec, all_core_reads_per_sec)."""
    import threading

    import numpy as np

    from atropos_tpu import runtime
    from atropos_tpu.runtime import _i32, _i64, _lib, _u8, parse_chunk

    if not runtime.available():
        return 0.0, 0.0
    n, read_len = 250_000, READ_LEN
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    arr = bases[rng.integers(0, 4, size=(n, read_len))]
    qual = b"I" * read_len
    buf = b"".join(
        b"@r%d\n%s\n+\n%s\n" % (i, arr[i].tobytes(), qual)
        for i in range(n)
    )
    code_lut = np.zeros(256, np.uint8)
    code_lut[bases] = np.arange(4, dtype=np.uint8)
    width = ((read_len + 15) // 16) * 16

    def full_path():
        chunk = parse_chunk(buf)
        bufarr = chunk.buf
        if not isinstance(bufarr, np.ndarray):
            bufarr = np.frombuffer(bufarr, np.uint8)
        offs = np.ascontiguousarray(chunk.seq_off)
        lens = np.ascontiguousarray(chunk.seq_len)
        packed = np.zeros((chunk.n, width // 4), np.uint8)
        _lib.gather_packed(
            _u8(bufarr), _i64(offs), _i32(lens), chunk.n, width,
            _u8(code_lut), 2, _u8(packed),
        )
        ks = np.zeros(chunk.n, np.int32)
        kp = lens.astype(np.int32) - 20
        keep = np.ones(chunk.n, np.uint8)
        cap = len(buf) + 16
        out = np.empty(cap, np.uint8)
        _lib.fastq_format_trimmed(
            _u8(bufarr),
            _i64(np.ascontiguousarray(chunk.name_off)),
            _i32(np.ascontiguousarray(chunk.name_len)),
            _i64(offs),
            _i64(np.ascontiguousarray(chunk.plus_off)),
            _i32(np.ascontiguousarray(chunk.plus_len)),
            _i64(np.ascontiguousarray(chunk.qual_off)),
            _i32(ks), _i32(kp), _u8(keep), chunk.n, _u8(out), cap,
            None, None, None, None, None, None, None, None,
        )
        return chunk.n

    def measure(n_threads, reps=3):
        best = float("inf")
        for _ in range(3):
            threads = [
                threading.Thread(
                    target=lambda: [full_path() for _ in range(reps)]
                )
                for _ in range(n_threads)
            ]
            t0 = time.time()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            best = min(best, time.time() - t0)
        return n * reps * n_threads / best

    single = measure(1)
    cores = os.cpu_count() or 1
    return single, measure(cores) if cores > 1 else single


def bench_end_to_end(arr, quality_only=False):
    """Full turbo pipeline via the real CLI on an on-disk FASTQ.
    ``quality_only`` benches the adapter-less configuration (-q 20):
    the quality kernels + window resolution with no DP stage."""
    import numpy as np

    from atropos_tpu.commands import execute_cli

    tmp = os.path.join(tempfile.gettempdir(), "atropos_bench")
    os.makedirs(tmp, exist_ok=True)
    inp = os.path.join(tmp, "bench_in.fastq")
    out = os.path.join(tmp, "bench_out.fastq")
    report = os.path.join(tmp, "report.txt")
    reps = -(-E2E_READS // arr.shape[0])
    big = np.tile(arr, (reps, 1))[:E2E_READS]
    write_fastq(inp, big)

    stage = ["-q", "20"] if quality_only else ["-a", ADAPTER]
    argv = [
        "trim", "-se", inp, "-o", out,
        "--no-default-adapters", "--report-file", report, "--quiet",
    ] + stage
    rc = execute_cli(list(argv))  # warm: compiles device steps
    if rc != 0:
        return 0.0
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        execute_cli(list(argv))
        best = min(best, time.time() - t0)
    return E2E_READS / best


ADAPTER2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"  # TruSeq R2, 33 bp


def _write_pe_inputs(arr, pairs, tmp):
    """Two on-disk FASTQs: half the pairs are proper short-insert pairs
    (read2 = rc(read1-with-insert) so the insert matcher finds the
    overlap and both adapters), half are independent reads (the insert
    path's fallback lane)."""
    import numpy as np

    inp1 = os.path.join(tmp, "bench_in.1.fastq")
    inp2 = os.path.join(tmp, "bench_in.2.fastq")
    reps = -(-pairs // arr.shape[0])
    big = np.tile(arr, (reps, 1))[:pairs]
    write_fastq(inp1, big)
    arr2 = make_read_matrix(arr.shape[0], arr.shape[1], ADAPTER2, seed=3)
    big2 = np.tile(arr2, (reps, 1))[:pairs]
    # overlap half: read2 = rc(read1) — a full-length insert overlap
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    half = pairs // 2
    big2[:half] = comp[big[:half, ::-1]]
    write_fastq(inp2, big2)
    return inp1, inp2


def bench_end_to_end_pe(arr, aligner):
    """Full PAIRED turbo pipeline via the real CLI: two on-disk FASTQs,
    two output streams, pair filters. Pairs/s for the given aligner
    (``adapter`` = independent per-mate matching, ``insert`` = the
    insert-overlap lane, reference TableS2's two benchmark modes)."""
    from atropos_tpu.commands import execute_cli

    pairs = E2E_READS // 2
    tmp = os.path.join(tempfile.gettempdir(), "atropos_bench")
    os.makedirs(tmp, exist_ok=True)
    inp1, inp2 = _write_pe_inputs(arr, pairs, tmp)
    out1 = os.path.join(tmp, "bench_out.1.fastq")
    out2 = os.path.join(tmp, "bench_out.2.fastq")
    report = os.path.join(tmp, "report_pe.txt")

    argv = [
        "trim", "-pe1", inp1, "-pe2", inp2,
        "-a", ADAPTER, "-A", ADAPTER2, "--aligner", aligner,
        "-o", out1, "-p", out2,
        "--no-default-adapters", "--report-file", report, "--quiet",
    ]
    rc = execute_cli(list(argv))
    if rc != 0:
        return 0.0
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        execute_cli(list(argv))
        best = min(best, time.time() - t0)
    return pairs / best


def _guard(fn, default=0.0):
    """Extras must never take down the headline record: a failing
    sub-benchmark reports its default (0.0 = 'did not run') and the
    exception goes to stderr."""
    try:
        return fn()
    except Exception as exc:
        import traceback

        print("bench extra failed: %r" % (exc,), file=sys.stderr)
        traceback.print_exc()
        return default


def _card():
    """``name, power.limit`` from nvidia-smi, or "not available"."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
    except (OSError, subprocess.CalledProcessError):
        return "not available"
    return out.stdout.strip().splitlines()[0]


def main():
    from atropos_tpu import configure_compile_cache

    configure_compile_cache()
    import jax
    import jax.numpy as jnp

    device = jax.devices()[0]
    arr = make_read_matrix(BATCH, READ_LEN, ADAPTER)
    kernel_med, kernel_best, kernel_trials = bench_kernel(arr, jax, jnp)
    pe_pps = _guard(lambda: bench_pe_insert(jax, jnp))
    host_single, host_all = _guard(
        lambda: bench_host_path(), default=(0.0, 0.0)
    )
    e2e_pe_ins_pps = _guard(lambda: bench_end_to_end_pe(arr, "insert"))
    e2e_rps = _guard(lambda: bench_end_to_end(arr))
    e2e_q_rps = _guard(lambda: bench_end_to_end(arr, quality_only=True))
    e2e_pe_pps = _guard(lambda: bench_end_to_end_pe(arr, "adapter"))

    print(
        json.dumps(
            dict(
                metric="se_adapter_trim_reads_per_sec_per_chip",
                value=round(kernel_med, 1),
                unit="reads/s/chip",
                vs_baseline=round(
                    2 * e2e_pe_pps / BASELINE_READS_PER_SEC, 3
                ),
                extra=dict(
                    methodology=(
                        "median of %d pipelined %d-launch windows; "
                        "per-trial distribution below" % (TRIALS, ITERS)
                    ),
                    device=dict(
                        platform=device.platform,
                        kind=device.device_kind,
                        count=len(jax.devices()),
                    ),
                    card=_card(),
                    vs_baseline_basis=(
                        "end-to-end PE adapter-trim reads/s (2 x pairs/s) "
                        "over the reference's 4-core end-to-end reads/s"
                    ),
                    kernel_best_reads_per_sec=round(kernel_best, 1),
                    kernel_window_trials_mreads=[
                        round(r / 1e6, 2) for r in kernel_trials
                    ],
                    dp_cell_updates_per_sec=round(
                        kernel_med * len(ADAPTER) * READ_LEN
                    ),
                    end_to_end_reads_per_sec=round(e2e_rps, 1),
                    end_to_end_quality_only_reads_per_sec=round(
                        e2e_q_rps, 1
                    ),
                    end_to_end_note=(
                        "full CLI turbo pipeline (parse->device->format->"
                        "write), best of 2 runs after a compiling run"
                    ),
                    pe_insert_pairs_per_sec=round(pe_pps, 1),
                    end_to_end_pe_pairs_per_sec=round(e2e_pe_pps, 1),
                    end_to_end_pe_insert_pairs_per_sec=round(
                        e2e_pe_ins_pps, 1
                    ),
                    host_path_reads_per_sec=round(host_all, 1),
                    host_path_reads_per_sec_per_core=round(host_single, 1),
                    host_cores=os.cpu_count(),
                ),
            )
        )
    )


if __name__ == "__main__":
    main()
