#!/usr/bin/env python3
"""Smoke test of the trim path on one NVIDIA GPU, through the normal
entry points, in one process.

    python chip_smoke.py          # phases 1-4 on one card
    python chip_smoke.py --four   # the 4-card sharded trims only

Phases (one card):

1. Kernel parity at real widths: the XLA column scan, compiled for the
   card, runs 32,768-read batches (100 bp and 150 bp, TruSeq adapter,
   e = 0.1, all five adapter types, indel cost 1 and 100000, one
   wildcard case) and equals the scalar oracle on a 2,048-read sample
   of each; the insert matcher's diagonal counts on a 32,768-pair batch
   equal a host count on a sample. Tolerance is zero: the trim path is
   integer-only.
2. Kernel timings: the XLA scan and the insert matcher's counts at the
   turbo batch and at 8x it; the two upload decode forms.
3. CLI trims at sequencing-run stream sizes (1M SE 100 bp reads with
   ``-a``; 500k PE 125 bp pairs with ``--aligner adapter`` and
   ``--aligner insert``; the SE file with ``-q 20`` only): turbo must
   run, and the first 20,000 records must be byte-identical to the
   scalar pipeline on a 20,000-record prefix.
4. ``qc`` and ``detect -d known`` on 200,000 reads, ``detect -d khmer``
   on 20,000, each with its device path on and off: identical reports.

``--four`` runs the SE and PE-insert trims of phase 3 sharded over four
cards and compares their bytes with a single-card run in this process.

Exits non-zero, printing no result, when JAX finds no GPU. The last line
of standard output is one JSON object with the device JAX reports.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
TRUSEQ_R2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
WILDCARD_ADAPTER = "AGATCGGAAGNNCACACGTCTRAACTCCAGTCA"

BATCH = 32768
ORACLE_SAMPLE = 2048
SE_READS = 1_000_000
PE_PAIRS = 500_000
PREFIX = 20_000
OTHER_READS = 200_000

#: report lines that differ between any two runs (times, modes)
_VOLATILE = re.compile(
    r"Command line|Start time|Wallclock|CPU time|threads|mode|Program|Version"
)


def log(message):
    print(message, flush=True)


def card_lines():
    """``name, power.limit`` of each card, from ``nvidia-smi`` in a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def start_jax():
    """Hold JAX to the GPU and return its devices; exit without a result
    when there is none."""
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    sys.path.insert(0, REPO)
    from atropos_tpu import configure_compile_cache

    cache = configure_compile_cache()
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as err:
        raise SystemExit("chip_smoke: no GPU found: %s" % err)
    if devices[0].platform != "gpu":
        raise SystemExit(
            "chip_smoke: no GPU found (JAX platform is %r)"
            % devices[0].platform
        )
    log("jax %s, compile cache %s" % (jax.__version__, cache))
    return jax, devices


# -- seeded data ---------------------------------------------------------------


def _rng(seed):
    import numpy as np

    return np.random.default_rng(seed)


def parity_reads(batch, width, adapter, seed, n_rate=0.0):
    """[batch, width] uint8 reads of varied length (width/2..width) in
    ``(reads, lengths)``; 60% carry a mutated adapter fragment (a few
    substitutions, sometimes one indel) at the start, the middle or the
    end, so every adapter type finds real hits."""
    import numpy as np

    rng = _rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = bases[rng.integers(0, 4, size=(batch, width), dtype=np.uint8)]
    if n_rate:
        reads[rng.random((batch, width)) < n_rate] = ord("N")
    lengths = rng.integers(width // 2, width + 1, size=batch).astype(np.int32)
    ad = np.frombuffer(adapter.encode(), np.uint8)
    for b in np.nonzero(rng.random(batch) < 0.6)[0]:
        frag = ad.copy()
        for _ in range(rng.integers(0, 3)):
            frag[rng.integers(len(frag))] = bases[rng.integers(4)]
        if rng.random() < 0.3:
            frag = np.delete(frag, rng.integers(len(frag)))
        frag = frag[: rng.integers(3, len(frag) + 1)]
        n = int(lengths[b])
        where = rng.integers(3)
        pos = 0 if where == 0 else (
            n - len(frag) if where == 2 else rng.integers(0, n)
        )
        pos = max(0, int(pos))
        take = min(len(frag), n - pos)
        reads[b, pos : pos + take] = frag[:take]
    reads[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return reads, lengths


def _names(prefix, count):
    import numpy as np

    digits = np.arange(count)[:, None] // (10 ** np.arange(8)[::-1]) % 10
    head = np.frombuffer(b"@" + prefix, np.uint8)
    return np.concatenate(
        [np.broadcast_to(head, (count, head.size)),
         (digits + ord("0")).astype(np.uint8)],
        axis=1,
    )


def write_fastq(path, seqs, quals, prefix):
    """Fixed-width FASTQ records (``@<prefix><8 digits>``) in one write."""
    import numpy as np

    count, width = seqs.shape
    nl = np.full((count, 1), ord("\n"), np.uint8)
    plus = np.full((count, 1), ord("+"), np.uint8)
    rec = np.concatenate(
        [_names(prefix, count), nl, seqs, nl, plus, nl, quals, nl], axis=1
    )
    with open(path, "wb") as handle:
        handle.write(rec.tobytes())


def _quals(rng, count, width):
    """Phred+33 qualities that fall toward the 3' end, so -q 20 trims."""
    import numpy as np

    base = np.linspace(38, 12, width)[None, :]
    q = base + rng.normal(0, 6, size=(count, width))
    return (np.clip(q, 2, 41) + 33).astype(np.uint8)


def se_reads(count, width, seed):
    """ACGT reads, half with the TruSeq adapter from a random position."""
    from tools.kernel_timings import random_reads

    return random_reads(count, width, TRUSEQ, seed), _quals(
        _rng(seed + 1), count, width
    )


def pe_reads(count, width, seed):
    """Mate pairs: half have a short insert (60..width) read through into
    the adapters, read2 = rc(insert) + R2 adapter; half are unrelated
    reads."""
    import numpy as np

    rng = _rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    insert = bases[rng.integers(0, 4, size=(count, width), dtype=np.uint8)]
    ins_len = rng.integers(60, width + 1, size=count)
    cols = np.arange(width)[None, :]
    tail = cols - ins_len[:, None]

    def mate(seq, adapter):
        ad = np.frombuffer(adapter.encode(), np.uint8)
        filler = bases[rng.integers(0, 4, size=(count, width), dtype=np.uint8)]
        out = np.where(tail < 0, seq, filler)
        in_ad = (tail >= 0) & (tail < len(ad))
        return np.where(in_ad, ad[np.clip(tail, 0, len(ad) - 1)], out)

    rev = np.clip(ins_len[:, None] - 1 - cols, 0, width - 1)
    read1 = mate(insert, TRUSEQ)
    read2 = mate(comp[np.take_along_axis(insert, rev, axis=1)], TRUSEQ_R2)
    unrelated = rng.random(count) < 0.5
    read2[unrelated] = bases[
        rng.integers(0, 4, size=(int(unrelated.sum()), width), dtype=np.uint8)
    ]
    return (
        (read1, _quals(rng, count, width)),
        (read2, _quals(rng, count, width)),
    )


# -- phase 1: parity -----------------------------------------------------------


def phase_parity():
    import numpy as np

    from atropos_tpu.align import oracle
    from atropos_tpu.align.batched import BatchAligner, _diagonal_match_counts
    from atropos_tpu.align.flags import (
        SEMIGLOBAL,
        START_WITHIN_SEQ1,
        START_WITHIN_SEQ2,
        STOP_WITHIN_SEQ1,
        STOP_WITHIN_SEQ2,
    )
    from atropos_tpu.engine.turbo import _InsertPair
    from tools.kernel_timings import insert_planes

    back = START_WITHIN_SEQ2 | STOP_WITHIN_SEQ2 | STOP_WITHIN_SEQ1
    flag_cases = [
        ("back", back),
        ("front", START_WITHIN_SEQ2 | STOP_WITHIN_SEQ2 | START_WITHIN_SEQ1),
        ("prefix", STOP_WITHIN_SEQ2),
        ("suffix", START_WITHIN_SEQ2),
        ("anywhere", SEMIGLOBAL),
    ]
    cases = [
        (name, flags, indel, TRUSEQ, {})
        for name, flags in flag_cases
        for indel in (1, 100000)
    ] + [
        ("back-wildcard", back, 1, WILDCARD_ADAPTER,
         dict(wildcard_ref=True, wildcard_query=True)),
    ]
    fields = ("start1", "stop1", "start2", "stop2", "matches", "cost")
    for width in (100, 150):
        for seed, (name, flags, indel, adapter, wild) in enumerate(cases):
            reads, lengths = parity_reads(
                BATCH, width, adapter, seed, n_rate=0.01 if wild else 0.0
            )
            args = dict(min_overlap=3, indel_cost=indel, **wild)
            got = BatchAligner(adapter, 0.1, flags, **args).locate_batch(
                reads, lengths
            )
            got = {key: np.asarray(val) for key, val in got.items()}
            assert got["found"].shape == (BATCH,), name
            scalar = oracle.Aligner(adapter, 0.1, flags, **args)
            for b in range(ORACLE_SAMPLE):
                read = reads[b, : lengths[b]].tobytes().decode()
                expect = scalar.locate(read)
                have = (
                    tuple(int(got[key][b]) for key in fields)
                    if got["found"][b] else None
                )
                assert have == expect, "%s/%d read %d: %r != oracle %r" % (
                    name, width, b, have, expect,
                )
            log("phase 1 parity %s %d bp indel_cost=%d: XLA scan on %d reads"
                " (%d found) == oracle on %d" % (
                    name, width, indel, BATCH, int(got["found"].sum()),
                    ORACLE_SAMPLE))

    refs, queries, lens = insert_planes(BATCH, 128)
    scan = np.asarray(_diagonal_match_counts(refs, queries, lens))
    assert scan.shape == (128, BATCH), scan.shape
    host = _InsertPair._host_counts(
        refs[:, :ORACLE_SAMPLE].T.astype(np.uint8),
        queries[:, :ORACLE_SAMPLE].T.astype(np.uint8),
        lens[0, :ORACLE_SAMPLE],
    )
    assert np.array_equal(host, scan[:, :ORACLE_SAMPLE]), "scan != host"
    log("phase 1 parity insert counts: scan on %d pairs == host on %d" % (
        BATCH, ORACLE_SAMPLE))


# -- phase 2: timings ----------------------------------------------------------


def phase_timings(card):
    import jax

    from atropos_tpu.align.batched import BatchAligner
    from atropos_tpu.align.flags import (
        START_WITHIN_SEQ2,
        STOP_WITHIN_SEQ1,
        STOP_WITHIN_SEQ2,
    )
    from tools import kernel_timings as kt

    back = START_WITHIN_SEQ2 | STOP_WITHIN_SEQ2 | STOP_WITHIN_SEQ1
    step = jax.jit(BatchAligner(TRUSEQ, 0.1, back, min_overlap=3).locate_device)
    compiled = step.lower(
        jax.ShapeDtypeStruct((BATCH, 128), "uint8"),
        jax.ShapeDtypeStruct((BATCH,), "int32"),
    ).compile()
    log("phase 2 memory_analysis DP step [%d reads x 128]: %s" % (
        BATCH, compiled.memory_analysis()))

    def fmt(t):
        return "median %.6f s (min %.6f, max %.6f)" % t

    for read_len in (100, 150):
        for batch in (BATCH, 8 * BATCH):
            t = kt.dp_timings(batch, read_len)
            log("phase 2 dp scan %d bp batch %d: %s = %.0f reads/s [%s]"
                % (read_len, batch, fmt(t), batch / t[0], card))
    for batch in (BATCH, 8 * BATCH):
        t = kt.insert_timings(batch, 128)
        log("phase 2 insert counts scan W=128 batch %d: %s = %.0f pairs/s"
            " [%s]" % (batch, fmt(t), batch / t[0], card))
    for label, t in kt.decode_timings(BATCH, 128).items():
        log("phase 2 decode %s [%d x 128]: %s [%s]" % (
            label, BATCH, fmt(t), card))


# -- phase 3: CLI trims --------------------------------------------------------


def _records(path, limit=None):
    """The first ``limit`` FASTQ records of a file, as bytes."""
    lines = []
    with open(path, "rb") as handle:
        for idx, line in enumerate(handle):
            if limit is not None and idx >= 4 * limit:
                break
            lines.append(line)
    return b"".join(lines)


def _trim(argv, env=None):
    from atropos_tpu.commands import execute_cli

    saved = {key: os.environ.get(key) for key in (env or {})}
    os.environ.update(env or {})
    try:
        t0 = time.perf_counter()
        rc = execute_cli(list(argv) + [
            "--no-default-adapters", "--no-cache-adapters", "--quiet",
        ])
        seconds = time.perf_counter() - t0
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    assert rc == 0, "trim %s failed (rc=%r)" % (argv, rc)
    return seconds


def _prefix_file(src, dst, count):
    with open(dst, "wb") as handle:
        handle.write(_records(src, count))


def write_inputs(tmp, se_count, pe_count):
    """Seeded SE and PE inputs plus their PREFIX-record prefixes."""
    paths = {}
    seqs, quals = se_reads(se_count, 100, seed=11)
    paths["se"] = os.path.join(tmp, "se.fq")
    write_fastq(paths["se"], seqs, quals, b"r")
    (r1, q1), (r2, q2) = pe_reads(pe_count, 125, seed=12)
    paths["pe1"] = os.path.join(tmp, "pe.1.fq")
    paths["pe2"] = os.path.join(tmp, "pe.2.fq")
    write_fastq(paths["pe1"], r1, q1, b"p")
    write_fastq(paths["pe2"], r2, q2, b"p")
    for key in ("se", "pe1", "pe2"):
        _prefix_file(paths[key], _head(paths[key]), PREFIX)
    return paths


def _head(path):
    """The prefix file beside ``path`` (``x.fq`` -> ``x.head.fq``)."""
    return path[: -len(".fq")] + ".head.fq"


def trim_runs(paths, tmp):
    """(label, argv builder, mode, unit) of the four phase-3 runs; the
    builder maps (whole input?, output tag) to (argv, output paths)."""
    def pick(key, whole):
        return paths[key] if whole else _head(paths[key])

    def se(extra):
        def build(whole, tag):
            out = os.path.join(tmp, "%s.%s.fq" % (tag, extra[0]))
            argv = ["trim", "-se", pick("se", whole), "-o", out] + extra[1:]
            return argv, [out]
        return build

    def pe(aligner):
        def build(whole, tag):
            o1 = os.path.join(tmp, "%s.%s.1.fq" % (tag, aligner))
            o2 = os.path.join(tmp, "%s.%s.2.fq" % (tag, aligner))
            return [
                "trim", "-pe1", pick("pe1", whole), "-pe2", pick("pe2", whole),
                "-a", TRUSEQ, "-A", TRUSEQ_R2, "--aligner", aligner,
                "-o", o1, "-p", o2,
            ], [o1, o2]
        return build

    return [
        ("se-adapter", se(["adapter", "-a", TRUSEQ]), "se", "reads"),
        ("pe-adapter", pe("adapter"), "pe", "pairs"),
        ("pe-insert", pe("insert"), "pe", "pairs"),
        ("se-quality", se(["quality", "-q", "20"]), "se", "reads"),
    ]


def phase_cli(card, tmp, se_count=SE_READS, pe_count=PE_PAIRS):
    paths = write_inputs(tmp, se_count, pe_count)
    for label, build, mode, unit in trim_runs(paths, tmp):
        count = se_count if mode == "se" else pe_count
        # the prefix run compiles every batch shape the full run uses
        argv, _ = build(False, "warm")
        _trim(argv)
        argv, outs = build(True, "full")
        report = outs[0] + ".json"
        seconds = _trim(argv + ["--report-file", report,
                                "--report-formats", "json"])
        with open(report) as handle:
            ran = json.load(handle)["mode"]
        assert ran == "turbo", "%s: ran on the %s tier" % (label, ran)
        argv, refs = build(False, "scalar")
        _trim(argv, env={"ATROPOS_TPU_ENGINE": "0"})
        for out, ref in zip(outs, refs):
            want = _records(ref)
            got = _records(out, PREFIX)
            assert want and got == want, "%s: %s differs from scalar" % (
                label, os.path.basename(out))
        log("phase 3 trim %s: turbo, first %d records == scalar; single run"
            " %d %s in %.3f s = %.0f %s/s [%s]" % (
                label, PREFIX, count, unit, seconds, count / seconds, unit,
                card))
    return paths


# -- phase 4: qc and detect ----------------------------------------------------


def _stable_report(path):
    with open(path) as handle:
        return [line for line in handle if not _VOLATILE.search(line)]


def phase_other(tmp, count=OTHER_READS, khmer_count=PREFIX):
    """``qc`` and ``detect -d known`` on ``count`` reads, and ``detect -d
    khmer`` (the device k-mer sort) on ``khmer_count`` reads — its host
    side unpacks every distinct k-mer in Python, minutes at 200,000
    random reads — each with the device path on, then off."""
    from atropos_tpu.commands import execute_cli
    from atropos_tpu.commands import stats as stats_mod
    from atropos_tpu.commands.detect import kmers

    seqs, quals = se_reads(count, 100, seed=21)
    path = os.path.join(tmp, "other.fq")
    write_fastq(path, seqs, quals, b"q")
    _prefix_file(path, _head(path), khmer_count)
    detect = ["detect", "--no-default-contaminants", "--no-cache-contaminants"]
    commands = [
        ("qc", ["qc", "-se", path], count, "ATROPOS_TPU_DEVICE_STATS",
         stats_mod.DEVICE_STATS_COUNTS, "batches"),
        ("detect-known", detect + [
            "-se", path, "-d", "known", "--max-reads", str(count),
            "-x", "TruSeq=" + TRUSEQ,
        ], count, "ATROPOS_TPU_DEVICE_KMERS", kmers.DEVICE_KMER_COUNTS,
         "intersect_batches"),
        ("detect-khmer", detect + [
            "-se", _head(path), "-d", "khmer", "--max-reads", str(khmer_count),
        ], khmer_count, "ATROPOS_TPU_DEVICE_KMERS", kmers.DEVICE_KMER_COUNTS,
         "batches"),
    ]
    for name, argv, reads, switch, counter, key in commands:
        reports = {}
        for mode in ("1", "0"):
            out = os.path.join(tmp, "%s.%s.txt" % (name, mode))
            before = counter[key]
            os.environ[switch] = mode
            try:
                t0 = time.perf_counter()
                rc = execute_cli(argv + ["-o", out, "--quiet"])
                seconds = time.perf_counter() - t0
            finally:
                os.environ.pop(switch)
            assert rc == 0, "%s failed (rc=%r)" % (name, rc)
            ran = counter[key] > before
            assert ran == (mode == "1"), "%s: device path %s" % (
                name, "did not run" if mode == "1" else "ran when off")
            reports[mode] = _stable_report(out)
            log("phase 4 %s device=%s: %.3f s" % (name, mode, seconds))
        assert reports["1"] == reports["0"], name + ": device != host report"
        log("phase 4 %s: device and host reports identical (%d reads)" % (
            name, reads))


# -- four cards ----------------------------------------------------------------


def phase_four(tmp, se_count=SE_READS, pe_count=PE_PAIRS):
    from atropos_tpu import parallel

    paths = write_inputs(tmp, se_count, pe_count)
    runs = [r for r in trim_runs(paths, tmp) if r[0] in ("se-adapter", "pe-insert")]
    for label, build, _, _ in runs:
        outputs = {}
        for shard in ("0", "1"):
            os.environ["ATROPOS_TPU_SHARD"] = shard
            parallel.reset_data_parallel_mesh()
            before = dict(parallel.SHARD_COUNTS)
            try:
                argv, outs = build(True, "shard%s" % shard)
                seconds = _trim(argv)
            finally:
                os.environ.pop("ATROPOS_TPU_SHARD")
                parallel.reset_data_parallel_mesh()
            if shard == "1":
                for key in ("sharded_calls", "psum_counter_checks"):
                    assert parallel.SHARD_COUNTS[key] > before[key], (
                        "%s: %s did not rise" % (label, key))
            outputs[shard] = [_records(out) for out in outs]
            log("four %s shard=%s: %.3f s (single run, compile included)" % (
                label, shard, seconds))
        assert outputs["0"] == outputs["1"], label + ": sharded != one card"
        log("four %s: output over 4 cards == single card" % label)


def main(argv):
    four = "--four" in argv
    jax, devices = start_jax()
    cards = card_lines()
    for line in cards:
        log("card: %s" % line)
    card = cards[0]
    from atropos_tpu import runtime

    assert runtime.available(), "native runtime did not build"
    with tempfile.TemporaryDirectory() as tmp:
        if four:
            assert len(devices) == 4, "--four needs 4 GPUs, found %d" % len(
                devices)
            phase_four(tmp)
        else:
            phase_parity()
            phase_timings(card)
            phase_cli(card, tmp)
            phase_other(tmp)
    log(json.dumps(dict(
        ok=True,
        device=dict(
            platform=devices[0].platform,
            kind=devices[0].device_kind,
            count=len(devices),
        ),
    )))


if __name__ == "__main__":
    main(sys.argv[1:])
