"""Differential parity tests: batched XLA kernels vs the scalar oracle.

Randomized reads/adapters across every adapter type (flag combination),
wildcard mode, and indel-cost regime; results must be identical per read.
This is the correctness gate for the device engine.
"""
import random

import numpy as np
import pytest

from atropos_tpu.align import oracle
from atropos_tpu.align.batched import (
    BatchAligner,
    encode_reads,
    nextseq_trim_batch,
    quality_trim_batch,
)
from atropos_tpu.align.flags import (
    SEMIGLOBAL,
    START_WITHIN_SEQ2,
    STOP_WITHIN_SEQ1,
    STOP_WITHIN_SEQ2,
    START_WITHIN_SEQ1,
)
from atropos_tpu.commands.trim.qualtrim import (
    nextseq_trim_index,
    quality_trim_index,
)

BACK = START_WITHIN_SEQ2 | STOP_WITHIN_SEQ2 | STOP_WITHIN_SEQ1
FRONT = START_WITHIN_SEQ2 | STOP_WITHIN_SEQ2 | START_WITHIN_SEQ1
PREFIX = STOP_WITHIN_SEQ2
SUFFIX = START_WITHIN_SEQ2

FLAG_CASES = [
    ("back", BACK),
    ("front", FRONT),
    ("prefix", PREFIX),
    ("suffix", SUFFIX),
    ("anywhere", SEMIGLOBAL),
]


def _random_read(rng, adapter, flags, min_len=5, max_len=120):
    """Read with a planted (mutated) adapter occurrence half the time."""
    n = rng.randint(min_len, max_len)
    bases = "ACGT"
    read = [rng.choice(bases) for _ in range(n)]
    if rng.random() < 0.6 and n > 8:
        # plant a mutated adapter fragment somewhere plausible
        frag = list(adapter)
        for _ in range(rng.randint(0, 2)):
            frag[rng.randrange(len(frag))] = rng.choice(bases)
        if rng.random() < 0.3 and len(frag) > 2:
            del frag[rng.randrange(len(frag))]  # indel
        frag = frag[: rng.randint(3, len(frag))]
        if flags in (PREFIX, FRONT):
            pos = 0
        elif flags in (SUFFIX, BACK):
            pos = max(0, n - len(frag))
        else:
            pos = rng.randrange(max(1, n - len(frag)))
        read[pos : pos + len(frag)] = frag
        read = read[:n]
    return "".join(read)


def _assert_parity(aligner_args, reads, label):
    scalar = oracle.Aligner(**aligner_args)
    batched = BatchAligner(
        aligner_args["reference"],
        aligner_args["max_error_rate"],
        aligner_args["flags"],
        wildcard_ref=aligner_args.get("wildcard_ref", False),
        wildcard_query=aligner_args.get("wildcard_query", False),
        min_overlap=aligner_args.get("min_overlap", 1),
        indel_cost=aligner_args.get("indel_cost", 1),
    )
    arr, lengths = encode_reads(reads)
    out = batched.locate_batch(arr, lengths)
    out = {key: np.asarray(val) for key, val in out.items()}
    for idx, read in enumerate(reads):
        expected = scalar.locate(read)
        if expected is None:
            assert not out["found"][idx], "{}: read {} ({}): batched found {} but scalar None".format(
                label, idx, read,
                tuple(int(out[k][idx]) for k in ("start1", "stop1", "start2", "stop2", "matches", "cost")),
            )
        else:
            got = tuple(
                int(out[key][idx])
                for key in ("start1", "stop1", "start2", "stop2", "matches", "cost")
            )
            assert out["found"][idx], "{}: read {} ({}): scalar {} but batched None".format(
                label, idx, read, expected
            )
            assert got == expected, "{}: read {} ({}): {} != {}".format(
                label, idx, read, got, expected
            )


@pytest.mark.parametrize("name,flags", FLAG_CASES)
@pytest.mark.parametrize("indel_cost", [1, 100000])
def test_parity_random(name, flags, indel_cost):
    rng = random.Random(hash((name, indel_cost)) & 0xFFFF)
    adapter = "TTAGACATATCTCCGTCG"
    reads = [
        _random_read(rng, adapter, flags) for _ in range(120)
    ]
    # include degenerate/edge reads
    reads += ["", "A", adapter, adapter * 2, "ACGT", adapter[:3], adapter[-3:]]
    reads = [r for r in reads if r]  # kernel requires length >= 1? no: keep empty out
    reads += [""]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=0.1,
            flags=flags,
            min_overlap=3,
            indel_cost=indel_cost,
        ),
        reads,
        "{}/ic{}".format(name, indel_cost),
    )


@pytest.mark.parametrize("name,flags", FLAG_CASES)
def test_parity_wildcards(name, flags):
    rng = random.Random(hash(name) & 0xFFFF)
    adapter = "ACGTNNNACGTRYK"
    reads = [_random_read(rng, "ACGTACGACGTAGA", flags) for _ in range(60)]
    reads += ["ACGTAAAACGTATG", "CCCACGTTTTACGTGTGCCC"]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=0.1,
            flags=flags,
            wildcard_ref=True,
            min_overlap=3,
        ),
        reads,
        "wc-ref/" + name,
    )
    # wildcards in the read
    reads_n = [
        read[:4] + "N" + read[5:] if len(read) > 6 else read for read in reads
    ]
    _assert_parity(
        dict(
            reference="ACGTACGACGTAGA",
            max_error_rate=0.1,
            flags=flags,
            wildcard_query=True,
            min_overlap=3,
        ),
        reads_n,
        "wc-query/" + name,
    )


@pytest.mark.parametrize("error_rate", [0.0, 0.1, 0.12, 0.15, 0.2, 0.3])
def test_parity_error_rates(error_rate):
    rng = random.Random(int(error_rate * 100))
    adapter = "AGATCGGAAGAGCACACGTCT"
    reads = [_random_read(rng, adapter, BACK) for _ in range(80)]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=error_rate,
            flags=BACK,
            min_overlap=3,
        ),
        reads,
        "er{}".format(error_rate),
    )


def test_parity_short_adapter_long_reads():
    rng = random.Random(99)
    adapter = "CAAG"
    reads = [_random_read(rng, adapter, BACK, min_len=10, max_len=300) for _ in range(40)]
    _assert_parity(
        dict(reference=adapter, max_error_rate=0.1, flags=BACK, min_overlap=1),
        reads,
        "short-adapter",
    )


def test_parity_min_overlap_variants():
    rng = random.Random(7)
    adapter = "TTAGACATAT"
    reads = [_random_read(rng, adapter, BACK) for _ in range(60)]
    for min_overlap in (1, 3, 10):
        _assert_parity(
            dict(
                reference=adapter,
                max_error_rate=0.1,
                flags=BACK,
                min_overlap=min_overlap,
            ),
            reads,
            "ov{}".format(min_overlap),
        )


def test_quality_trim_parity():
    rng = random.Random(4)
    quals = []
    for _ in range(200):
        n = rng.randint(1, 150)
        quals.append("".join(chr(33 + rng.randint(0, 41)) for _ in range(n)))
    arr, lengths = encode_reads(quals)
    for cf, cb in ((0, 10), (10, 10), (20, 20), (0, 0), (15, 3)):
        starts, stops = quality_trim_batch(arr, lengths, cf, cb)
        starts = np.asarray(starts)
        stops = np.asarray(stops)
        for idx, qual in enumerate(quals):
            exp_start, exp_stop = quality_trim_index(qual, cf, cb)
            assert (int(starts[idx]), int(stops[idx])) == (exp_start, exp_stop), (
                "cf={} cb={} qual={!r}: ({},{}) != ({},{})".format(
                    cf, cb, qual, int(starts[idx]), int(stops[idx]),
                    exp_start, exp_stop,
                )
            )


def test_nextseq_trim_parity():
    class _Rec:
        def __init__(self, sequence, qualities):
            self.sequence = sequence
            self.qualities = qualities

    rng = random.Random(5)
    seqs, quals = [], []
    for _ in range(200):
        n = rng.randint(1, 150)
        seqs.append("".join(rng.choice("ACGT") for _ in range(n)))
        quals.append("".join(chr(33 + rng.randint(0, 41)) for _ in range(n)))
    seq_arr, lengths = encode_reads(seqs)
    qual_arr, _ = encode_reads(quals, pad_to=seq_arr.shape[1])
    for cutoff in (10, 22, 30):
        stops = np.asarray(nextseq_trim_batch(seq_arr, qual_arr, lengths, cutoff))
        for idx in range(len(seqs)):
            expected = nextseq_trim_index(_Rec(seqs[idx], quals[idx]), cutoff)
            assert int(stops[idx]) == expected


def test_debug_dp_matrix_matches_oracle():
    """The batched kernel's debug DP-matrix path (SURVEY §5) must equal
    the scalar oracle's dpmatrix cell for cell — including which cells
    the Ukkonen band computed (None elsewhere)."""
    from atropos_tpu.align import oracle
    from atropos_tpu.align.batched import debug_dp_matrix
    from atropos_tpu.align.flags import (
        SEMIGLOBAL,
        START_WITHIN_SEQ2,
        STOP_WITHIN_SEQ1,
        STOP_WITHIN_SEQ2,
    )

    back = START_WITHIN_SEQ2 | STOP_WITHIN_SEQ2 | STOP_WITHIN_SEQ1
    cases = [
        ("ADAPTER", "THEADAPTERISHERE", back),
        ("ADAPTER", "THEADAPXERISHERE", back),
        ("ADAPTER", "NOMATCHATALLXXXX", back),
        ("TTAGACATAT", "GCTTAGACATATAGG", SEMIGLOBAL),
        ("TTAGACATAT", "GCTTAGACTATAGG", SEMIGLOBAL),
    ]
    for ref, query, flags in cases:
        scalar = oracle.Aligner(ref, 0.1, flags)
        scalar.enable_debug()
        scalar.locate(query)
        expected = scalar.dpmatrix._rows
        actual = debug_dp_matrix(ref, query, flags)
        assert actual == expected, (ref, query, flags)
