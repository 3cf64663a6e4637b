"""Differential parity tests: the XLA column scan (``BatchAligner``) vs
the scalar oracle, on the cases that stress the insertion window's edges,
wildcards and literal ``N`` bytes; and the insert matcher's diagonal
counts vs a host count."""
import random

import numpy as np
import pytest

from atropos_tpu.align import oracle
from atropos_tpu.align.batched import BatchAligner, encode_reads
from .test_batched_align import FLAG_CASES, PREFIX, SUFFIX, _random_read


def _make_scan(aligner_args):
    args = dict(aligner_args)
    return BatchAligner(
        args.pop("reference"), args.pop("max_error_rate"), args.pop("flags"),
        **args
    )


def _assert_parity(aligner_args, reads, label):
    scalar = oracle.Aligner(**aligner_args)
    arr, lengths = encode_reads(reads)
    out = _make_scan(aligner_args).locate_batch(arr, lengths)
    out = {key: np.asarray(val) for key, val in out.items()}
    for idx, read in enumerate(reads):
        expected = scalar.locate(read)
        got = (
            tuple(
                int(out[key][idx])
                for key in ("start1", "stop1", "start2", "stop2", "matches", "cost")
            )
            if out["found"][idx]
            else None
        )
        assert got == expected, "{}: read {} ({!r}): {} != {}".format(
            label, idx, read, got, expected
        )


@pytest.mark.parametrize("name,flags", FLAG_CASES)
@pytest.mark.parametrize("indel_cost", [1, 100000])
def test_pallas_parity(name, flags, indel_cost):
    rng = random.Random(hash((name, indel_cost, "pallas")) & 0xFFFF)
    adapter = "TTAGACATATCTCCGTCG"
    reads = [_random_read(rng, adapter, flags) for _ in range(50)]
    reads += ["", "A", adapter, adapter * 2, adapter[:4]]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=0.1,
            flags=flags,
            min_overlap=3,
            indel_cost=indel_cost,
        ),
        reads,
        "scan/{}/ic{}".format(name, indel_cost),
    )


@pytest.mark.parametrize("name,flags", FLAG_CASES[:2])
def test_pallas_parity_wildcards(name, flags):
    rng = random.Random(hash((name, "wc")) & 0xFFFF)
    adapter = "ACGTNNNACGTRYK"
    reads = [_random_read(rng, "ACGTACGACGTAGA", flags) for _ in range(30)]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=0.1,
            flags=flags,
            wildcard_ref=True,
            min_overlap=3,
        ),
        reads,
        "scan-wc/" + name,
    )


@pytest.mark.parametrize("max_error_rate", [0.0, 0.049, 0.2, 0.34])
@pytest.mark.parametrize("indel_cost", [1, 2, 3])
def test_pallas_scan_window_edges(max_error_rate, indel_cost):
    """Pin bit-exactness where insertion chains reach the error band's
    edge: reads whose adapter hit carries insertion runs of exactly k,
    k+1 and 2k bases (chains at and just past distance floor(k/ins_cost),
    beyond which no chain can stay within k)."""
    adapter = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"  # m=33 -> k up to 11
    k = int(max_error_rate * len(adapter))
    rng = random.Random(hash((max_error_rate, indel_cost)) & 0xFFFF)
    reads = []
    for run in {max(1, k), k + 1, 2 * k + 1}:
        for cut in (8, 16, len(adapter)):
            frag = adapter[:cut]
            pos = rng.randint(2, max(3, cut - 2))
            ins = "".join(rng.choice("ACGT") for _ in range(run))
            prefix = "".join(rng.choice("ACGT") for _ in range(20))
            reads.append(prefix + frag[:pos] + ins + frag[pos:])
    reads += [_random_read(rng, adapter, FLAG_CASES[0][1]) for _ in range(30)]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=max_error_rate,
            flags=FLAG_CASES[0][1],
            min_overlap=3,
            indel_cost=indel_cost,
        ),
        reads,
        "scan-window/e{}/ic{}".format(max_error_rate, indel_cost),
    )


def test_pallas_literal_n():
    """ASCII mode must treat 'N'=='N' as a match (exact byte compare)."""
    _assert_parity(
        dict(
            reference="NNNNNN",
            max_error_rate=0.2,
            flags=FLAG_CASES[0][1],
            min_overlap=3,
        ),
        ["ACGTNNNNNNACGT", "NNNNNN", "ACGTACGT"],
        "scan-literalN",
    )


@pytest.mark.gpu
@pytest.mark.parametrize("read_len", [100, 150])
def test_card_scan_matches_oracle(read_len):
    """On the card: the XLA scan compiled for the GPU, run on a full turbo
    batch of planted-adapter reads, equals the oracle on a sample."""
    flags = FLAG_CASES[0][1]
    adapter = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    rng = random.Random(read_len)
    reads = [
        _random_read(rng, adapter, flags, min_len=read_len // 2,
                     max_len=read_len)
        for _ in range(32768)
    ]
    args = dict(reference=adapter, max_error_rate=0.1, flags=flags,
                min_overlap=3)
    arr, lengths = encode_reads(reads)
    out = _make_scan(args).locate_batch(arr, lengths)
    assert np.asarray(out["found"]).shape == (32768,)
    _assert_parity(args, reads[:512], "card/%d" % read_len)


@pytest.mark.parametrize("W", [33, 64, 100, 255])
def test_packed_insert_counts_match_xla(W):
    """The insert matcher's diagonal counts (the XLA scan) must equal the
    host count exactly, across widths incl. non-multiples of 8, varied
    alphabets and lengths from 0 to W."""
    import jax.numpy as jnp

    from atropos_tpu.align.batched import _diagonal_match_counts
    from atropos_tpu.engine.turbo import _InsertPair

    rng = np.random.default_rng(W)
    B = 256
    alphabet = np.frombuffer(b"ACGTNacgtn", np.uint8)
    refs = alphabet[rng.integers(0, len(alphabet), size=(W, B))]
    queries = alphabet[rng.integers(0, len(alphabet), size=(W, B))]
    queries[:, :32] = refs[:, :32]
    lengths = rng.integers(0, W + 1, size=(1, B)).astype(np.int32)

    got = np.asarray(
        _diagonal_match_counts(
            jnp.asarray(refs.astype(np.int32)),
            jnp.asarray(queries.astype(np.int32)),
            jnp.asarray(lengths),
        )
    )
    want = _InsertPair._host_counts(refs.T, queries.T, lengths[0])
    assert np.array_equal(got, want)
