"""Golden-file conformance of the batched device engine.

Runs representative upstream golden cases with the engine forced on
(``ATROPOS_TPU_ENGINE=1``); outputs must remain byte-identical, proving
the device path is a drop-in replacement for scalar matching.
"""
import pytest

from .conformance_utils import run_trim
from .test_trim_pe import run_paired

ENGINE_SE_CASES = [
    ("-b TTAGACATATCTCCGTCG", "small.fastq", "small.fastq"),
    ("-e 0.12 -b TTAGACATATCTCCGTCG", "dos.fastq", "dos.fastq"),
    ("-N -b ADAPTER", "example.fa", "example.fa"),
    ("--front ADAPTER -N", "examplefront.fa", "example.fa"),
    ("-g ^FRONTADAPT -N", "anchored.fasta", "anchored.fasta"),
    ("-a BACKADAPTER$ -N", "anchored-back.fasta", "anchored-back.fasta"),
    (
        "-a BACKADAPTER$ -N --no-indels",
        "anchored-back.fasta",
        "anchored-back.fasta",
    ),
    ("-g ^TTAGACATAT --no-indels -e 0.1",
     "anchored_no_indels.fasta", "anchored_no_indels.fasta"),
    ("-a TTAGACATAT -g GAGATTGCCA --no-indels",
     "no_indels.fasta", "no_indels.fasta"),
    ("-a VCCGAMCYUCKHRKDCUBBCNUWNSGHCGU", "illumina.fastq", "illumina.fastq.gz"),
    ("--match-read-wildcards -b ACGTACGT", "wildcard.fa", "wildcard.fa"),
    ("-a AATTTCAGGAATT -a GTTCTCTAGTTCT",
     "twoadapters.fasta", "twoadapters.fasta"),
    ("-m 24 -O 10 -a AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA",
     "polya.fasta", "polya.fasta"),
    ("-b CAAG -n 3 --mask-adapter",
     "anywhere_repeat.fastq", "anywhere_repeat.fastq"),
    ("-q 10 -a XXXXXX", "lowqual.fastq", "lowqual.fastq"),
    ("-n 3 -e 0.1 --length-tag length= "
     "-b TGAGACACGCAACAGGGGAAAGGCAAGGCACACAGGGGATAGG "
     "-b TCCATCTCATCCCTGCGTGTCCCATCTGTTCCCTCCCTGTCTCA",
     "454.fa", "454.fa"),
]


@pytest.mark.parametrize("params,expected,inpath", ENGINE_SE_CASES)
def test_engine_se(tmp_path, monkeypatch, params, expected, inpath):
    monkeypatch.setenv("ATROPOS_TPU_ENGINE", "1")
    run_trim(tmp_path, params, expected, inpath)


def test_engine_pe(tmp_path, monkeypatch):
    monkeypatch.setenv("ATROPOS_TPU_ENGINE", "1")
    run_paired(
        "-a TTAGACATAT -A CAGTGGAGTA -m 14",
        in1="paired.1.fastq",
        in2="paired.2.fastq",
        expected1="paired_{aligner}.1.fastq",
        expected2="paired_{aligner}.2.fastq",
        tmp_path=tmp_path,
        aligners=("adapter",),
    )


def test_engine_pe_insert(tmp_path, monkeypatch):
    """Insert-aligner mode with the batched MultiAligner kernel."""
    monkeypatch.setenv("ATROPOS_TPU_ENGINE", "1")
    run_paired(
        "-a TTAGACATAT -A CAGTGGAGTA -m 14",
        in1="paired.1.fastq",
        in2="paired.2.fastq",
        expected1="paired_{aligner}.1.fastq",
        expected2="paired_{aligner}.2.fastq",
        tmp_path=tmp_path,
        aligners=("insert",),
    )


def test_engine_pe_insert_no_match(tmp_path, monkeypatch):
    monkeypatch.setenv("ATROPOS_TPU_ENGINE", "1")
    run_paired(
        "-a AGATCGGAAGAGCACACGTCTGAACTCCAGTCACCAGATCATCTCGTATGCCGTCTTCTGCTTG "
        "-A AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGTAGATCTCGGTGGTCGCCGTATCATT "
        "-e 0.3 --adapter-max-rmp 0.001 -m 25 -q 0 --trim-n",
        in1="insert.1.fastq",
        in2="insert.2.fastq",
        expected1="insert.1.fastq",
        expected2="insert.2.fastq",
        tmp_path=tmp_path,
        aligners=("insert",),
    )


def test_engine_pe_insert_filterboth(tmp_path, monkeypatch):
    monkeypatch.setenv("ATROPOS_TPU_ENGINE", "1")
    run_paired(
        "-a TTAGACATAT -A CAGTGGAGTA -m 14 --pair-filter both",
        in1="paired.1.fastq",
        in2="paired.2.fastq",
        expected1="paired-filterboth_{aligner}.1.fastq",
        expected2="paired-filterboth_{aligner}.2.fastq",
        tmp_path=tmp_path,
        aligners=("insert",),
    )


def test_engine_pe_legacy(tmp_path, monkeypatch):
    monkeypatch.setenv("ATROPOS_TPU_ENGINE", "1")
    run_paired(
        "-a TTAGACATAT -m 14",
        in1="paired.1.fastq",
        in2="paired.2.fastq",
        expected1="paired.m14.1.fastq",
        expected2="paired.m14.2.fastq",
        tmp_path=tmp_path,
    )


def test_engine_big_matches_scalar(tmp_path, monkeypatch):
    """Engine output on a 100-pair file must equal the scalar output."""
    from .conformance_utils import datapath
    from atropos_tpu.commands import get_command

    adapter_args = [
        "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCACACAGTGATCTCGTATGCCGTCTTCTGCTTG",
        "-A", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGTAGATCTCGGTGGTCGCCGTATCATT",
    ]
    common = [
        "-pe1", datapath("big.1.fq"), "-pe2", datapath("big.2.fq"),
        "--no-cache-adapters", "--no-default-adapters", "--quiet",
        "--report-file", str(tmp_path / "r.txt"),
    ]
    command = get_command("trim")

    monkeypatch.setenv("ATROPOS_TPU_ENGINE", "0")
    s1, s2 = str(tmp_path / "s1.fq"), str(tmp_path / "s2.fq")
    assert command.execute(adapter_args + ["-o", s1, "-p", s2] + common)[0] == 0

    monkeypatch.setenv("ATROPOS_TPU_ENGINE", "1")
    e1, e2 = str(tmp_path / "e1.fq"), str(tmp_path / "e2.fq")
    assert command.execute(adapter_args + ["-o", e1, "-p", e2] + common)[0] == 0

    for scalar_path, engine_path in ((s1, e1), (s2, e2)):
        with open(scalar_path) as fh:
            scalar_data = fh.read()
        with open(engine_path) as fh:
            engine_data = fh.read()
        assert scalar_data == engine_data


def test_linked_and_times_run_batched(tmp_path, monkeypatch):
    """Linked adapters and --times rounds must go through the batched
    matcher, not per-read scalar match_to: the engine's MATCH_COUNTS
    telemetry proves which path ran."""
    import os

    from atropos_tpu import engine as engine_mod
    from atropos_tpu.commands import get_command

    from .conformance_utils import cutpath, datapath, assert_files_equal

    monkeypatch.setenv("ATROPOS_TPU_ENGINE", "1")

    def run(params, inpath, expected):
        out = str(tmp_path / expected)
        argv = list(params) + [
            "-se", datapath(inpath), "-o", out,
            "--no-cache-adapters", "--no-default-adapters",
            "--report-file", str(tmp_path / "r.txt"), "--quiet",
        ]
        before = dict(engine_mod.MATCH_COUNTS)
        retcode, summary = get_command("trim").execute(argv)
        assert retcode == 0
        assert_files_equal(cutpath(expected), out)
        after = engine_mod.MATCH_COUNTS
        return (
            after["batched"] - before["batched"],
            after["scalar_reads"] - before["scalar_reads"],
        )

    # linked adapter (upstream golden): front+back passes batched
    batched, scalar = run(
        ["-a", "AAAAAAAAAA...TTTTTTTTTT"], "linked.fasta", "linked.fasta"
    )
    assert batched > 0 and scalar == 0

    # --times 3 (upstream golden): every round batched
    batched, scalar = run(
        "-b CAAG -n 3 --mask-adapter".split(), "anywhere_repeat.fastq",
        "anywhere_repeat.fastq",
    )
    assert batched > 0 and scalar == 0
