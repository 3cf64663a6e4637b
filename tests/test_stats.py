"""Read-statistics regression and batch-path tests.

The JSON golden (``tests/data_stats_golden.json``) was captured from the
dict-based accumulator whose schema matches the reference
(``atropos/commands/stats.py``); the tensor-backed implementation must
reproduce it exactly, via both the per-record and the batched collection
paths.
"""
import json
import os

import pytest

from atropos_tpu.commands.base import Summary
from atropos_tpu.commands.stats import SingleEndReadStatistics

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data_stats_golden.json")

CASES = [
    ("nextseq_tiles", "nextseq.fastq", True),
    ("illumina5", "illumina5.fastq", False),
    ("small", "small.fastq", False),
]


def _collect(path, tiles, batched):
    from atropos_tpu.io.seqio import open_reader

    stats = SingleEndReadStatistics(qualities=True, tiles=tiles or None)
    records = list(
        open_reader(file1=path, file_format="fastq", quality_base=33)
    )
    if batched:
        stats.collect_batch(records)
    else:
        for record in records:
            stats.collect(record)
    summary = Summary()
    summary["stats"] = stats.summarize()
    summary.finish()
    return json.loads(json.dumps(summary["stats"], default=str))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name,fastq,tiles", CASES)
def test_stats_match_golden(name, fastq, tiles, batched):
    from .conformance_utils import datapath

    with open(GOLDEN_PATH) as fh:
        golden = json.load(fh)
    actual = _collect(datapath(fastq), tiles, batched)
    assert actual == golden[name]


def test_stats_merge_associative():
    """Splitting the input across two accumulators and merging the live
    (pre-collapse) structures must equal one-shot collection for every
    count table — the multiprocess-worker merge path. (The lengths/gc
    'summary' statistics are pre-collapsed at summarize() time by design,
    matching the reference schema, so only their hist parts merge.)"""
    from .conformance_utils import datapath
    from atropos_tpu.io.seqio import open_reader
    from atropos_tpu.util import merge_values

    records = list(
        open_reader(
            file1=datapath("small.fastq"), file_format="fastq", quality_base=33
        )
    )
    whole = SingleEndReadStatistics(qualities=True)
    for record in records:
        whole.collect(record)

    part1 = SingleEndReadStatistics(qualities=True)
    part2 = SingleEndReadStatistics(qualities=True)
    for record in records[:1]:
        part1.collect(record)
    for record in records[1:]:
        part2.collect(record)

    merged_summary = merge_values(part1.summarize(), part2.summarize())
    whole_summary = whole.summarize()

    def collapse(tree):
        summary = Summary()
        summary["stats"] = tree
        summary.finish()
        data = json.loads(json.dumps(summary["stats"], default=str))
        # drop the pre-collapsed aggregate stats (see docstring)
        for section in ("lengths", "gc"):
            data["read1"][section].pop("summary")
        return data

    assert collapse(merged_summary) == collapse(whole_summary)


def test_device_position_counts_matches_host(monkeypatch):
    """The int8 nibble-outer-product count kernel must agree exactly with
    the host bincount, with the batch sharded over the device mesh and
    the counts psum-reduced across it."""
    import os
    import random

    from atropos_tpu import parallel
    from atropos_tpu.commands import stats as stats_mod

    monkeypatch.setenv("ATROPOS_TPU_DEVICE_STATS", "1")
    monkeypatch.setenv("ATROPOS_TPU_SHARD", "1")
    parallel.reset_data_parallel_mesh()
    try:
        rng = random.Random(99)
        import numpy as np

        batch, width = 600, 37
        matrix = np.zeros((batch, width), np.uint8)
        lengths = np.zeros(batch, np.int32)
        for row in range(batch):
            n = rng.randrange(0, width + 1)
            lengths[row] = n
            for col in range(n):
                matrix[row, col] = rng.choice(b"ACGTNacgtn+#!")

        host = stats_mod.PositionByteCounts()
        monkeypatch.setenv("ATROPOS_TPU_DEVICE_STATS", "0")
        host.add_batch(matrix, lengths)

        device = stats_mod.PositionByteCounts()
        monkeypatch.setenv("ATROPOS_TPU_DEVICE_STATS", "1")
        before = stats_mod.DEVICE_STATS_COUNTS["batches"]
        device.add_batch(matrix, lengths)
        assert stats_mod.DEVICE_STATS_COUNTS["batches"] > before, (
            "device stats forced but the device path never ran"
        )
        assert np.array_equal(host.counts, device.counts)
    finally:
        parallel.reset_data_parallel_mesh()
