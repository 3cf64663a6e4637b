"""FastQC-style read statistics over fixed-shape count tensors.

Instead of the reference's per-read dict updates
(``atropos/commands/stats.py:112-311``), statistics accumulate into dense
numpy count matrices — ``[Lmax, 256]`` per-position byte composition for
bases and qualities, dense histogram vectors for length/GC/mean-quality —
which makes collection a handful of vectorized scatter-adds per batch,
merging a tensor add (the host image of the device ``psum``; see
``atropos_tpu.parallel``), and the report schema a pure rendering step.
Summaries render to the exact dict schema of the reference so reports are
unchanged.
"""
import functools
import re

import numpy as np

from atropos_tpu.align import backend
from atropos_tpu.util import (
    Histogram,
    Mergeable,
    NestedDict,
    Summarizable,
    ordered_dict,
)

DEFAULT_TILE_KEY_REGEXP = r"^(?:[^\:]+\:){4}([^\:]+)"
"""Tile id extractor for the standard Illumina read-name format."""

_ASCII = 256

#: telemetry: batches whose position-count accumulation ran on device
#: (tests assert the device path executed rather than silently degrading)
DEVICE_STATS_COUNTS = {"batches": 0}

#: batches below this size stay on the host (upload cost dominates)
_DEVICE_MIN_BATCH = 256


@functools.lru_cache(maxsize=None)
def _device_count_fn(width, sharded):
    """Jitted per-position byte-count kernel.

    This is the SURVEY §7.7 design as a matrix product: the byte splits
    into two 4-bit nibbles, each one-hot encoded as int8, and the
    [W, 256] count matrix is the batched outer product
    ``counts[w, hi, lo] = sum_b Hi[b, w, hi] * Lo[b, w, lo]`` — W small
    int8 products with exact int32 accumulation instead of a host
    scatter-add.
    Padding is masked through the Lo factor. When a device mesh is active
    the batch axis is sharded and the counts psum-reduce across it.
    """
    import jax
    import jax.numpy as jnp

    def counts_fn(seqs, lengths):
        idx = jnp.arange(width, dtype=jnp.int32)[None, :]
        valid = idx < lengths[:, None]
        nib = jnp.arange(16, dtype=jnp.uint8)
        hi = (jnp.right_shift(seqs, 4)[:, :, None] == nib).astype(jnp.int8)
        lo = (
            ((seqs & 15)[:, :, None] == nib) & valid[:, :, None]
        ).astype(jnp.int8)
        counts = jnp.einsum(
            "bwh,bwl->whl", hi, lo, preferred_element_type=jnp.int32
        )
        if sharded:
            from atropos_tpu.parallel import READS_AXIS

            counts = jax.lax.psum(counts, READS_AXIS)
        return counts

    if sharded:
        from jax.sharding import PartitionSpec as P

        from atropos_tpu.parallel import (
            READS_AXIS,
            _shard_map,
            data_parallel_mesh,
        )

        counts_fn = _shard_map(
            counts_fn,
            data_parallel_mesh(),
            in_specs=(P(READS_AXIS, None), P(READS_AXIS)),
            out_specs=P(None, None, None),
        )
    return jax.jit(counts_fn)


def _device_position_counts(matrix, lengths):
    """[W, 256] per-position byte counts computed on device (psum-reduced
    over the local mesh when one is active)."""
    import jax.numpy as jnp

    from atropos_tpu.parallel import data_parallel_mesh

    mesh = data_parallel_mesh()
    ndev = mesh.devices.size if mesh is not None else 1
    batch, width = matrix.shape
    pad = -batch % max(ndev, 1)
    if pad:
        matrix = np.pad(matrix, ((0, pad), (0, 0)))
        lengths = np.pad(lengths, (0, pad))
    fn = _device_count_fn(width, ndev > 1)
    counts = np.asarray(fn(jnp.asarray(matrix), jnp.asarray(lengths)))
    DEVICE_STATS_COUNTS["batches"] += 1
    return counts.reshape(width, 256).astype(np.int64)


def _grow_rows(matrix, rows):
    """Return ``matrix`` with at least ``rows`` rows (zero-padded)."""
    if matrix.shape[0] >= rows:
        return matrix
    grown = np.zeros((rows,) + matrix.shape[1:], dtype=matrix.dtype)
    grown[: matrix.shape[0]] = matrix
    return grown


def _encode_batch(records):
    """Pack record sequences/qualities into padded uint8 matrices."""
    count = len(records)
    lengths = np.fromiter(
        (len(record.sequence) for record in records), np.int32, count
    )
    width = int(lengths.max()) if count else 0
    seqs = np.zeros((count, width), np.uint8)
    quals = None
    for row, record in enumerate(records):
        seqs[row, : lengths[row]] = np.frombuffer(
            record.sequence.encode("ascii"), np.uint8
        )
    if records and records[0].qualities is not None:
        quals = np.zeros((count, width), np.uint8)
        for row, record in enumerate(records):
            quals[row, : lengths[row]] = np.frombuffer(
                record.qualities.encode("ascii"), np.uint8
            )
    return seqs, quals, lengths


class DenseHistogram(Mergeable, Summarizable):
    """Histogram over small non-negative integers, stored densely.

    Renders through :class:`~atropos_tpu.util.Histogram` so the summary
    schema (sorted hist + mean/stdev/median/modes) is unchanged.
    """

    def __init__(self, size=128):
        self.counts = np.zeros(size, np.int64)

    def add_value(self, value, inc=1):
        if value >= self.counts.shape[0]:
            self.counts = _grow_rows(self.counts, value + 1)
        self.counts[value] += inc

    def add_vector(self, values):
        top = int(values.max()) if values.size else 0
        if top >= self.counts.shape[0]:
            self.counts = _grow_rows(self.counts, top + 1)
        self.counts += np.bincount(values, minlength=self.counts.shape[0])

    def merge(self, other):
        if not isinstance(other, DenseHistogram):
            raise ValueError("cannot merge {}".format(type(other)))
        rows = max(self.counts.shape[0], other.counts.shape[0])
        self.counts = _grow_rows(self.counts, rows)
        self.counts[: other.counts.shape[0]] += other.counts
        return self

    def as_histogram(self):
        rendered = Histogram()
        for value in np.nonzero(self.counts)[0]:
            rendered[int(value)] = int(self.counts[value])
        return rendered

    def summarize(self):
        return self.as_histogram().summarize()


class PositionByteCounts(Mergeable, Summarizable):
    """``[positions, 256]`` count matrix: how often each byte (base char or
    quality char) occurs at each read position."""

    def __init__(self, is_qualities=False, quality_base=33):
        self.counts = np.zeros((0, _ASCII), np.int64)
        self.is_qualities = is_qualities
        self.quality_base = quality_base

    def add_record(self, data):
        """Count one read's byte vector (positions are unique, so fancy
        indexing cannot collide)."""
        n = data.shape[0]
        self.counts = _grow_rows(self.counts, n)
        self.counts[np.arange(n), data] += 1

    def add_batch(self, matrix, lengths):
        """Accumulate a padded ``[B, L]`` byte matrix, masking padding.

        Large batches on GPU backends count on device (int8 nibble
        outer products, psum-reduced over the mesh — see
        :func:`_device_count_fn`); small batches and CPU backends use a
        host bincount."""
        width = matrix.shape[1]
        self.counts = _grow_rows(self.counts, width)
        if matrix.shape[0] >= _DEVICE_MIN_BATCH and backend.use_device_stats():
            self.counts[:width] += _device_position_counts(matrix, lengths)
            return
        valid = np.arange(width)[None, :] < lengths[:, None]
        pos = np.broadcast_to(np.arange(width)[None, :], matrix.shape)
        flat = pos[valid] * _ASCII + matrix[valid]
        self.counts[:width] += np.bincount(
            flat, minlength=width * _ASCII
        ).reshape(width, _ASCII)

    def merge(self, other):
        if not isinstance(other, PositionByteCounts):
            raise ValueError("cannot merge {}".format(type(other)))
        rows = max(self.counts.shape[0], other.counts.shape[0])
        self.counts = _grow_rows(self.counts, rows)
        self.counts[: other.counts.shape[0]] += other.counts
        return self

    def observed_bytes(self):
        return np.nonzero(self.counts.any(axis=0))[0]

    def column_order(self):
        """(column labels, byte codes) in report order: qualities sort by
        character; bases render as A,C,G,T,<others>,N with A/C/G/T/N
        always present."""
        seen = self.observed_bytes()
        if self.is_qualities:
            keys = [int(code) for code in seen]
            return tuple(code - self.quality_base for code in keys), keys
        named = [chr(code) for code in seen]
        acgt = ["A", "C", "G", "T"]
        extras = sorted(set(named) - set(acgt + ["N"]))
        labels = acgt + extras + ["N"]
        return tuple(labels), [ord(ch) for ch in labels]

    def summarize(self):
        columns, codes = self.column_order()
        return dict(
            columns=columns,
            rows=ordered_dict(
                (pos + 1, tuple(int(c) for c in self.counts[pos, codes]))
                for pos in range(self.counts.shape[0])
            ),
        )


class TilePositionCounts(Mergeable, Summarizable):
    """Per-tile :class:`PositionByteCounts` (``--stats :tiles`` mode)."""

    def __init__(self, is_qualities=False, quality_base=33):
        self.tiles = {}
        self.is_qualities = is_qualities
        self.quality_base = quality_base

    def table_for(self, tile):
        table = self.tiles.get(tile)
        if table is None:
            table = PositionByteCounts(self.is_qualities, self.quality_base)
            self.tiles[tile] = table
        return table

    def merge(self, other):
        if not isinstance(other, TilePositionCounts):
            raise ValueError("cannot merge {}".format(type(other)))
        for tile, table in other.tiles.items():
            if tile in self.tiles:
                self.tiles[tile].merge(table)
            else:
                self.tiles[tile] = table
        return self

    def summarize(self):
        tiles = tuple(sorted(self.tiles))
        seen = set()
        for table in self.tiles.values():
            seen.update(int(code) for code in table.observed_bytes())
        codes = sorted(seen)
        if self.is_qualities:
            columns = tuple(code - self.quality_base for code in codes)
        else:
            columns = tuple(chr(code) for code in codes)
        positions = max(
            (table.counts.shape[0] for table in self.tiles.values()), default=0
        )

        def row(pos):
            cells = ordered_dict([])
            for tile in tiles:
                counts = self.tiles[tile].counts
                if pos < counts.shape[0]:
                    cells[tile] = tuple(int(c) for c in counts[pos, codes])
                else:
                    cells[tile] = tuple(0 for _ in codes)
            return cells

        return dict(
            columns=columns,
            columns2=tiles,
            rows=ordered_dict((pos + 1, row(pos)) for pos in range(positions)),
        )


class ReadStatistics:
    """Read-level and position-level statistics for one input source."""

    def __init__(self, qualities=None, quality_base=33, tiles=None):
        self.count = 0
        self.sequence_lengths = DenseHistogram()
        self.sequence_gc = DenseHistogram(101)
        self.bases = PositionByteCounts()

        self.qualities = qualities
        self.quality_base = quality_base
        self.tile_key_regexp = None
        self.sequence_qualities = None
        self.base_qualities = None
        self.tile_base_qualities = None
        self.tile_sequence_qualities = None

        if qualities:
            pattern = DEFAULT_TILE_KEY_REGEXP if tiles is True else tiles
            if isinstance(pattern, str):
                pattern = re.compile(pattern)
            self.tile_key_regexp = pattern
            self._init_qualities()

    def _init_qualities(self):
        self.sequence_qualities = Histogram()
        self.base_qualities = PositionByteCounts(
            is_qualities=True, quality_base=self.quality_base
        )
        if self.tile_key_regexp:
            self.tile_base_qualities = TilePositionCounts(
                is_qualities=True, quality_base=self.quality_base
            )
            self.tile_sequence_qualities = NestedDict()

    @property
    def track_tiles(self):
        return self.qualities and self.tile_key_regexp is not None

    def _tile_of(self, record):
        return self._tile_of_name(record.name)

    def _tile_of_name(self, name):
        found = self.tile_key_regexp.match(name)
        if not found:
            raise ValueError(
                "{} did not match {}".format(self.tile_key_regexp, name)
            )
        return found.group(1)

    # -- collection ----------------------------------------------------------

    def collect(self, read1, read2=None):
        raise NotImplementedError()

    def collect_record(self, record):
        if self.qualities is None and record.qualities:
            self.qualities = True
            self._init_qualities()

        seq = record.sequence
        seqlen = len(seq)
        self.count += 1
        self.sequence_lengths.add_value(seqlen)
        if seqlen == 0:
            return

        data = np.frombuffer(seq.encode("ascii"), np.uint8)
        gc = seq.count("C") + seq.count("G")
        self.sequence_gc.add_value(round(gc * 100 / seqlen))
        self.bases.add_record(data)

        if not self.qualities or record.qualities is None:
            return
        quals = np.frombuffer(record.qualities.encode("ascii"), np.uint8)
        mean_quality = round(
            (int(quals.sum()) - seqlen * self.quality_base) / seqlen
        )
        self.sequence_qualities[mean_quality] += 1
        self.base_qualities.add_record(quals)
        if self.track_tiles:
            tile = self._tile_of(record)
            self.tile_sequence_qualities[tile][mean_quality] += 1
            self.tile_base_qualities.table_for(tile).add_record(quals)

    def collect_batch(self, records):
        """Vectorized collection of a whole record batch."""
        if not records:
            return
        seqs, quals, lengths = _encode_batch(records)
        names = (
            [record.name for record in records] if self.track_tiles else None
        )
        self.collect_matrices(seqs, quals, lengths, names=names)

    def collect_matrices(self, seqs, quals, lengths, names=None):
        """Vectorized collection straight from padded uint8 matrices
        (``[B, W]`` sequences/qualities + a length vector) — the form the
        turbo driver and the batched engine already hold. Bytes beyond
        each read's length are ignored. ``names`` is only needed when
        per-tile statistics are tracked."""
        count = lengths.shape[0]
        if count == 0:
            return
        if self.qualities is None and quals is not None:
            self.qualities = True
            self._init_qualities()

        self.count += count
        self.sequence_lengths.add_vector(lengths)

        nonempty = lengths > 0
        if not nonempty.any():
            return
        # clip padded matrices to the longest read so position tables
        # never grow all-zero rows beyond the observed lengths
        width = int(lengths.max())
        if seqs.shape[1] > width:
            seqs = seqs[:, :width]
            if quals is not None:
                quals = quals[:, :width]
        else:
            width = seqs.shape[1]
        valid = np.arange(width)[None, :] < lengths[:, None]
        gc = (((seqs == ord("C")) | (seqs == ord("G"))) & valid).sum(axis=1)
        live = lengths[nonempty]
        gc_pct = np.rint(gc[nonempty] * 100 / live).astype(np.int64)
        self.sequence_gc.add_vector(gc_pct)
        self.bases.add_batch(seqs[nonempty], live)

        if not (self.qualities and quals is not None):
            return
        quals = quals[nonempty]
        sums = (quals * valid[nonempty]).sum(axis=1, dtype=np.int64)
        mean_quality = np.rint(
            (sums - live.astype(np.int64) * self.quality_base) / live
        ).astype(np.int64)
        for value in mean_quality:
            self.sequence_qualities[int(value)] += 1
        self.base_qualities.add_batch(quals, live)
        if self.track_tiles:
            if names is None:
                raise ValueError(
                    "per-tile statistics require record names"
                )
            kept = [n for n, keep in zip(names, nonempty) if keep]
            for row, name in enumerate(kept):
                tile = self._tile_of_name(name)
                self.tile_sequence_qualities[tile][int(mean_quality[row])] += 1
                self.tile_base_qualities.table_for(tile).add_record(
                    quals[row, : live[row]]
                )

    # -- rendering -----------------------------------------------------------

    def summarize(self):
        summary = dict(
            counts=self.count,
            lengths=self.sequence_lengths.summarize(),
            gc=self.sequence_gc.summarize(),
            bases=self.bases,
        )
        if self.sequence_qualities is not None:
            summary["qualities"] = self.sequence_qualities
        if self.base_qualities is not None:
            summary["base_qualities"] = self.base_qualities
        if self.track_tiles:
            summary["tile_base_qualities"] = self.tile_base_qualities
            summary["tile_sequence_qualities"] = self.tile_sequence_qualities
        return summary


class SingleEndReadStatistics(ReadStatistics):
    def collect(self, read1, read2=None):
        self.collect_record(read1)

    def collect_batch(self, records):
        super().collect_batch(
            [r[0] if isinstance(r, tuple) else r for r in records]
        )

    def summarize(self):
        return dict(read1=super().summarize())


class PairedEndReadStatistics:
    def __init__(self, **kwargs):
        self.read1 = ReadStatistics(**kwargs)
        self.read2 = ReadStatistics(**kwargs)

    def collect(self, read1, read2):
        self.read1.collect_record(read1)
        self.read2.collect_record(read2)

    def collect_batch(self, records):
        self.read1.collect_batch([pair[0] for pair in records])
        self.read2.collect_batch([pair[1] for pair in records])

    def summarize(self):
        return dict(read1=self.read1.summarize(), read2=self.read2.summarize())
