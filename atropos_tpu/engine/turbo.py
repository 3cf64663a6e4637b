"""Turbo trim path: zero-Python-object, latency-hiding streaming trim.

For interval-expressible single-end AND paired-end configurations
(fixed cuts + quality/NextSeq trimming + adapter trimming with either
aligner + conditional cuts/N-trimming + length/N filters, action=trim)
the entire per-read pipeline is *interval arithmetic*: each stage only
narrows a per-read keep-window [start, stop). The drivers stream
FASTQ/FASTA chunks through the native C parser
(:mod:`atropos_tpu.runtime`), run the batched device kernels, resolve
the final windows, and assemble output bytes with the native formatters
(separate, demultiplexed via ``{name}``, or interleaved) — no per-read
Python objects anywhere. Overlap error correction
(``--correct-mismatches``) rewrites the few affected records through an
alt-buffer path in the formatter; side files (info/rest/wildcard) emit
from stashed match data.

Layout:

- :class:`_MateLane` — one mate's stage configuration and device work
  (prepare/submit a batch, resolve its keep-windows + statistics, apply
  post-adapter stages).
- :class:`_InsertPair` — the paired insert-align stage: one fused
  device step for both mates (quality + fallback DP + the diagonal
  insert matcher), vectorized candidate selection/overhang checks/
  symmetric duplication/error correction on host.
- :class:`TurboTrimRunner` — the single-end driver: one lane, filters,
  per-destination routing.
- :class:`TurboPairedRunner` — the paired-end driver: two lanes fed by
  two synchronized chunk streams (or one interleaved stream paired by
  stride), vectorized pair filters (``any``/``both`` semantics of the
  reference's PairedWrapper, ``atropos/commands/trim/filters.py:66-90``).

The device interaction is fully pipelined (``DEPTH`` batches in flight):

- **submit**: one bit-packed upload per batch (2-4 bits/base; raw
  qualities only when a quality stage is configured); the quality/
  NextSeq kernels, per-adapter view decoding and every DP kernel run in
  ONE jitted step whose outputs concatenate into an int16 ``bundle``.
- **resolve**: a single ``np.asarray(bundle)`` fetch per batch, then all
  interval resolution, validation, statistics (vectorized bincounts) and
  the native formatter run on host while later batches compute on device.

This hides both kernel time and host-device round-trip latency: the host
parse/format work for batch i overlaps the device DP for batches
i+1..i+DEPTH. Only a 5'-quality cutoff forces a mid-batch synchronization
(the adapter stage must re-gather at a data-dependent window start).

Output is byte-identical to the scalar pipeline (asserted by the
differential tests and 115/132 of the engine-forced upstream golden
runs); all summary statistics (per-adapter histograms, trimmed-bp and
correction counters, filter counts) are accumulated into the same stat
objects the scalar pipeline uses, so reports are unchanged.
"""
import collections
import logging
import os

import numpy as np

from atropos_tpu.adapters import ANYWHERE, BACK, FRONT, PREFIX, SUFFIX, Adapter, ColorspaceAdapter
from atropos_tpu.commands.trim.filters import (
    NContentFilter,
    NoFilter,
    PairedWrapper,
    TooLongReadFilter,
    TooShortReadFilter,
    TrimmedFilter,
    UntrimmedFilter,
)
from atropos_tpu.commands.trim.modifiers import (
    AdapterCutter,
    InsertAdapterCutter,
    NextseqQualityTrimmer,
    QualityTrimmer,
    ReadPairModifier,
    UnconditionalCutter,
)
from atropos_tpu import runtime

_UPPER_LUT = None

#: telemetry: pairs whose insert-candidate stream exceeded the fixed
#: wire slots and took the host-recompute path (tests assert the
#: overflow machinery actually runs)
SLOT_OVERFLOWS = {"pairs": 0}


def _upper(arr):
    global _UPPER_LUT
    if _UPPER_LUT is None:
        lut = np.arange(256, dtype=np.uint8)
        lut[ord("a") : ord("z") + 1] = np.arange(
            ord("A"), ord("Z") + 1, dtype=np.uint8
        )
        _UPPER_LUT = lut
    return _UPPER_LUT[arr]


_COMP_LUT256 = None


def _complement_lut():
    """Byte-indexed IUPAC complement table (identity for bytes outside
    the map — util.complement semantics, byte for byte)."""
    global _COMP_LUT256
    if _COMP_LUT256 is None:
        from atropos_tpu.util import BASE_COMPLEMENTS

        lut = np.arange(256, dtype=np.uint8)
        for base, comp in BASE_COMPLEMENTS.items():
            lut[ord(base)] = ord(comp)
        _COMP_LUT256 = lut
    return _COMP_LUT256


def _device_complement(jnp, x):
    """IUPAC complement of an int32 byte matrix as a select chain over
    the map's ~30 non-identity entries (XLA fuses the chain into the
    consuming step; no table crosses to the device)."""
    lut = _complement_lut()
    out = x
    for byte in np.nonzero(lut != np.arange(256, dtype=np.uint8))[0]:
        out = jnp.where(x == int(byte), int(lut[byte]), out)
    return out


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _pack_info(chunk):
    """Bit-packed upload parameters for a chunk's sequences.

    Sequence bytes cross the host-device link packed: chunks whose
    sequence alphabet has <= 4 distinct byte values (plain ACGT data)
    pack 4 bases/byte, <= 16 values (ACGTN + lowercase) pack 2
    bases/byte. Returns (bits, code_lut,
    symbols) or None for raw upload (>16 distinct symbols, or disabled via
    ``ATROPOS_TPU_PACK=0``).
    """
    if os.environ.get("ATROPOS_TPU_PACK", "1") in ("0", "false", "no"):
        return None
    symbols = chunk.alphabet
    if symbols.size > 16:
        return None
    bits = 2 if symbols.size <= 4 else 4
    code_lut = np.zeros(256, np.uint8)
    code_lut[symbols] = np.arange(symbols.size, dtype=np.uint8)
    return bits, code_lut, symbols


class _Inflight:
    """One submitted batch: the device bundle plus the host context needed
    to resolve it (kept alive until resolution)."""

    __slots__ = (
        "bundle", "chunk", "sub", "batch", "width", "pad_b",
        "keep_start", "keep_stop", "n", "seqs", "host_q",
        "match_data", "win_start", "win_stop", "cut_start", "cut_stop",
        "alt", "qclip", "ow",
    )

    def __init__(self, **kw):
        self.match_data = None
        self.win_start = None
        self.win_stop = None
        self.cut_start = None
        self.cut_stop = None
        self.alt = None
        self.qclip = None
        self.ow = None
        for key, val in kw.items():
            setattr(self, key, val)


def _open_input(path):
    """Binary chunk stream over the input: plain file, or streaming
    decompression for gz/bz2/xz (system gzip subprocess when available,
    so decompression overlaps compute in its own process)."""
    from atropos_tpu.io.compression import get_file_opener

    opener = get_file_opener(path)
    if opener is not None:
        return opener(path, "rb")
    return open(path, "rb")


class _ChunkStream:
    """Incremental native-parsed FASTQ/FASTA chunk iterator over one
    file.

    Replicates the scalar readers' edge handling: tolerates a missing
    final newline, raises on malformed content with the reader's exact
    diagnostics, and carries partial records across chunk boundaries.
    """

    def __init__(self, path, chunk_bytes, fmt="fastq"):
        self._fh = _open_input(path)
        self._carry = b""
        self._eof = False
        self._chunk_bytes = chunk_bytes
        self._fmt = fmt
        self._lines_done = 0

    def next_chunk(self):
        """The next parsed chunk with >= 1 record, or None at end."""
        if self._fmt == "fasta":
            return self._next_fasta()
        while True:
            if self._eof and not self._carry:
                return None
            data = b"" if self._eof else self._fh.read(self._chunk_bytes)
            if not data:
                self._eof = True
            buf = self._carry + data
            if not buf:
                return None
            if self._eof and not buf.endswith(b"\n"):
                # tolerate a missing final newline (the scalar reader does)
                buf += b"\n"
            chunk = runtime.parse_chunk(buf)
            if chunk.n == 0 and self._eof:
                self._carry = b""
                if buf.strip():
                    raise RuntimeError("trailing garbage in FASTQ input")
                return None
            self._carry = buf[chunk.consumed :] if not self._eof else b""
            if chunk.n:
                return chunk

    def _next_fasta(self):
        from atropos_tpu.io.seqio import FormatError
        from atropos_tpu.util import truncate_string

        while True:
            if self._eof and not self._carry:
                return None
            data = b"" if self._eof else self._fh.read(self._chunk_bytes)
            if not data:
                self._eof = True
            buf = self._carry + data
            if not buf:
                return None
            try:
                chunk = runtime.parse_fasta_chunk(buf, final=self._eof)
            except runtime.FastaParseError as err:
                # FastaReader's diagnostic, byte for byte (absolute line
                # number tracked across chunks)
                offset = err.offset
                lineno = self._lines_done + buf[:offset].count(b"\n") + 1
                nl_pos = buf.find(b"\n", offset)
                line = buf[offset : nl_pos if nl_pos >= 0 else len(buf)]
                raise FormatError(
                    "At line {0}: Expected '>' at beginning of FASTA "
                    "record, but got {1!r}.".format(
                        lineno,
                        truncate_string(line.decode("latin-1").strip()),
                    )
                )
            if chunk.n == 0 and self._eof:
                self._carry = b""
                return None
            self._lines_done += buf[: chunk.consumed].count(b"\n")
            self._carry = buf[chunk.consumed :] if not self._eof else b""
            if chunk.n:
                return chunk

    def close(self):
        self._fh.close()


class _PrefetchStream:
    """Background read+parse for a _ChunkStream: a producer thread keeps
    up to ``depth`` parsed chunks ready, so the native parse (which
    releases the GIL) overlaps the main thread's gather/submit/resolve
    work. This is the host-side analog of the device pipeline window —
    the parse phase runs at ~6.7M reads/s/core (PERF.md host budget) and
    would otherwise serialize with everything else on the main thread."""

    def __init__(self, stream, depth=2):
        import queue
        import threading

        self._stream = stream
        self._q = queue.Queue(maxsize=max(1, depth))
        self._exc = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._closed:
                chunk = self._stream.next_chunk()
                self._q.put(chunk)
                if chunk is None:
                    return
        except BaseException as exc:
            if not self._closed:
                self._exc = exc
            self._q.put(None)

    def next_chunk(self):
        item = self._q.get()
        if item is None:
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            # keep yielding None for any further calls
            self._q.put(None)
        return item

    def close(self):
        import queue

        self._closed = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
        self._stream.close()


def _maybe_prefetch(stream):
    """Wrap a chunk stream with the parse-ahead thread unless disabled
    (``ATROPOS_TPU_PREFETCH=0``)."""
    depth = _env_int("ATROPOS_TPU_PREFETCH", 2)
    if depth <= 0:
        return stream
    return _PrefetchStream(stream, depth)


def _host_qualtrim_enabled():
    """Quality/NextSeq windows via the native host kernel (default) vs
    the device kernels (``ATROPOS_TPU_HOST_QUALTRIM=0``). The host
    kernel computes the same BWA partial-sum scans straight from the
    chunk buffer at native speed, which (a) removes the raw-quality
    upload — the single largest per-read transfer (~100 B vs 27 B for
    the packed sequence) — and (b) removes the 5'-cutoff mid-batch
    synchronization, restoring full pipelining for ``-q N,M`` configs.
    The device kernels remain for ``=0`` and are covered by the same
    differential tests."""
    value = os.environ.get("ATROPOS_TPU_HOST_QUALTRIM")
    if value is None:
        return True
    return value not in ("0", "false", "no")


class _MateLane:
    """One mate's stage configuration and device work.

    ``submit`` turns a (chunk, sub) record range into an in-flight device
    batch; ``resolve_windows`` fetches the bundle and produces the final
    per-read keep-windows plus matched flags, accumulating every modifier
    statistic exactly as the scalar pipeline would.
    """

    def __init__(self, *, cut_front, cut_back, quality, nextseq, cutter,
                 cutter_mod, insert_adapter=None, insert_role=None,
                 post_mods=()):
        self.cut_front = cut_front
        self.cut_back = cut_back
        self.quality = quality
        self.nextseq = nextseq
        self.cutter = cutter
        self.cutter_mod = cutter_mod
        self.insert_role = insert_role
        self.post_mods = list(post_mods)
        if cutter:
            self.adapters = cutter.adapters
        elif insert_adapter is not None:
            # insert mode: the mate's 3' adapter drives the FALLBACK
            # independent match (InsertAdapterCutter semantics); the pair
            # resolver decides whether/how its result applies
            self.adapters = [insert_adapter]
        else:
            self.adapters = []
        from atropos_tpu.engine import _PrefixSuffixMatcher, make_batch_aligner

        # anchored no-indel adapters match via the vectorized host
        # comparator (compare_prefixes semantics — O(B*m) byte ops, not
        # worth a device round trip); everything else gets a DP kernel.
        # self._aligners holds only the device aligners, in adapter
        # order; self._matchers maps adapter index -> host matcher.
        self._aligners = []
        self._matchers = {}
        for idx, adapter in enumerate(self.adapters):
            if not adapter.indels and adapter.where in (PREFIX, SUFFIX):
                self._matchers[idx] = _PrefixSuffixMatcher(adapter)
            else:
                self._aligners.append(make_batch_aligner(adapter))
        # host-side wildcard translation tables (None = raw ASCII compare)
        from atropos_tpu.align.batched import _translation_lut

        self._luts = []
        for idx, adapter in enumerate(self.adapters):
            if idx in self._matchers:
                continue
            if adapter.adapter_wildcards or adapter.read_wildcards:
                self._luts.append(
                    _translation_lut(
                        adapter.adapter_wildcards,
                        adapter.read_wildcards,
                        for_query=True,
                    )
                )
            else:
                self._luts.append(None)
        self._needs_quals = quality is not None or nextseq is not None
        self._sync_quality = quality is not None and quality.cutoff_front > 0
        self._asteps = {}
        self._sharded = False
        self._has_max_rmp = any(
            adapter.max_rmp is not None for adapter in self.adapters
        )
        # device views for bit-packed uploads: with <= 16 distinct input
        # symbols, per-adapter wildcard translation and uppercasing
        # collapse into small code->ASCII DECODE tables applied on device,
        # so no translated matrices ever cross the link. _aligner_view[i]
        # is the view index for device aligner i; the identity view feeds
        # the NextSeq kernel (it inspects real sequence bytes).
        self._view_luts = []

        def _add_view(lut256):
            for view_idx, existing in enumerate(self._view_luts):
                if np.array_equal(existing, lut256):
                    return view_idx
            self._view_luts.append(lut256)
            return len(self._view_luts) - 1

        self._identity_view = (
            _add_view(np.arange(256, dtype=np.uint8))
            if (nextseq is not None or insert_role == 1)
            else None
        )
        # insert mode: mate1 feeds the diagonal matcher its raw window
        # bytes (identity view); mate2 feeds COMPLEMENTED bytes — the
        # reverse-complement's complement step is just another decode
        # table, the reversal is a device gather in the pair step
        self._insert_view = None
        if insert_role == 1:
            self._insert_view = self._identity_view
        elif insert_role == 2:
            self._insert_view = _add_view(_complement_lut())
        upper_lut = _upper(np.arange(256, dtype=np.uint8))
        self._aligner_view = [
            _add_view(upper_lut if lut is None else lut[upper_lut])
            for lut in self._luts
        ]

    @classmethod
    def from_modifier_list(cls, mods, insert_adapter=None, insert_role=None):
        """Build a lane from one mate's ordered modifier list, or a
        decline-reason string when a stage is unsupported or out of the
        default C -> G -> Q -> A order. ``insert_adapter``/``insert_role``
        configure the lane as one mate of an insert-align pair."""
        from atropos_tpu.commands.trim.modifiers import (
            MinCutter,
            NEndTrimmer,
        )

        cut_front = cut_back = 0
        quality = None
        nextseq = None
        cutter = None
        cutter_mod = None
        post = []
        for mod in mods:
            if type(mod) in (MinCutter, NEndTrimmer):
                # post-adapter fixed stages, applied by apply_post
                post.append(mod)
            elif isinstance(mod, UnconditionalCutter):
                cut_front, cut_back = mod.front_length, mod.back_length
                cutter_mod = mod
            elif isinstance(mod, QualityTrimmer):
                quality = mod
            elif isinstance(mod, NextseqQualityTrimmer):
                nextseq = mod
            elif isinstance(mod, AdapterCutter):
                cutter = mod
            else:
                return "unsupported modifier %s" % type(mod).__name__
        order = [type(mod) for mod in mods]
        # presence is keyed on the modifier INSTANCE: a zero-length
        # UnconditionalCutter (e.g. the read2 slot when only -u was given)
        # is a legitimate no-op stage, not an order violation
        expected = [
            t
            for t, present in (
                (UnconditionalCutter, cutter_mod),
                (NextseqQualityTrimmer, nextseq),
                (QualityTrimmer, quality),
                (AdapterCutter, cutter),
            )
            if present is not None
        ] + [type(mod) for mod in post]
        if order != expected:
            return "non-default op order"
        for adapter in (cutter.adapters if cutter else []):
            if not isinstance(adapter, Adapter) or isinstance(
                adapter, ColorspaceAdapter
            ):
                return "non-plain adapter"
        if insert_adapter is not None and cutter is not None:
            return "adapter cutter alongside insert cutter"
        return cls(
            cut_front=cut_front,
            cut_back=cut_back,
            quality=quality,
            nextseq=nextseq,
            cutter=cutter,
            cutter_mod=cutter_mod,
            insert_adapter=insert_adapter,
            insert_role=insert_role,
            post_mods=post,
        )

    # -- device step builder --------------------------------------------------

    def res_rows(self, width):
        """Bundle rows per device-aligner result: 3 when every field
        fits the packed layout (coords <= 255, cost <= 63 when found),
        else the flat 7. Static per compiled step; the resolver derives
        the same predicate from (width, adapter params)."""
        if width > 255:
            return 7
        for idx, adapter in enumerate(self.adapters):
            if idx in self._matchers:
                continue
            m = len(adapter.sequence)
            if m > 255 or int(adapter.max_error_rate * m) > 63:
                return 7
        return 3

    @staticmethod
    def _pack_res_rows(jnp, out7):
        """[7, B] aligner result -> [3, B] packed rows (int16-safe):
        rowA = start1 | stop1<<8 (biased), rowB = start2 | stop2<<8
        (biased), rowC = found | matches<<1 | cost<<9 (<= 32767).
        Unfound lanes may carry out-of-field costs — clipped here; every
        consumer is gated on ``found``."""
        row_a = (out7[1] | (out7[2] << 8)) - 32768
        row_b = (out7[3] | (out7[4] << 8)) - 32768
        found = out7[0] & 1
        row_c = (
            found
            | (jnp.clip(out7[5], 0, 255) << 1)
            | (jnp.clip(out7[6], 0, 63) << 9)
        )
        return jnp.stack([row_a, row_b, row_c])

    @staticmethod
    def _unpack_res_rows(rows3):
        """Host inverse of :meth:`_pack_res_rows` -> result dict arrays."""
        row_a = rows3[0] + 32768
        row_b = rows3[1] + 32768
        row_c = rows3[2]
        return dict(
            found=(row_c & 1).astype(bool),
            start1=row_a & 0xFF,
            stop1=row_a >> 8,
            start2=row_b & 0xFF,
            stop2=row_b >> 8,
            matches=(row_c >> 1) & 0xFF,
            cost=row_c >> 9,
        )

    @staticmethod
    def _stats_rows(jax, jnp, rows, n_aligners, win_len):
        """Sharded-mode collective statistics: the per-shard match count
        and window-bp reduce across the mesh with psum — the device image
        of the reference's merge_dicts summary algebra. The resolver
        cross-checks them against the host-derived values. Values are
        split hi/lo so they survive the int16 bundle (lanes 0..3 of the
        extra row)."""
        from atropos_tpu.parallel import READS_AXIS

        found_any = jnp.zeros(win_len.shape, bool)
        for block in rows[:n_aligners]:
            if block.shape[0] == 3:  # packed result rows: found = bit 0
                found_any = found_any | ((block[2, :] & 1) > 0)
            else:
                found_any = found_any | (block[0, :] > 0)
        found_any = found_any & (win_len > 0)
        matched = jax.lax.psum(
            jnp.sum(found_any.astype(jnp.int32)), READS_AXIS
        )
        win_bp = jax.lax.psum(jnp.sum(jnp.maximum(win_len, 0)), READS_AXIS)
        vals = jnp.stack(
            [matched >> 15, matched & 32767, win_bp >> 15, win_bp & 32767]
        )
        stats_row = jnp.zeros((1, win_len.shape[0]), jnp.int32)
        return jnp.concatenate([vals[None, :], stats_row[:, 4:]], axis=1)

    @staticmethod
    def _finish_bundle(jnp, rows, win_len):
        """Concatenate bundle rows and narrow to int16 for the D2H fetch
        (every observable value fits: coordinates/matches are bounded by
        the batch width, costs by k when found — unfound costs may exceed
        the range but are never read)."""
        if not rows:
            rows = [win_len[None, :]]
        bundle = jnp.concatenate(rows, axis=0)
        return jnp.clip(bundle, -32768, 32767).astype(jnp.int16)

    def _aligner_rows(self, jnp, aligner, mat, win_len):
        """One adapter's 7 result rows from its DP kernel."""
        out = aligner.locate_device(mat, win_len)
        return jnp.stack(
            [
                out["found"].astype(jnp.int32),
                out["start1"],
                out["stop1"],
                out["start2"],
                out["stop2"],
                out["matches"],
                out["cost"],
            ]
        )

    def _core(self, jax, jnp, width, bits, quals_in, args_it,
              need_plane=False):
        """Traced per-mate compute, composable into a single-mate step or
        the fused insert pair step.

        Consumes this mate's device args from ``args_it`` (packed/raw
        sequences, int16 windows, optional raw qualities, decode tables or
        translated matrices), decodes the needed views, optionally runs
        the NextSeq/quality kernels in-graph, and runs the per-adapter DP
        kernels. Returns ``(rows, extras, win_len, insert_plane)`` where
        ``insert_plane`` is the mate's diagonal-matcher byte plane
        (identity for mate1, complemented for mate2) when requested.
        """
        from atropos_tpu.align.batched import (
            nextseq_trim_batch,
            quality_trim_batch,
        )

        main = next(args_it)
        win16 = next(args_it)
        quals = next(args_it) if quals_in else None
        views = {}
        if bits:
            tables = next(args_it)
            p = main.astype(jnp.int32)
            if bits == 2:
                parts = [(p >> s) & 3 for s in (0, 2, 4, 6)]
            else:
                parts = [p & 15, (p >> 4) & 15]
            codes = jnp.stack(parts, axis=-1).reshape(p.shape[0], width)

            def view(view_idx):
                # one-hot decode: a select chain over the 2**bits codes
                # that XLA fuses into its consumers (on an H100 it and a
                # jnp.take gather time within noise of each other)
                if view_idx not in views:
                    table = tables[view_idx]
                    acc = jnp.zeros(codes.shape, jnp.int32)
                    for code in range(1 << bits):
                        acc = acc + jnp.where(codes == code, table[code], 0)
                    views[view_idx] = acc
                return views[view_idx]

            identity = lambda: view(self._identity_view)  # noqa: E731
            aligner_mat = lambda i: view(self._aligner_view[i])  # noqa: E731
            plane_fn = lambda: view(self._insert_view)  # noqa: E731
        else:
            seqs = main
            translated = [next(args_it) for lut in self._luts if lut is not None]
            tr_index = {}
            for i, lut in enumerate(self._luts):
                if lut is not None:
                    tr_index[i] = len(tr_index)

            def aligner_mat(i):
                if self._luts[i] is not None:
                    return translated[tr_index[i]].astype(jnp.int32)
                if "upper" not in views:
                    low = (seqs >= 97) & (seqs <= 122)
                    views["upper"] = (
                        seqs - low.astype(jnp.uint8) * 32
                    ).astype(jnp.int32)
                return views["upper"]

            identity = lambda: seqs.astype(jnp.int32)  # noqa: E731

            def plane_fn():
                if self.insert_role == 1:
                    return identity()
                return _device_complement(jnp, identity())

        win_len = win16.astype(jnp.int32)
        extras = []
        if quals_in:
            if self.nextseq is not None:
                g_stop = nextseq_trim_batch(
                    identity(), quals, win_len,
                    self.nextseq.cutoff, self.nextseq.base,
                )
                extras.append(g_stop)
                win_len = jnp.where(win_len > 0, g_stop, win_len)
            if self.quality is not None:
                q_start, q_stop = quality_trim_batch(
                    quals, win_len, self.quality.cutoff_front,
                    self.quality.cutoff_back, self.quality.base,
                )
                extras.extend([q_start, q_stop])
                win_len = jnp.where(win_len > 0, q_stop - q_start, win_len)

        rows = []
        pack3 = self.res_rows(width) == 3
        for i, aligner in enumerate(self._aligners):
            out7 = self._aligner_rows(jnp, aligner, aligner_mat(i), win_len)
            rows.append(self._pack_res_rows(jnp, out7) if pack3 else out7)
        plane = plane_fn() if need_plane else None
        return rows, extras, win_len, plane

    def _arg_specs(self, mode):
        """shard_map input specs for this mate's device args under a
        given (bits, quals_in, n_tr) mode."""
        from jax.sharding import PartitionSpec as P

        from atropos_tpu.parallel import READS_AXIS

        bits, quals_in, n_tr = mode
        specs = [P(READS_AXIS, None), P(READS_AXIS)]
        if quals_in:
            specs.append(P(READS_AXIS, None))
        if bits:
            specs.append(P(None, None))  # decode tables (replicated)
        else:
            specs.extend([P(READS_AXIS, None)] * n_tr)
        return specs

    def _get_step(self, width, pad_b, mode):
        """Jitted single-mate device step for one batch shape: _core +
        quality-extra rows + sharded stats, one int16 bundle out.

        Bundle rows: [7 per adapter: found,start1,stop1,start2,stop2,
        matches,cost] + quality rows (+ sharded stats row)."""
        key = (width, pad_b) + mode
        if key in self._asteps:
            return self._asteps[key]

        import jax
        import jax.numpy as jnp

        from atropos_tpu.parallel import data_parallel_mesh

        mesh = data_parallel_mesh()
        bits, quals_in, _ = mode

        def step(*args):
            rows, extras, win_len, _ = self._core(
                jax, jnp, width, bits, quals_in, iter(args)
            )
            n_aligners = len(rows)
            for extra in extras:
                rows.append(extra[None, :].astype(jnp.int32))
            if sharded:
                rows.append(
                    self._stats_rows(jax, jnp, rows, n_aligners, win_len)
                )
            return self._finish_bundle(jnp, rows, win_len)

        sharded = mesh is not None and mesh.devices.size > 1
        if sharded:
            # in-process data parallelism: split the batch axis over the
            # local device mesh; every shard runs the identical step
            from jax.sharding import PartitionSpec as P

            from atropos_tpu.parallel import READS_AXIS, _shard_map

            step = _shard_map(
                step, mesh,
                in_specs=tuple(self._arg_specs(mode)),
                out_specs=P(None, READS_AXIS),
            )
            self._sharded = True

        self._asteps[key] = jax.jit(step)
        return self._asteps[key]

    # -- submit: host prep + async device dispatch ----------------------------

    def _pad_batch(self, batch):
        """Device batch width: bucketed to powers of two so the compile
        count stays small, and dividing evenly over the local device
        mesh."""
        from atropos_tpu.parallel import data_parallel_mesh

        mesh = data_parallel_mesh()
        ndev = mesh.devices.size if mesh is not None else 1
        size = 64
        while size < batch or size % ndev:
            size *= 2
        return size

    def _mesh_is_sharded(self):
        from atropos_tpu.parallel import data_parallel_mesh

        mesh = data_parallel_mesh()
        return mesh is not None and mesh.devices.size > 1

    def _decode_tables(self, symbols, n_codes):
        """[n_views, n_codes] int32 code->ASCII decode tables for this
        chunk's symbol set (one row per device view)."""
        tables = np.zeros((max(1, len(self._view_luts)), n_codes), np.int32)
        for view_idx, lut in enumerate(self._view_luts):
            tables[view_idx, : symbols.size] = lut[symbols]
        return tables

    @staticmethod
    def _patch_rows(mat, overrides, key, keep_start, width):
        """Overwrite gathered matrix rows with replacement content (mate
        overwrite): row ``rows[i]`` becomes ``overrides[key][i]`` shifted
        to the row's gather origin ``keep_start[row]``."""
        src = overrides[key]
        new_n = overrides["n"]
        for r_i, row in enumerate(overrides["rows"]):
            ks = int(keep_start[row])
            take = min(width, max(0, int(new_n[r_i]) - ks))
            mat[row, :take] = src[r_i, ks : ks + take]
            mat[row, take:] = 0
        return mat

    def prepare(self, chunk, sub, overrides=None):
        """Host-side batch prep: fixed cuts, host window gather, the
        synchronous 5'-quality path, pack decision, and device-arg
        upload. Returns (token, dev_args | None, mode) where dev_args
        feed :meth:`_core` and mode = (bits, quals_in, n_translated).

        ``overrides`` (mate overwrite, ``-w``) replaces whole reads
        before any stage sees them: dict(rows, n, seq, qual) with full
        replacement content per affected row. Packing is disabled for
        such batches (the replacement bytes are host-side, not in the
        chunk buffer)."""
        import jax.numpy as jnp

        from atropos_tpu.align.batched import (
            nextseq_trim_batch,
            quality_trim_batch,
        )

        n = chunk.seq_len[sub].astype(np.int32)
        if overrides is not None:
            n[overrides["rows"]] = overrides["n"]
        batch = n.shape[0]
        keep_start = np.zeros(batch, np.int32)
        keep_stop = n.copy()

        # C: fixed cuts (Sequence.clip semantics; no-op for empty reads)
        if self.cut_front or self.cut_back:
            nonempty = n > 0
            new_start = np.minimum(self.cut_front, n)
            new_stop = np.maximum(new_start, n + self.cut_back)
            keep_start = np.where(nonempty, new_start, keep_start)
            keep_stop = np.where(nonempty, new_stop, keep_stop)
            # Trimmer.clip counts the REQUESTED front+back bases, even
            # when the read is shorter (reference Sequence.clip semantics)
            self.cutter_mod.trimmed_bases += int(
                (self.cut_front - self.cut_back) * nonempty.sum()
            )

        width = int(n.max()) if batch else 0
        width = max(8, -(-width // 32) * 32)
        pad_b = self._pad_batch(batch)
        # post-cut window, kept for post-stage provenance accounting
        cut_start = keep_start.copy()
        cut_stop = keep_stop.copy()

        # host-side window matrix at the fixed-cut offset (feeds the
        # anchored matchers, adapter statistics and N-counting; never
        # uploaded when packing is active)
        seqs = self._gather(chunk, sub, chunk.seq_off, keep_start, width, pad_b)
        if overrides is not None:
            self._patch_rows(seqs, overrides, "seq", keep_start, width)
        win_len = keep_stop - keep_start
        host_q = {}
        sync_qclip = None
        quals_in = self._needs_quals

        if quals_in and _host_qualtrim_enabled():
            # native host quality path: windows + stats computed here,
            # nothing quality-related crosses the link
            g_stop, q_start, q_stop = self._native_quality(
                chunk, sub, keep_start, win_len, overrides
            )
            wl = keep_stop - keep_start
            if self.nextseq is not None:
                nz = wl > 0
                new_stop = keep_start + g_stop
                self.nextseq.trimmed_bases += int(
                    (keep_stop - new_stop)[nz].sum()
                )
                keep_stop = np.where(nz, new_stop, keep_stop)
                wl = keep_stop - keep_start
            if self.quality is not None:
                nz = wl > 0
                origin = keep_start
                self.quality.trimmed_bases += int(
                    (wl - (q_stop - q_start))[nz].sum()
                )
                keep_start = np.where(nz, origin + q_start, keep_start)
                keep_stop = np.where(nz, origin + q_stop, keep_stop)
            win_len = keep_stop - keep_start
            if np.any(keep_start != cut_start):
                seqs = self._gather(
                    chunk, sub, chunk.seq_off, keep_start, width, pad_b
                )
                if overrides is not None:
                    self._patch_rows(
                        seqs, overrides, "seq", keep_start, width
                    )
            host_q = {"applied": True}
            sync_qclip = (keep_start - cut_start, cut_stop - keep_stop)
            quals_in = False
        elif self._sync_quality:
            # 5' quality cutoff moves the window start: run the quality
            # kernels now (synchronous raw upload), apply windows + stats,
            # and re-gather for the adapter stage
            quals = self._gather(
                chunk, sub, chunk.qual_off, keep_start, width, pad_b
            )
            if overrides is not None:
                self._patch_rows(quals, overrides, "qual", keep_start, width)
            win_dev = jnp.asarray(np.pad(win_len, (0, pad_b - batch)))
            d_quals = jnp.asarray(quals)
            extras = []
            if self.nextseq is not None:
                g_stop = nextseq_trim_batch(
                    jnp.asarray(seqs), d_quals, win_dev,
                    self.nextseq.cutoff, self.nextseq.base,
                )
                extras.append(g_stop)
                win_dev = jnp.where(win_dev > 0, g_stop, win_dev)
            q_start, q_stop = quality_trim_batch(
                d_quals, win_dev, self.quality.cutoff_front,
                self.quality.cutoff_back, self.quality.base,
            )
            extras.extend([q_start, q_stop])
            fetched = [np.asarray(x)[:batch] for x in extras]
            cursor = 0
            wl = keep_stop - keep_start
            if self.nextseq is not None:
                g = fetched[cursor]
                cursor += 1
                nz = wl > 0
                new_stop = keep_start + g
                self.nextseq.trimmed_bases += int(
                    (keep_stop - new_stop)[nz].sum()
                )
                keep_stop = np.where(nz, new_stop, keep_stop)
                wl = keep_stop - keep_start
            qs, qp = fetched[cursor], fetched[cursor + 1]
            nz = wl > 0
            origin = keep_start
            self.quality.trimmed_bases += int((wl - (qp - qs))[nz].sum())
            keep_start = np.where(nz, origin + qs, keep_start)
            keep_stop = np.where(nz, origin + qp, keep_stop)
            win_len = keep_stop - keep_start
            seqs = self._gather(
                chunk, sub, chunk.seq_off, keep_start, width, pad_b
            )
            if overrides is not None:
                self._patch_rows(seqs, overrides, "seq", keep_start, width)
            host_q = {"applied": True}
            sync_qclip = (keep_start - cut_start, cut_stop - keep_stop)
            quals_in = False

        pack = _pack_info(chunk) if overrides is None else None
        args = None
        mode = None
        if self._aligners or quals_in or self._mesh_is_sharded():
            win_pad = np.zeros(pad_b, np.int16)
            win_pad[:batch] = win_len
            if pack is not None:
                bits, code_lut, symbols = pack
                packed = self._gather_packed(
                    chunk, sub, keep_start, width, pad_b, code_lut, bits
                )
                args = [jnp.asarray(packed), jnp.asarray(win_pad)]
                if quals_in:
                    quals = self._gather(
                        chunk, sub, chunk.qual_off, keep_start, width, pad_b
                    )
                    args.append(jnp.asarray(quals))
                args.append(
                    jnp.asarray(self._decode_tables(symbols, 1 << bits))
                )
                mode = (bits, quals_in, 0)
            else:
                # raw fallback (> 16 distinct symbols): raw sequences +
                # per-wildcard-adapter translated matrices cross the link
                args = [jnp.asarray(seqs), jnp.asarray(win_pad)]
                if quals_in:
                    quals = self._gather(
                        chunk, sub, chunk.qual_off, keep_start, width, pad_b
                    )
                    if overrides is not None:
                        self._patch_rows(
                            quals, overrides, "qual", keep_start, width
                        )
                    args.append(jnp.asarray(quals))
                n_tr = 0
                for lut in self._luts:
                    if lut is not None:
                        args.append(jnp.asarray(lut[_upper(seqs)]))
                        n_tr += 1
                mode = (0, quals_in, n_tr)
        tok = _Inflight(
            bundle=None,
            chunk=chunk,
            sub=sub,
            batch=batch,
            width=width,
            pad_b=pad_b,
            keep_start=keep_start,
            keep_stop=keep_stop,
            cut_start=cut_start,
            cut_stop=cut_stop,
            qclip=sync_qclip,
            n=n,
            seqs=seqs,
            host_q=host_q,
        )
        return tok, args, mode

    def submit(self, chunk, sub, overrides=None):
        """One-lane dispatch: prepare the batch and run this mate's
        jitted step (the paired insert driver instead composes two
        prepared mates into one fused step)."""
        tok, args, mode = self.prepare(chunk, sub, overrides=overrides)
        if args is not None:
            step = self._get_step(tok.width, tok.pad_b, mode)
            tok.bundle = step(*args)
            if self._sharded:
                from atropos_tpu.parallel import SHARD_COUNTS

                SHARD_COUNTS["sharded_calls"] += 1
        return tok

    # -- resolve: one fetch + host logic --------------------------------------

    def resolve_windows(self, tok):
        """Fetch the device bundle and produce (keep_start, keep_stop,
        matched) for the batch, accumulating all modifier statistics.
        ``tok.bundle`` may be None (no device work: no DP aligners, no
        quality stage, unsharded) — the host-side anchored matchers still
        run then."""
        if tok.bundle is None:
            arr_full = arr = None
        else:
            arr_full = np.asarray(tok.bundle).astype(np.int32)
            arr = arr_full[:, : tok.batch]
        batch = tok.batch
        keep_start = tok.keep_start
        keep_stop = tok.keep_stop
        n_adapt = len(self._aligners)
        rpa = self.res_rows(tok.width)  # bundle rows per aligner result
        cursor = rpa * n_adapt

        if tok.host_q:
            # sync 5'-cutoff path: quality windows and their stats were
            # already applied at submit; tok.keep_start/stop are final
            pass
        elif self._needs_quals:
            q_extras = []
            if self.nextseq is not None:
                q_extras.append(arr[cursor])
                cursor += 1
            if self.quality is not None:
                q_extras.extend([arr[cursor], arr[cursor + 1]])
                cursor += 2
            keep_start, keep_stop = self._apply_quality(
                tok, q_extras, keep_start, keep_stop
            )

        win_len = keep_stop - keep_start
        # the pre-adapter window: side files (info/rest/wildcard) slice
        # their fields from the read state AT MATCH TIME
        tok.win_start = keep_start
        tok.win_stop = keep_stop

        # A: adapter matching + trim
        matched = np.zeros(batch, bool)
        if self.adapters:
            best = None
            best_idx = None
            dev_i = 0
            upper = None
            for adapter_idx in range(len(self.adapters)):
                if adapter_idx in self._matchers:
                    # anchored no-indel: vectorized host comparator, plus
                    # the overlap/error-rate gate the DP kernel enforces
                    # in-kernel (Adapter.match_to semantics)
                    if upper is None:
                        upper = _upper(tok.seqs[:batch])
                    res = self._matchers[adapter_idx].locate_batch(
                        upper, win_len
                    )
                    res = {key: np.asarray(val) for key, val in res.items()}
                    adapter = self.adapters[adapter_idx]
                    size = res["stop1"] - res["start1"]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        rate_ok = np.where(
                            size > 0, res["cost"] / np.maximum(size, 1), 1.0
                        ) <= adapter.max_error_rate
                    res["found"] = (
                        res["found"]
                        & (size >= adapter.min_overlap)
                        & rate_ok
                    )
                else:
                    rows = arr[rpa * dev_i : rpa * dev_i + rpa]
                    dev_i += 1
                    if rpa == 3:
                        res = self._unpack_res_rows(rows)
                    else:
                        res = dict(
                            found=rows[0].astype(bool),
                            start1=rows[1],
                            stop1=rows[2],
                            start2=rows[3],
                            stop2=rows[4],
                            matches=rows[5],
                            cost=rows[6],
                        )
                res["found"] = res["found"] & (win_len > 0)
                res = self._validate(adapter_idx, res)
                if best is None:
                    best = res
                    best_idx = np.where(res["found"], adapter_idx, -1)
                else:
                    better = res["found"] & (
                        (~best["found"]) | (res["matches"] > best["matches"])
                    )
                    for key in res:
                        best[key] = np.where(better, res[key], best[key])
                    best_idx = np.where(better, adapter_idx, best_idx)

            matched = best["found"]
            # resolve trims per adapter type
            front_match = self._front_flags(best, best_idx)
            tok.match_data = dict(
                matched=matched,
                best_idx=best_idx,
                astart=best["start1"],
                astop=best["stop1"],
                rstart=best["start2"],
                rstop=best["stop2"],
                errors=best["cost"],
                front=front_match,
            )
            new_start = np.where(
                matched & front_match, keep_start + best["stop2"], keep_start
            )
            new_stop = np.where(
                matched & ~front_match, keep_start + best["start2"], keep_stop
            )
            self._accumulate_adapter_stats(
                best, best_idx, matched, front_match, win_len, tok.seqs
            )
            keep_start = new_start
            keep_stop = np.maximum(keep_start, new_stop)
            self.cutter.with_adapters += int(matched.sum())

        if self._sharded:
            # cross-check the psum-reduced device counters (last bundle
            # row) against the host-derived values: proof the collective
            # statistics path executed and agrees with the product output
            from atropos_tpu.parallel import SHARD_COUNTS

            psum_matched = (int(arr_full[-1, 0]) << 15) + int(arr_full[-1, 1])
            psum_bp = (int(arr_full[-1, 2]) << 15) + int(arr_full[-1, 3])
            SHARD_COUNTS["psum_counter_checks"] += 1
            # host-side gates (max_rmp, anchored-no-indel matchers) can
            # change `matched` after the device reduction; skip the strict
            # equality then
            if not self._has_max_rmp and not self._matchers:
                host_matched = int(matched.sum())
                host_bp = int(np.maximum(win_len, 0).sum())
                if (psum_matched, psum_bp) != (host_matched, host_bp):
                    raise AssertionError(
                        "psum counters diverge from host: device (%d, %d) "
                        "!= host (%d, %d)"
                        % (psum_matched, psum_bp, host_matched, host_bp)
                    )

        return keep_start, keep_stop, matched

    def criterion_hits(self, ftype, wrapper, tok, keep_start, keep_stop,
                       matched):
        """Vectorized single-read criterion over the batch (the pair/SE
        wrapping happens in the drivers)."""
        final_len = keep_stop - keep_start
        if ftype is TooShortReadFilter:
            return final_len < wrapper.filter.minimum_length
        if ftype is TooLongReadFilter:
            return final_len > wrapper.filter.maximum_length
        if ftype is NContentFilter:
            ncount = self._count_n(tok, keep_start, keep_stop)
            fil = wrapper.filter
            if fil.is_proportion:
                with np.errstate(divide="ignore", invalid="ignore"):
                    frac = np.where(final_len > 0, ncount / final_len, 0)
                return frac > fil.cutoff
            return ncount > fil.cutoff
        if ftype is TrimmedFilter:
            return matched
        if ftype is UntrimmedFilter:
            return ~matched
        raise AssertionError(ftype)  # pragma: no cover - excluded at build

    def apply_post(self, tok, keep_start, keep_stop, matched):
        """Vectorized post-adapter fixed stages (NEndTrimmer / MinCutter)
        with the reference's provenance bookkeeping: ``Sequence.clipped``
        lanes (pre/post adapter per end, requested amounts for clip()
        and actual amounts for subseq()) and MatchInfo.rsize_total
        credits (ref ``modifiers.py:592-650,766-784``)."""
        if not self.post_mods:
            return keep_start, keep_stop
        from atropos_tpu.commands.trim.modifiers import MinCutter, NEndTrimmer

        batch = tok.batch
        clip = np.zeros((4, batch), np.int64)
        # C-stage fixed cuts record their REQUESTED amounts for nonempty
        # reads (pre-match lanes 0/1, Trimmer.clip semantics)
        if self.cut_front or self.cut_back:
            nonempty = tok.n > 0
            clip[0, nonempty] += self.cut_front
            clip[1, nonempty] += -self.cut_back
        # quality stages record their ACTUAL amounts (subseq semantics)
        if tok.qclip is not None:
            clip[0] += tok.qclip[0]
            clip[1] += tok.qclip[1]
        md = tok.match_data
        # adapter credits via MatchInfo.rsize_total: front match -> rstop,
        # back match -> window_len - rstart
        rsize_front = np.zeros(batch, np.int64)
        rsize_back = np.zeros(batch, np.int64)
        is_front = np.zeros(batch, bool)
        if md is not None:
            window_len = tok.win_stop - tok.win_start
            is_front = md["front"] & matched
            back_m = matched & ~md["front"]
            rsize_front[is_front] = md["rstop"][is_front]
            rsize_back[back_m] = (window_len - md["rstart"])[back_m]

        pre = ~matched  # clipped lane selector: 0/1 pre-match, 2/3 post
        cur_start = keep_start.astype(np.int64)
        cur_stop = keep_stop.astype(np.int64)

        def bump_clip(front_amt, back_amt):
            clip[0] += np.where(pre, front_amt, 0)
            clip[2] += np.where(~pre, front_amt, 0)
            clip[1] += np.where(pre, back_amt, 0)
            clip[3] += np.where(~pre, back_amt, 0)

        for mod in self.post_mods:
            wl = cur_stop - cur_start
            alive = wl > 0
            if type(mod) is NEndTrimmer:
                heads, tails = self._end_n_runs(tok, cur_start, cur_stop)
                heads = np.where(alive, heads, 0)
                tails = np.where(alive, tails, 0)
                mod.trimmed_bases += int((heads + tails).sum())
                bump_clip(heads, tails)
                tail_start = wl - tails  # subseq end index (pre-clamp)
                new_start = cur_start + np.minimum(heads, wl)
                new_stop = cur_start + np.clip(tail_start, 0, wl)
                cur_start = new_start
                cur_stop = np.maximum(new_stop, new_start)
            else:  # MinCutter
                if mod.only_trimmed:
                    side_front = is_front
                    side_back = matched & ~is_front
                else:
                    side_front = side_back = np.ones(batch, bool)
                if mod.count_trimmed:
                    credit_front = clip[0] + clip[2] + rsize_front
                    credit_back = clip[1] + clip[3] + rsize_back
                else:
                    credit_front = np.where(matched, clip[2], clip[0])
                    credit_back = np.where(matched, clip[3], clip[1])
                front_amt = np.where(
                    side_front,
                    np.maximum(mod.front_length - credit_front, 0),
                    0,
                )
                back_amt = np.where(
                    side_back,
                    np.minimum(credit_back + mod.back_length, 0),
                    0,
                )
                active = alive & ((front_amt > 0) | (back_amt < 0))
                front_amt = np.where(active, front_amt, 0)
                back_amt = np.where(active, -back_amt, 0)  # now positive
                mod.trimmed_bases += int((front_amt + back_amt).sum())
                bump_clip(front_amt, back_amt)
                new_start = cur_start + np.minimum(front_amt, wl)
                new_stop = cur_stop - np.minimum(back_amt, wl)
                cur_start = new_start
                cur_stop = np.maximum(new_stop, new_start)
        return cur_start.astype(np.int32), cur_stop.astype(np.int32)

    def _end_n_runs(self, tok, cur_start, cur_stop):
        """Per-read lengths of the leading and trailing 'N' runs inside
        the current windows (regex ^N+/N+$ semantics: an all-N read
        reports BOTH runs at full length)."""
        batch = tok.batch
        base = tok.keep_start
        a = (cur_start - base)[:, None]
        b = (cur_stop - base)[:, None]
        idx = np.arange(tok.width, dtype=np.int64)[None, :]
        in_win = (idx >= a) & (idx < b)
        not_n = in_win & (tok.seqs[:batch] != ord("N"))
        has = not_n.any(axis=1)
        wl = (b - a)[:, 0]
        first = np.where(has, not_n.argmax(axis=1), b[:, 0])
        heads = first - a[:, 0]
        last = np.where(
            has, tok.width - 1 - not_n[:, ::-1].argmax(axis=1), a[:, 0] - 1
        )
        tails = b[:, 0] - 1 - last
        return np.where(has, heads, wl), np.where(has, tails, wl)

    def _apply_quality(self, tok, q_extras, keep_start, keep_stop):
        """Apply fetched NextSeq/quality windows and count their stats —
        the async twin of the 5'-cutoff sync path in :meth:`prepare`.
        Records the per-read actual clip amounts on the token (post-stage
        provenance: Sequence.subseq semantics)."""
        cursor = 0
        start_in = keep_start
        stop_in = keep_stop
        win_len = keep_stop - keep_start
        if self.nextseq is not None:
            stops = q_extras[cursor]
            cursor += 1
            nonempty = win_len > 0
            new_stop = keep_start + stops
            self.nextseq.trimmed_bases += int(
                (keep_stop - new_stop)[nonempty].sum()
            )
            keep_stop = np.where(nonempty, new_stop, keep_stop)
            win_len = keep_stop - keep_start
        if self.quality is not None:
            q_start, q_stop = q_extras[cursor], q_extras[cursor + 1]
            nonempty = win_len > 0
            new_start = keep_start + q_start
            new_stop = keep_start + q_stop
            self.quality.trimmed_bases += int(
                (win_len - (q_stop - q_start))[nonempty].sum()
            )
            keep_start = np.where(nonempty, new_start, keep_start)
            keep_stop = np.where(nonempty, new_stop, keep_stop)
        tok.qclip = (keep_start - start_in, stop_in - keep_stop)
        return keep_start, keep_stop

    # -- helpers ------------------------------------------------------------

    def _native_quality(self, chunk, sub, keep_start, win_len, overrides):
        """Relative (g_stop, q_start, q_stop) window arrays for this
        lane's NextSeq/quality stages, computed by the native host
        kernel straight from the chunk buffer (bit-identical to the
        device kernels; scalar spec ``commands/trim/qualtrim.py``)."""
        from atropos_tpu.runtime import _i32, _i64, _lib, _u8

        batch = win_len.shape[0]
        extra = keep_start.astype(np.int64)
        qual_offs = np.ascontiguousarray(chunk.qual_off[sub] + extra, np.int64)
        seq_offs = np.ascontiguousarray(chunk.seq_off[sub] + extra, np.int64)
        wl = np.ascontiguousarray(win_len, np.int32)
        g_stop = np.empty(batch, np.int32)
        q_start = np.empty(batch, np.int32)
        q_stop = np.empty(batch, np.int32)
        nextseq_cut = self.nextseq.cutoff if self.nextseq is not None else -1
        stage = self.quality if self.quality is not None else self.nextseq
        base = stage.base
        has_q = 1 if self.quality is not None else 0
        cf = self.quality.cutoff_front if has_q else 0
        cb = self.quality.cutoff_back if has_q else 0
        _lib.quality_trim_windows(
            _u8(chunk.buf), _i64(seq_offs), _i64(qual_offs), _i32(wl),
            batch, base, nextseq_cut, has_q, cf, cb,
            _i32(g_stop), _i32(q_start), _i32(q_stop),
        )
        if overrides is not None:
            self._override_quality(
                overrides, keep_start, win_len, g_stop, q_start, q_stop,
                nextseq_cut, has_q, cf, cb, base,
            )
        return g_stop, q_start, q_stop

    @staticmethod
    def _override_quality(overrides, keep_start, win_len, g_stop, q_start,
                          q_stop, nextseq_cut, has_q, cf, cb, base):
        """Recompute the quality windows of mate-overwritten rows from
        their replacement content (the native kernel read the chunk
        buffer; these rows' bytes live in the overrides arrays)."""
        for r_i, row in enumerate(overrides["rows"]):
            start_w = int(keep_start[row])
            length = int(win_len[row])
            if length <= 0:
                g_stop[row] = 0
                q_start[row] = 0
                q_stop[row] = 0
                continue
            quals = overrides["qual"][r_i, start_w : start_w + length]
            seqs = overrides["seq"][r_i, start_w : start_w + length]
            if nextseq_cut >= 0:
                acc = best = 0
                maxi = length
                for j in range(length - 1, -1, -1):
                    qv = int(quals[j]) - base
                    if seqs[j] == ord("G"):
                        qv = nextseq_cut - 1
                    acc += nextseq_cut - qv
                    if acc < 0:
                        break
                    if acc > best:
                        best = acc
                        maxi = j
                g_stop[row] = maxi
                length = maxi
            else:
                g_stop[row] = length
            if not has_q:
                q_start[row] = 0
                q_stop[row] = length
                continue
            start, stop = 0, length
            acc = best = 0
            for j in range(length):
                acc += cf - (int(quals[j]) - base)
                if acc < 0:
                    break
                if acc > best:
                    best = acc
                    start = j + 1
            acc = best = 0
            for j in range(length - 1, -1, -1):
                acc += cb - (int(quals[j]) - base)
                if acc < 0:
                    break
                if acc > best:
                    best = acc
                    stop = j
            if start >= stop:
                start, stop = 0, 0
            q_start[row] = start
            q_stop[row] = stop

    def _gather(self, chunk, sub, offs, extra_off, width, pad_b=None):
        from atropos_tpu.runtime import _i32, _i64, _lib, _u8

        offs_sub = np.ascontiguousarray(
            offs[sub] + extra_off.astype(np.int64), dtype=np.int64
        )
        lens_sub = np.ascontiguousarray(
            (chunk.seq_len[sub] - extra_off).astype(np.int32)
        )
        rows = pad_b if pad_b is not None else offs_sub.shape[0]
        out = np.zeros((rows, width), dtype=np.uint8)
        _lib.gather_padded(
            _u8(chunk.buf), _i64(offs_sub), _i32(lens_sub),
            offs_sub.shape[0], width, _u8(out),
        )
        return out

    def _gather_packed(
        self, chunk, sub, extra_off, width, pad_b, code_lut, bits
    ):
        """Bit-packed gather of the (window-offset) sequences: [pad_b,
        width*bits/8] uint8, codes little-endian within each byte."""
        from atropos_tpu.runtime import _i32, _i64, _lib, _u8

        offs_sub = np.ascontiguousarray(
            chunk.seq_off[sub] + extra_off.astype(np.int64), dtype=np.int64
        )
        lens_sub = np.ascontiguousarray(
            (chunk.seq_len[sub] - extra_off).astype(np.int32)
        )
        out = np.zeros((pad_b, width * bits // 8), dtype=np.uint8)
        _lib.gather_packed(
            _u8(chunk.buf), _i64(offs_sub), _i32(lens_sub),
            offs_sub.shape[0], width, _u8(code_lut), bits, _u8(out),
        )
        return out

    def _validate(self, adapter_idx, res):
        """Apply the max_rmp gate (other constraints enforced in-kernel)."""
        adapter = self.adapters[adapter_idx]
        if adapter.max_rmp is None:
            return res
        found = res["found"]
        size = res["stop1"] - res["start1"]
        ok = found.copy()
        # vectorized over unique (matches, size) pairs
        rows = np.nonzero(found)[0]
        if rows.size:
            keys = res["matches"][rows].astype(np.int64) * 100000 + size[rows]
            for key in np.unique(keys):
                mat, sz = divmod(int(key), 100000)
                prob = adapter.match_probability(mat, sz)
                if prob > adapter.max_rmp:
                    ok[rows[keys == key]] = False
        res["found"] = ok
        return res

    def _front_flags(self, best, best_idx):
        """Per-read front/back decision, matching Adapter._front_flag and
        Match._guess_is_front for 'anywhere' adapters."""
        batch = best_idx.shape[0]
        front = np.zeros(batch, bool)
        for idx, adapter in enumerate(self.adapters):
            mask = best_idx == idx
            if not mask.any():
                continue
            if adapter.where in (FRONT, PREFIX):
                front |= mask
            elif adapter.where == ANYWHERE:
                front |= mask & (best["start2"] == 0)
        return front

    @staticmethod
    def _bump_histograms(lengths_dict, errors_nested, lens, errs):
        """Vectorized CountingDict/NestedDict accumulation: one bincount
        over packed (length, errors) keys instead of a per-read loop."""
        keys = lens.astype(np.int64) * 4096 + errs.astype(np.int64)
        uniq, counts = np.unique(keys, return_counts=True)
        for key, cnt in zip(uniq, counts):
            ln, er = divmod(int(key), 4096)
            lengths_dict[ln] += int(cnt)
            errors_nested[ln][er] += int(cnt)

    def _accumulate_adapter_stats(
        self, best, best_idx, matched, front_match, win_len, seqs
    ):
        """Update per-adapter CountingDict/NestedDict stats exactly as
        Adapter._trimmed_front/_trimmed_back do (vectorized)."""
        for idx, adapter in enumerate(self.adapters):
            mask = matched & (best_idx == idx)
            if not mask.any():
                continue
            fmask = mask & front_match
            bmask = mask & ~front_match
            if fmask.any():
                self._bump_histograms(
                    adapter.lengths_front,
                    adapter.errors_front,
                    best["stop2"][fmask],
                    best["cost"][fmask],
                )
            if bmask.any():
                rstart = best["start2"][bmask]
                removed = (win_len[bmask] - rstart).astype(np.int64)
                self._bump_histograms(
                    adapter.lengths_back,
                    adapter.errors_back,
                    removed,
                    best["cost"][bmask],
                )
                rows = np.nonzero(bmask)[0]
                prev = np.where(
                    rstart > 0,
                    seqs[rows, np.maximum(rstart - 1, 0)],
                    0,
                )
                for byte, cnt in zip(*np.unique(prev, return_counts=True)):
                    base = chr(int(byte))
                    if base not in "ACGT":
                        base = ""
                    adapter.adjacent_bases[base] += int(cnt)

    def _count_n(self, tok, keep_start, keep_stop):
        """Per-read 'N'/'n' counts inside the final windows, read from
        the host matrix (which carries any correction-stage edits, like
        the scalar NContentFilter seeing the corrected read)."""
        base = tok.keep_start
        lo = (keep_start - base)[:, None]
        hi = (keep_stop - base)[:, None]
        idx = np.arange(tok.width, dtype=np.int32)[None, :]
        in_win = (idx >= lo) & (idx < hi)
        seqs = tok.seqs[: tok.batch]
        is_n = (seqs == ord("N")) | (seqs == ord("n"))
        return (is_n & in_win).sum(axis=1)


class _PairInflight:
    """One in-flight insert-align pair batch: two prepared mate tokens
    plus the fused device bundle."""

    __slots__ = ("tok1", "tok2", "bundle")

    def __init__(self, tok1, tok2, bundle):
        self.tok1 = tok1
        self.tok2 = tok2
        self.bundle = bundle


class _InsertPair:
    """Turbo implementation of the insert-align paired stage: the
    device+host twin of ``InsertAdapterCutter`` over whole batches.

    Device side (one fused jitted step per batch shape): both mates'
    quality kernels and fallback-adapter DP, then the variable-length
    diagonal matcher over (rc(read2-window), read1-window) truncated to
    the per-pair min window — exactly the scalar
    ``InsertAligner.match_insert`` setup (reference
    ``atropos/align/__init__.py:219-314``). The reverse-complement is a
    per-chunk complement DECODE table plus one device gather, so nothing
    extra crosses the link.

    Host side (vectorized, no per-pair Python): closed-form candidate
    reconstruction (:meth:`BatchInsertMatcher.candidate_arrays`),
    random-match-probability filtering, probability-ordered candidate
    selection with both overhang-adapter checks
    (``align/__init__.py:284-306``), fallback independent matches,
    symmetric-match duplication and per-mate trims + statistics
    (``commands/trim/modifiers.py:359-509``). Error-correction configs
    decline upstream and run through the batched engine instead.
    """

    def __init__(self, lane1, lane2, cutter):
        from atropos_tpu.align.batched import (
            BatchInsertMatcher,
            _translation_lut,
        )

        self.lane1 = lane1
        self.lane2 = lane2
        self.cutter = cutter
        aligner = cutter.aligner
        self.aligner = aligner
        self.matcher = BatchInsertMatcher(
            aligner.max_insert_mismatch_frac,
            aligner.min_insert_overlap,
            max_matches=100,
        )
        self._steps = {}
        self._sharded = False
        # overhang comparator translation: compare_prefixes(ref=overhang,
        # query=adapter) with the reference's argument order
        aw = aligner.adapter_wildcards
        rw = aligner.read_wildcards
        self._cmp_ascii = not (aw or rw)
        self._ref_lut = _translation_lut(aw, rw, for_query=False)
        query_lut = _translation_lut(aw, rw, for_query=True)
        self._ad1 = np.frombuffer(aligner.adapter1.encode("ascii"), np.uint8)
        self._ad2 = np.frombuffer(aligner.adapter2.encode("ascii"), np.uint8)
        self._ad1_t = query_lut[self._ad1]
        self._ad2_t = query_lut[self._ad2]

    # -- submit ---------------------------------------------------------------

    def submit(self, chunk1, sub1, chunk2, sub2):
        tok1, args1, mode1 = self.lane1.prepare(chunk1, sub1)
        tok2, args2, mode2 = self.lane2.prepare(chunk2, sub2)
        assert tok1.pad_b == tok2.pad_b  # same batch size
        step = self._get_step(tok1.width, tok2.width, tok1.pad_b, mode1, mode2)
        bundle = step(*(list(args1) + list(args2)))
        if self._sharded:
            from atropos_tpu.parallel import SHARD_COUNTS

            SHARD_COUNTS["sharded_calls"] += 1
        return _PairInflight(tok1, tok2, bundle)

    def _get_step(self, w1, w2, pad_b, mode1, mode2):
        key = (w1, w2, pad_b, mode1, mode2)
        if key in self._steps:
            return self._steps[key]

        import jax
        import jax.numpy as jnp

        from atropos_tpu.align.batched import _diagonal_match_counts
        from atropos_tpu.parallel import data_parallel_mesh

        mesh = data_parallel_mesh()
        lane1, lane2 = self.lane1, self.lane2
        w_ins = min(w1, w2)
        min_insert = self.cutter.min_insert_len

        def step(*args):
            it = iter(args)
            rows1, extras1, win1, plane1 = lane1._core(
                jax, jnp, w1, mode1[0], mode1[1], it, need_plane=True
            )
            rows2, extras2, win2, plane2 = lane2._core(
                jax, jnp, w2, mode2[0], mode2[1], it, need_plane=True
            )
            # per-pair truncated length; ineligible pairs (below the
            # insert-overlap floor) are zeroed so no candidates emerge
            m_col = jnp.minimum(win1, win2)
            m_col = jnp.where(m_col >= min_insert, m_col, 0)
            # reversal of the complemented mate2 window = one gather
            t = jnp.arange(w_ins, dtype=jnp.int32)[None, :]
            idx = jnp.clip(m_col[:, None] - 1 - t, 0, w2 - 1)
            ref_plane = jnp.take_along_axis(plane2, idx, axis=1)
            rows = rows1 + rows2
            for extra in extras1 + extras2:
                rows.append(extra[None, :].astype(jnp.int32))
            query_plane = plane1[:, :w_ins]
            counts = _diagonal_match_counts(
                ref_plane.T, query_plane.T, m_col[None, :]
            )
            if w_ins <= 255:
                # on-device candidate reconstruction: only the fixed-size
                # candidate stream crosses the link (~36 B/pair), not the
                # full counts plane (~w_ins B/pair)
                from atropos_tpu.align.batched import (
                    insert_candidate_slots,
                )

                slots, meta = insert_candidate_slots(
                    counts, m_col, ref_plane, query_plane,
                    self.matcher.max_error_rate,
                    self.matcher.min_overlap,
                    self.matcher.max_matches,
                )
                rows.append(slots)
                rows.append(meta)
            else:
                rows.append(counts)
            if sharded:
                rows.append(
                    _MateLane._stats_rows(jax, jnp, rows, 2, m_col)
                )
            return _MateLane._finish_bundle(jnp, rows, win1)

        sharded = mesh is not None and mesh.devices.size > 1
        if sharded:
            from jax.sharding import PartitionSpec as P

            from atropos_tpu.parallel import READS_AXIS, _shard_map

            specs = tuple(
                lane1._arg_specs(mode1) + lane2._arg_specs(mode2)
            )
            step = _shard_map(
                step, mesh, in_specs=specs, out_specs=P(None, READS_AXIS)
            )
            self._sharded = True

        self._steps[key] = jax.jit(step)
        return self._steps[key]

    # -- resolve --------------------------------------------------------------

    @staticmethod
    def _n_extras(lane, tok):
        if tok.host_q or not lane._needs_quals:
            return 0
        return (1 if lane.nextseq is not None else 0) + (
            2 if lane.quality is not None else 0
        )

    def resolve(self, ptok):
        """Fetch the fused bundle; produce final per-mate windows +
        matched flags, accumulating every InsertAdapterCutter statistic
        exactly as the scalar pipeline would."""
        tok1, tok2 = ptok.tok1, ptok.tok2
        batch = tok1.batch
        arr = np.asarray(ptok.bundle).astype(np.int32)[:, :batch]
        lane1, lane2 = self.lane1, self.lane2

        rpa1 = lane1.res_rows(tok1.width)
        rpa2 = lane2.res_rows(tok2.width)
        cursor = rpa1 + rpa2
        n1e = self._n_extras(lane1, tok1)
        ks1, kp1 = tok1.keep_start, tok1.keep_stop
        if n1e:
            ks1, kp1 = lane1._apply_quality(
                tok1, list(arr[cursor : cursor + n1e]), ks1, kp1
            )
        cursor += n1e
        n2e = self._n_extras(lane2, tok2)
        ks2, kp2 = tok2.keep_start, tok2.keep_stop
        if n2e:
            ks2, kp2 = lane2._apply_quality(
                tok2, list(arr[cursor : cursor + n2e]), ks2, kp2
            )
        cursor += n2e
        w_ins = min(tok1.width, tok2.width)
        if w_ins <= 255:
            from atropos_tpu.align.batched import INSERT_CANDIDATE_SLOTS

            n_slots = INSERT_CANDIDATE_SLOTS
            vals = arr[cursor : cursor + n_slots] + 32768
            meta = arr[cursor + n_slots : cursor + n_slots + 3]
            has_final = meta[1] >= 512
            cd = dict(
                kind="slots",
                s=(vals & 0xFF) - 1,
                cnt=vals >> 8,
                n_cand=meta[0],
                final_ok=has_final,
                final_s=meta[1] - np.where(has_final, 512, 0),
                final_cnt=meta[2],
            )
        else:
            cd = dict(kind="counts", counts=arr[cursor : cursor + w_ins])

        if self._sharded:
            from atropos_tpu.parallel import SHARD_COUNTS

            # telemetry only: the final matched decision is host-side
            # candidate selection, so no strict equality check here
            SHARD_COUNTS["psum_counter_checks"] += 1

        wl1 = kp1 - ks1
        wl2 = kp2 - ks2
        res1 = self._mate_res(lane1, arr[0:rpa1], wl1)
        res2 = self._mate_res(lane2, arr[rpa1 : rpa1 + rpa2], wl2)

        sel = self._select(cd, tok1, tok2, wl1, wl2)
        m1, m2, info = self._combine(sel, res1, res2, wl1, wl2)
        len1_eff, len2_eff = wl1, wl2
        corr1 = corr2 = None
        if self.cutter.mismatch_action is not None:
            len1_eff, len2_eff, corr1, corr2 = self._correct(
                tok1, tok2, wl1, wl2, sel, info
            )
        for tok, lane, mate, ks, len_eff in (
            (tok1, lane1, m1, ks1, len1_eff), (tok2, lane2, m2, ks2, len2_eff),
        ):
            tok.win_start = ks
            tok.win_stop = (ks + len_eff).astype(np.int32)
            tok.match_data = dict(
                matched=mate["present"],
                best_idx=np.where(mate["present"], 0, -1),
                astart=mate["astart"],
                astop=mate["astop"],
                rstart=mate["rstart"],
                rstop=mate["rstop"],
                errors=mate["errors"],
                front=np.zeros(tok.batch, bool),
            )
        kp1 = self._apply_mate(lane1, tok1, m1, ks1, kp1, len1_eff, 0)
        kp2 = self._apply_mate(lane2, tok2, m2, ks2, kp2, len2_eff, 1)
        if corr1 is not None:
            tok1.alt = self._build_alt(corr1, ks1, kp1)
        if corr2 is not None:
            tok2.alt = self._build_alt(corr2, ks2, kp2)
        return ks1, kp1, m1["present"], ks2, kp2, m2["present"]

    @staticmethod
    def _mate_res(lane, rows, wl):
        """The mate's fallback adapter result with match_to validation
        (in-kernel overlap/error gates + the host max_rmp gate)."""
        if rows.shape[0] == 3:
            res = _MateLane._unpack_res_rows(rows)
        else:
            res = dict(
                found=rows[0].astype(bool),
                start1=rows[1],
                stop1=rows[2],
                start2=rows[3],
                stop2=rows[4],
                matches=rows[5],
                cost=rows[6],
            )
        res["found"] = res["found"] & (wl > 0)
        return lane._validate(0, res)

    def _rmp_bulk(self, matches, size, base_probs=None):
        """Vectorized RandomMatchProbability over unique (matches, size)
        pairs — same cached scalar evaluator, so float decisions are
        bit-identical to the reference."""
        out = np.empty(matches.shape[0], np.float64)
        prob_fn = self.aligner.match_probability
        kwargs = base_probs or {}
        keys = matches * (1 << 20) + size
        for key in np.unique(keys):
            kmatches, ksize = divmod(int(key), 1 << 20)
            out[keys == key] = prob_fn(kmatches, ksize, **kwargs)
        return out

    def _overhang(self, tok, rows_b, starts, lens, ad_raw, ad_t):
        """Vectorized compare_prefixes of each pair's adapter overhang
        (window bytes from ``starts``, ``lens`` long) vs the adapter."""
        count = rows_b.shape[0]
        cap = int(lens.max()) if count else 0
        if cap == 0:
            zeros = np.zeros(count, np.int64)
            return zeros, zeros
        tt = np.arange(cap, dtype=np.int64)[None, :]
        gidx = np.clip(starts[:, None] + tt, 0, tok.width - 1)
        sub = tok.seqs[:tok.batch][rows_b]
        window = np.take_along_axis(sub, gidx, axis=1)
        valid = tt < lens[:, None]
        if self._cmp_ascii:
            eq = window == ad_raw[None, :cap]
        else:
            eq = (self._ref_lut[window] & ad_t[None, :cap]) != 0
        matches = (eq & valid).sum(axis=1).astype(np.int64)
        return lens - matches, matches

    def _host_planes(self, tok1, tok2, m_eff, w_ins):
        """Host byte planes matching the device matcher inputs exactly
        (ref = reversed complemented mate2 window, query = mate1)."""
        batch = tok1.batch
        comp2 = _complement_lut()[tok2.seqs[:batch]]
        t = np.arange(w_ins)
        idx = np.clip(m_eff[:, None] - 1 - t[None, :], 0, tok2.width - 1)
        refs = np.take_along_axis(comp2[:, : tok2.width], idx, axis=1)
        refs = np.where(t[None, :] < m_eff[:, None], refs, 0).astype(np.uint8)
        query = np.ascontiguousarray(tok1.seqs[:batch, :w_ins])
        return refs, query

    @staticmethod
    def _host_counts(refs, query, m_eff):
        """numpy twin of ``_diagonal_match_counts`` for the (rare)
        slot-overflow pairs."""
        n_rows, W = query.shape
        counts = np.zeros((W, n_rows), np.int32)
        t_full = np.arange(W)
        for s in range(W):
            span = W - s
            eq = refs[:, s : s + span] == query[:, :span]
            valid = t_full[:span][None, :] < (m_eff[:, None] - s)
            counts[s] = (eq & valid).sum(axis=1)
        return counts

    def _assemble_candidates(self, cd, tok1, tok2, m_eff, w_ins):
        """The per-pair candidate stream as flat arrays
        (s, pair, stream-rank, match count, is_final), from either the
        device-reconstructed slots (overflow pairs recomputed host-side)
        or a full counts plane (legacy wide-read path)."""
        if cd["kind"] == "counts":
            counts = cd["counts"]
            refs, query = self._host_planes(tok1, tok2, m_eff, w_ins)
            arrs = self.matcher.candidate_arrays(counts, refs, query, m_eff)
            ss, bs = np.nonzero(arrs["cand"])
            fb = np.nonzero(arrs["final_ok"])[0]
            fs = arrs["final_s"][fb]
            s_list = [ss, fs]
            b_list = [bs, fb]
            r_list = [arrs["rank"][ss, bs], arrs["n_cand"][fb]]
            mt_list = [counts[ss, bs], counts[fs, fb]]
            fin_list = [np.zeros(ss.size, bool), np.ones(fb.size, bool)]
        else:
            n_slots = cd["s"].shape[0]
            overflow = cd["n_cand"] > n_slots
            present = (cd["s"] >= 0) & ~overflow[None, :]
            cs, bs = np.nonzero(present)
            f_mask = cd["final_ok"] & ~overflow
            fb = np.nonzero(f_mask)[0]
            s_list = [cd["s"][cs, bs], cd["final_s"][fb]]
            b_list = [bs, fb]
            r_list = [cs, cd["n_cand"][fb]]
            mt_list = [cd["cnt"][cs, bs], cd["final_cnt"][fb]]
            fin_list = [np.zeros(cs.size, bool), np.ones(fb.size, bool)]
            orows = np.nonzero(overflow)[0]
            if orows.size:
                SLOT_OVERFLOWS["pairs"] += int(orows.size)
                refs, query = self._host_planes(tok1, tok2, m_eff, w_ins)
                refs_o = refs[orows]
                query_o = query[orows]
                m_o = m_eff[orows]
                counts_o = self._host_counts(refs_o, query_o, m_o)
                arrs = self.matcher.candidate_arrays(
                    counts_o, refs_o, query_o, m_o
                )
                ss2, bs2 = np.nonzero(arrs["cand"])
                fb2 = np.nonzero(arrs["final_ok"])[0]
                fs2 = arrs["final_s"][fb2]
                s_list += [ss2, fs2]
                b_list += [orows[bs2], orows[fb2]]
                r_list += [arrs["rank"][ss2, bs2], arrs["n_cand"][fb2]]
                mt_list += [counts_o[ss2, bs2], counts_o[fs2, fb2]]
                fin_list += [
                    np.zeros(ss2.size, bool), np.ones(fb2.size, bool),
                ]
        s_all = np.concatenate(s_list).astype(np.int64)
        b_all = np.concatenate(b_list).astype(np.int64)
        rank_all = np.concatenate(r_list).astype(np.int64)
        mt = np.concatenate(mt_list).astype(np.int64)
        is_final = np.concatenate(fin_list)
        return s_all, b_all, rank_all, mt, is_final

    def _select(self, cd, tok1, tok2, wl1, wl2):
        """Per-pair insert-candidate selection: RMP filter, sort by
        probability (stream order on ties), first candidate surviving
        the overhang-adapter checks wins (``match_insert`` semantics)."""
        batch = tok1.batch
        aligner = self.aligner
        w_ins = min(tok1.width, tok2.width)
        out = dict(
            has=np.zeros(batch, bool),
            only=np.zeros(batch, bool),
            ims=np.zeros(batch, np.int64),
            mm=np.zeros(batch, np.int64),
            alen1=np.zeros(batch, np.int64),
            alen2=np.zeros(batch, np.int64),
            # selected-candidate geometry for overlap error correction
            cost=np.zeros(batch, np.int64),
            r1e=np.zeros(batch, np.int64),
            r2e=np.zeros(batch, np.int64),
        )
        m = np.minimum(wl1, wl2).astype(np.int64)
        out["eligible"] = eligible = m >= self.cutter.min_insert_len
        m_eff = np.where(eligible, m, 0)
        if not m_eff.any():
            return out

        s_all, b_all, rank_all, mt, is_final = self._assemble_candidates(
            cd, tok1, tok2, m_eff, w_ins
        )
        if s_all.size == 0:
            return out
        m_all = m_eff[b_all]
        qstop = np.where(is_final, m_all, m_all - s_all)
        offset = np.minimum(s_all, m_all - qstop)
        ims = m_all - offset
        prob = self._rmp_bulk(mt, ims, aligner.base_probs)
        keep = prob <= aligner.insert_max_rmp
        if not keep.any():
            return out
        s_all, b_all, rank_all, offset, ims, prob, qstop, mt = (
            a[keep]
            for a in (s_all, b_all, rank_all, offset, ims, prob, qstop, mt)
        )

        # _match evaluation per candidate (align/__init__.py:240-284)
        only = offset < aligner.min_adapter_overlap
        alen1 = np.minimum(offset, aligner.adapter1_len)
        alen2 = np.minimum(offset, aligner.adapter2_len)
        e1, mt1 = self._overhang(tok1, b_all, ims, alen1, self._ad1, self._ad1_t)
        e2, mt2 = self._overhang(tok2, b_all, ims, alen2, self._ad2, self._ad2_t)
        frac = aligner.max_adapter_mismatch_frac
        fail = (e1 > np.round(alen1 * frac)) & (e2 > np.round(alen2 * frac))
        check = np.minimum(alen1, alen2) > aligner.adapter_check_cutoff
        if check.any():
            p1 = self._rmp_bulk(mt1, alen1)
            p2 = self._rmp_bulk(mt2, alen2)
            fail |= check & ((p1 * p2) > aligner.adapter_max_rmp)
        ok = only | ~fail
        if not ok.any():
            return out

        # first surviving candidate per pair in (prob, stream) order
        order = np.lexsort((rank_all, prob, b_all))
        b_sorted = b_all[order]
        ok_pos = np.nonzero(ok[order])[0]
        first = np.full(batch, -1, np.int64)
        first[b_sorted[ok_pos[::-1]]] = ok_pos[::-1]
        has = first >= 0
        rowsel = order[first[has]]
        out["has"] = has
        out["only"][has] = only[rowsel]
        out["ims"][has] = ims[rowsel]
        out["mm"][has] = np.minimum(e1, e2)[rowsel]
        out["alen1"][has] = alen1[rowsel]
        out["alen2"][has] = alen2[rowsel]
        # selected insert_match geometry for the correction stage:
        # r1 overlap = [0, querystop), r2 overlap = [0, m - s); cost is
        # the candidate's mismatch count over the truncated overlap
        sel_s = s_all[rowsel]
        sel_b = b_all[rowsel]
        out["cost"][has] = ims[rowsel] - mt[rowsel]
        out["r1e"][has] = qstop[rowsel]
        out["r2e"][has] = m_eff[sel_b] - sel_s
        return out

    def _combine(self, sel, res1, res2, wl1, wl2):
        """Selection + fallback + symmetric duplication -> per-mate match
        field arrays plus correction-frame info
        (InsertAdapterCutter.__call__ flow)."""
        batch = wl1.shape[0]
        has = sel["has"]
        ipass = has & ~sel["only"]
        info = dict(
            frame=np.zeros(batch, bool),
            frame_rstart=np.zeros(batch, np.int64),
        )

        def blank():
            zero = np.zeros(batch, np.int64)
            return dict(
                present=np.zeros(batch, bool),
                rstart=zero.copy(),
                rstop=zero.copy(),
                astart=zero.copy(),
                astop=zero.copy(),
                errors=zero.copy(),
            )

        m1, m2 = blank(), blank()
        # insert-path matches (_create_match, modifiers.py:274-278)
        for mate, alen_key, wl in ((m1, "alen1", wl1), (m2, "alen2", wl2)):
            ims = sel["ims"]
            alen_eff = np.minimum(sel[alen_key], wl - ims)
            errors = np.minimum(alen_eff, sel["mm"])
            if ipass.any():
                # Match invariants (align Match.__init__), scalar parity
                if (alen_eff[ipass] <= 0).any():
                    raise ValueError("Match length must be >= 0")
                if ((alen_eff - errors)[ipass] <= 0).any():
                    raise ValueError(
                        "A Match requires at least one matching position."
                    )
            mate["present"] = ipass.copy()
            mate["rstart"] = np.where(ipass, ims, 0)
            mate["rstop"] = np.where(ipass, wl, 0)
            mate["astop"] = np.where(ipass, alen_eff, 0)
            mate["errors"] = np.where(ipass, errors, 0)

        # fallback independent matches for pairs without an insert result
        fallback = (~has) & sel["eligible"]
        for mate, res in ((m1, res1), (m2, res2)):
            if res is None:
                continue
            fpres = fallback & res["found"]
            mate["present"] |= fpres
            for field, src in (
                ("rstart", "start2"), ("rstop", "stop2"),
                ("astart", "start1"), ("astop", "stop1"),
                ("errors", "cost"),
            ):
                mate[field] = np.where(fpres, res[src], mate[field])
        if self.cutter.mismatch_action and res1 is not None and res2 is not None:
            # both independent matches at the same read position imply an
            # overlap frame for error correction (modifiers.py:266-273)
            both = fallback & res1["found"] & res2["found"]
            agree = both & (res1["start2"] == res2["start2"])
            info["frame"] |= agree
            info["frame_rstart"] = np.where(
                agree, res1["start2"], info["frame_rstart"]
            )

        # symmetric duplication (_mirror_match, modifiers.py:228-238)
        if self.cutter.symmetric:
            mir12 = m1["present"] & ~m2["present"]
            mir21 = m2["present"] & ~m1["present"]
            for src, dst, wl_dst, mir in (
                (m1, m2, wl2, mir12), (m2, m1, wl1, mir21),
            ):
                ok = mir & (src["rstart"] <= wl_dst)
                shrink = ok & (src["rstop"] < wl_dst)
                dst["present"] |= ok
                dst["rstart"] = np.where(ok, src["rstart"], dst["rstart"])
                dst["rstop"] = np.where(
                    ok, np.where(shrink, wl_dst, src["rstop"]), dst["rstop"]
                )
                dst["astart"] = np.where(ok, src["astart"], dst["astart"])
                dst["astop"] = np.where(
                    ok,
                    np.where(
                        shrink,
                        src["astop"] - (wl_dst - src["rstop"]),
                        src["astop"],
                    ),
                    dst["astop"],
                )
                dst["errors"] = np.where(ok, src["errors"], dst["errors"])
                if self.cutter.mismatch_action:
                    # mirror-created pairs gain the overlap frame too
                    # (modifiers.py:280-282) when no insert frame exists
                    frame_new = ok & ~has & ~info["frame"]
                    info["frame"] |= frame_new
                    info["frame_rstart"] = np.where(
                        frame_new, m1["rstart"], info["frame_rstart"]
                    )
        return m1, m2, info

    def _apply_mate(self, lane, tok, mate, ks, kp, wl, mate_idx):
        """_trim_mate per mate: trim window + adapter statistics
        (modifiers.py:292-314; Adapter._trimmed_back). ``wl`` is the
        mate's CURRENT length — possibly shortened by the correction
        stage's read1 truncation quirk."""
        present = mate["present"]
        self.cutter.with_adapters[mate_idx] += int(present.sum())
        trim = present & (mate["rstart"] < wl)
        if trim.any():
            adapter = lane.adapters[0]
            rstart = mate["rstart"][trim]
            removed = (wl[trim] - rstart).astype(np.int64)
            lane._bump_histograms(
                adapter.lengths_back, adapter.errors_back,
                removed, mate["errors"][trim],
            )
            rows = np.nonzero(trim)[0]
            prev = np.where(
                rstart > 0,
                tok.seqs[rows, np.maximum(rstart - 1, 0)],
                0,
            )
            for byte, cnt in zip(*np.unique(prev, return_counts=True)):
                base = chr(int(byte))
                if base not in "ACGT":
                    base = ""
                adapter.adjacent_bases[base] += int(cnt)
        return np.where(trim, ks + mate["rstart"], ks + wl).astype(np.int32)

    # -- overlap error correction (--correct-mismatches) ----------------------

    def _correct(self, tok1, tok2, wl1, wl2, sel, info):
        """Vectorized ErrorCorrectorMixin.correct_errors over the batch
        (truncate_seqs=True semantics; ref ``modifiers.py:201-357``,
        scalar twin ``modifiers/paired.py:40-191``). Corrected bytes are
        written back into the toks' host matrices (so neighbor stats and
        N-content filtering see them); per-mate (quals, changed) come
        back for alt-buffer output assembly. Returns
        (len1_eff, len2_eff, corr1 | None, corr2 | None) — len1_eff
        carries the reference's read1 tail-loss quirk."""
        batch = tok1.batch
        action = self.cutter.mismatch_action
        len_eff = np.minimum(wl1, wl2)

        # correction frames: selected insert match with mismatches, the
        # equal-rstart fallback frame, or the symmetric-mirror frame
        do = sel["has"] & (sel["cost"] > 0)
        frame = info["frame"]
        r1e = np.where(frame, info["frame_rstart"],
                       np.where(do, sel["r1e"], 0))
        r2s = np.where(frame, len_eff - wl2, 0)
        r2e = np.where(frame, info["frame_rstart"] - (wl2 - len_eff),
                       np.where(do, sel["r2e"], 0))
        do = do | frame
        span = np.where(do, np.minimum(r1e, r2e - r2s), 0)
        span = np.maximum(span, 0)
        cap = int(span.max()) if batch else 0
        if cap == 0:
            return wl1, wl2, None, None

        seq1 = tok1.seqs[:batch]
        seq2 = tok2.seqs[:batch]
        lane1, lane2 = self.lane1, self.lane2
        has_quals = bool(
            tok1.chunk.qual_len[tok1.sub].size
            and tok1.chunk.qual_len[tok1.sub].max(initial=0) > 0
            and tok2.chunk.qual_len[tok2.sub].max(initial=0) > 0
        )
        q1 = q2 = None
        if has_quals:
            q1 = lane1._gather(
                tok1.chunk, tok1.sub, tok1.chunk.qual_off,
                tok1.keep_start, tok1.width,
            )
            q2 = lane2._gather(
                tok2.chunk, tok2.sub, tok2.chunk.qual_off,
                tok2.keep_start, tok2.width,
            )
        elif action in ("liberal", "conservative"):
            raise ValueError(
                "Cannot perform quality-based error correction on reads "
                "lacking quality information"
            )

        k = np.arange(cap, dtype=np.int64)[None, :]
        valid = k < span[:, None]
        rows = np.arange(batch)[:, None]
        pos1 = np.broadcast_to(k, (batch, cap))
        pos2 = r2e[:, None] - 1 - k
        # scalar negative-index wrap on the (possibly truncated) mate2
        pos2 = np.where(pos2 < 0, pos2 + len_eff[:, None], pos2)
        pos1c = np.clip(pos1, 0, tok1.width - 1)
        pos2c = np.clip(pos2, 0, tok2.width - 1)
        comp = _complement_lut()
        b1 = seq1[rows, pos1c].copy()
        b2raw = seq2[rows, pos2c].copy()
        b2 = comp[b2raw]
        mismatch = valid & (b1 != b2)
        n_byte = np.uint8(ord("N"))

        def scatter(matrix, pos, mask, values):
            # masked flat scatter: rows beyond their span carry wrapped
            # positions that DUPLICATE real ones — an unmasked fancy
            # assignment would let those no-op writes land after (and
            # clobber) genuine corrections
            hit = np.nonzero(mask)
            matrix[hit[0], pos[hit]] = values[hit]

        if action == "N":
            scatter(seq1, pos1c, mismatch, np.broadcast_to(n_byte, b1.shape))
            scatter(seq2, pos2c, mismatch, np.broadcast_to(n_byte, b1.shape))
            changed1 = mismatch.sum(axis=1)
            changed2 = changed1.copy()
        else:
            q1v = q1[rows, pos1c].astype(np.int32)
            q2v = q2[rows, pos2c].astype(np.int32)
            fix1 = mismatch & (b1 == n_byte)
            fix2 = mismatch & ~fix1 & (b2 == n_byte)
            rest = mismatch & ~fix1 & ~fix2
            qdiff = q1v - q2v
            take1 = rest & (qdiff >= self.cutter.r1r2_min_qual_difference)
            take2 = rest & (qdiff <= self.cutter.r2r1_min_qual_difference)
            fix2 = fix2 | take1
            fix1 = fix1 | take2
            scatter(seq1, pos1c, fix1, b2)
            scatter(seq2, pos2c, fix2, comp[b1])
            scatter(q1, pos1c, fix1, q2v.astype(np.uint8))
            scatter(q2, pos2c, fix2, q1v.astype(np.uint8))
            changed1 = fix1.sum(axis=1)
            changed2 = fix2.sum(axis=1)
            if action == "liberal":
                deferred = rest & ~take1 & ~take2
                def_rows = deferred.any(axis=1)
                if def_rows.any():
                    # tie-break by mean overlap-window quality, computed
                    # AFTER the per-base fixes (reference evaluation order)
                    idx1w = np.arange(tok1.width, dtype=np.int64)[None, :]
                    w1 = idx1w < r1e[:, None]
                    sum1 = (q1[:batch].astype(np.int64) * w1).sum(axis=1)
                    start2 = np.where(r2s < 0, len_eff + r2s, r2s)
                    start2 = np.maximum(start2, 0)
                    stop2 = np.clip(r2e, 0, len_eff)
                    idx2w = np.arange(tok2.width, dtype=np.int64)[None, :]
                    w2 = (idx2w >= start2[:, None]) & (idx2w < stop2[:, None])
                    sum2 = (q2[:batch].astype(np.int64) * w2).sum(axis=1)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        mean1 = sum1 / np.maximum(r1e, 1)
                        mean2 = sum2 / np.maximum(stop2 - start2, 1)
                    gap = mean1 - mean2
                    ovr2 = deferred & (gap > 1)[:, None]
                    ovr1 = deferred & (gap < -1)[:, None]
                    if ovr2.any():
                        # the reference writes the ORIGINAL captured
                        # bases, not the post-fix state (paired.py:150-153)
                        scatter(seq2, pos2c, ovr2, comp[b1])
                        scatter(q2, pos2c, ovr2, q1v.astype(np.uint8))
                        changed2 = changed2 + ovr2.sum(axis=1)
                    if ovr1.any():
                        scatter(seq1, pos1c, ovr1, b2)
                        scatter(q1, pos1c, ovr1, q2v.astype(np.uint8))
                        changed1 = changed1 + ovr1.sum(axis=1)

        r1_changed = changed1 > 0
        r2_changed = changed2 > 0
        any_changed = r1_changed | r2_changed
        self.cutter.corrected_pairs += int(any_changed.sum())
        self.cutter.corrected_bp[0] += int(changed1.sum())
        self.cutter.corrected_bp[1] += int(changed2.sum())
        # truncate_seqs quirk: a CHANGED read1 longer than read2 loses
        # its tail (only the read2 truncation keeps it; paired.py:74-87)
        len1_eff = np.where(r1_changed & (wl1 > wl2), wl2, wl1)
        corr1 = (tok1, q1, r1_changed) if r1_changed.any() else None
        corr2 = (tok2, q2, r2_changed) if r2_changed.any() else None
        return len1_eff, wl2, corr1, corr2

    @staticmethod
    def _build_alt(corr, ks, kp):
        """Patch-buffer output data for the corrected records: the final
        (post-trim) seq/qual windows of every changed record, densely
        packed ([seqs...][quals...]); -1 offsets mean 'unchanged, use the
        chunk buffer'."""
        tok, quals, changed = corr
        if not changed.any():
            return None
        batch = tok.batch
        final_len = (kp - ks).astype(np.int64)
        seq_beg = np.full(batch, -1, np.int64)
        seq_end = np.full(batch, -1, np.int64)
        qual_beg = np.full(batch, -1, np.int64)
        rows = np.nonzero(changed)[0]
        lens = final_len[rows]
        offs = np.cumsum(lens) - lens
        total = int(lens.sum())
        seq_beg[rows] = offs
        seq_end[rows] = offs + lens
        qual_beg[rows] = offs + total
        buf = np.empty(2 * total, np.uint8)
        # vectorized ranges-copy out of the row-major matrices
        width = tok.width
        flat_pos = (
            np.repeat(rows * width, lens)
            + (np.arange(total) - np.repeat(offs, lens))
        )
        buf[:total] = tok.seqs[:batch].reshape(-1)[flat_pos]
        buf[total:] = (
            quals[:batch].reshape(-1)[flat_pos]
            if quals is not None
            else 0
        )
        return buf, seq_beg, seq_end, qual_beg


def _gather_name_bytes(chunk, sub, width):
    from atropos_tpu.runtime import _i32, _i64, _lib, _u8

    offs = np.ascontiguousarray(chunk.name_off[sub], np.int64)
    lens = np.ascontiguousarray(chunk.name_len[sub], np.int32)
    out = np.zeros((offs.shape[0], width), np.uint8)
    _lib.gather_padded(
        _u8(chunk.buf), _i64(offs), _i32(lens),
        offs.shape[0], width, _u8(out),
    )
    return out, lens


def validate_pair_names(chunk1, sub1, chunk2, sub2, interleaved=False):
    """Vectorized twin of ``seqio.sequence_names_match`` over whole
    record ranges: first whitespace-delimited token, ignoring a trailing
    1/2 mate digit; raises the scalar reader's FormatError on the first
    improperly-paired record."""
    from atropos_tpu.io.seqio import FormatError

    width = int(
        max(
            chunk1.name_len[sub1].max(initial=1),
            chunk2.name_len[sub2].max(initial=1),
        )
    )
    a1, len1 = _gather_name_bytes(chunk1, sub1, width)
    a2, len2 = _gather_name_bytes(chunk2, sub2, width)
    idx = np.arange(width, dtype=np.int32)[None, :]

    def token_len(arr, lens):
        ws = ((arr == 32) | (arr == 9)) & (idx < lens[:, None])
        has = ws.any(axis=1)
        first = np.where(has, ws.argmax(axis=1), lens)
        return first.astype(np.int32)

    t1 = token_len(a1, len1)
    t2 = token_len(a2, len2)
    diff = a1 != a2
    has_diff = diff.any(axis=1)
    mismatch_at = np.where(has_diff, diff.argmax(axis=1), width)
    ok_full = (t1 == t2) & (mismatch_at >= t1)
    last1 = a1[np.arange(a1.shape[0]), np.maximum(t1 - 1, 0)]
    last2 = a2[np.arange(a2.shape[0]), np.maximum(t2 - 1, 0)]
    both_12 = (
        (t1 > 0) & (t2 > 0)
        & ((last1 == ord("1")) | (last1 == ord("2")))
        & ((last2 == ord("1")) | (last2 == ord("2")))
    )
    ok_strip = both_12 & (t1 == t2) & (mismatch_at >= t1 - 1)
    bad = ~(ok_full | ok_strip)
    if bad.any():
        row = int(np.nonzero(bad)[0][0])
        name1 = a1[row, : len1[row]].tobytes().decode("latin-1")
        name2 = a2[row, : len2[row]].tobytes().decode("latin-1")
        if interleaved:
            raise FormatError(
                "Reads are improperly paired. Name {0!r} (first) does "
                "not match {1!r} (second).".format(name1, name2)
            )
        raise FormatError(
            "Reads are improperly paired. Read name '{0}' in file 1 "
            "does not match '{1}' in file 2.".format(name1, name2)
        )


def _record_byte_lengths(chunk, sub, keep_start, keep_stop, keep, fmt,
                         alt=None):
    """Per-record output byte length for the KEPT records, matching the
    native formatters' layout exactly (alt-patched records use the
    patch-window lengths)."""
    name_len = chunk.name_len[sub][keep].astype(np.int64)
    klen = np.maximum(keep_stop - keep_start, 0)[keep].astype(np.int64)
    plus_len = chunk.plus_len[sub][keep].astype(np.int64)
    if alt is not None:
        alt_sb, alt_se = alt[1], alt[2]
        patched = alt_sb[keep] >= 0
        klen = np.where(patched, (alt_se - alt_sb)[keep], klen)
        if len(alt) > 4:
            _, _, _, _, alt_nb, alt_nl, _, alt_pl = alt
            renamed = alt_nb[keep] >= 0
            name_len = np.where(renamed, alt_nl[keep], name_len)
            plus_len = np.where(renamed, alt_pl[keep], plus_len)
    if fmt == "fasta":
        return 2 + name_len + klen + 1
    return 4 + name_len + 2 * klen + plus_len + 2


def _interleave_records(parts1, parts2):
    """Merge two formatted byte streams record-alternately: (bytes,
    per-record lengths) per mate in, interleaved bytes out (one ranges
    gather, no per-record Python)."""
    (b1, l1), (b2, l2) = parts1, parts2
    count = l1.shape[0]
    if count == 0:
        return b""
    src = np.frombuffer(b1 + b2, np.uint8)
    starts = np.empty(2 * count, np.int64)
    starts[0::2] = np.cumsum(l1) - l1
    starts[1::2] = len(b1) + np.cumsum(l2) - l2
    sizes = np.empty(2 * count, np.int64)
    sizes[0::2] = l1
    sizes[1::2] = l2
    total = int(sizes.sum())
    pos = np.repeat(np.cumsum(sizes) - sizes, sizes)
    idx = np.arange(total, dtype=np.int64) - pos + np.repeat(starts, sizes)
    return src[idx].tobytes()


def _format_records(chunk, sub, keep_start, keep_stop, keep, fmt="fastq",
                    alt=None):
    """Native formatter: trimmed FASTQ/FASTA bytes for the kept records.
    ``alt`` = (buf, seq_beg, seq_end, qual_beg[, name_beg, name_len,
    plus_beg, plus_len]) supplies replacement bytes for records whose
    content changed (overlap error correction; the name/plus lanes for
    mate overwrite, which swaps in the partner's whole record)."""
    from atropos_tpu.runtime import _i32, _i64, _lib, _u8

    name_off = np.ascontiguousarray(chunk.name_off[sub])
    name_len = np.ascontiguousarray(chunk.name_len[sub])
    seq_off = np.ascontiguousarray(chunk.seq_off[sub])
    ks = np.ascontiguousarray(keep_start, np.int32)
    kp = np.ascontiguousarray(keep_stop, np.int32)
    kmask = np.ascontiguousarray(keep.astype(np.uint8))
    kept_bp = int(np.maximum(kp - ks, 0)[keep].sum())
    if alt is not None:
        alt_buf, alt_sb, alt_se, alt_qb = alt[:4]
        kept_bp += int(np.maximum(alt_se - alt_sb, 0)[keep].sum())
    if fmt == "fasta":
        cap = int(name_len.sum()) + kept_bp + name_off.shape[0] * 4 + 16
        out = np.empty(cap, dtype=np.uint8)
        written = _lib.fasta_format_trimmed(
            _u8(chunk.buf),
            _i64(name_off), _i32(name_len), _i64(seq_off),
            _i32(ks), _i32(kp), _u8(kmask),
            name_off.shape[0],
            _u8(out), cap,
        )
    else:
        plus_off = np.ascontiguousarray(chunk.plus_off[sub])
        plus_len = np.ascontiguousarray(chunk.plus_len[sub])
        qual_off = np.ascontiguousarray(chunk.qual_off[sub])
        cap = int(
            name_len.sum() + plus_len.sum() + 2 * kept_bp
            + name_off.shape[0] * 8 + 16
        )
        if alt is not None and len(alt) > 4:
            cap += int(alt[5][keep].sum() + alt[7][keep].sum())
        out = np.empty(cap, dtype=np.uint8)
        if alt is None:
            alt_args = (None, None, None, None, None, None, None, None)
        else:
            alt_args = (
                _u8(alt_buf),
                _i64(np.ascontiguousarray(alt_sb, np.int64)),
                _i64(np.ascontiguousarray(alt_se, np.int64)),
                _i64(np.ascontiguousarray(alt_qb, np.int64)),
            )
            if len(alt) > 4:
                alt_args += (
                    _i64(np.ascontiguousarray(alt[4], np.int64)),
                    _i32(np.ascontiguousarray(alt[5], np.int32)),
                    _i64(np.ascontiguousarray(alt[6], np.int64)),
                    _i32(np.ascontiguousarray(alt[7], np.int32)),
                )
            else:
                alt_args += (None, None, None, None)
        written = _lib.fastq_format_trimmed(
            _u8(chunk.buf),
            _i64(name_off), _i32(name_len),
            _i64(seq_off),
            _i64(plus_off), _i32(plus_len),
            _i64(qual_off),
            _i32(ks), _i32(kp), _u8(kmask),
            name_off.shape[0],
            _u8(out), cap,
            *alt_args,
        )
    if written < 0:
        raise RuntimeError("format capacity exceeded")
    return out[:written].tobytes()


class _AsyncWriter:
    """Single background writer thread: output bytes are enqueued in
    resolution order (one queue, one thread — per-file byte order is
    preserved) so disk/compression time overlaps device compute and
    link transfer. ``data`` may be a zero-arg callable producing the
    bytes — the native formatter then ALSO runs on this thread,
    overlapping record assembly (~24M reads/s/core, PERF.md) with the
    main thread's window resolution. Errors surface on the next enqueue
    or close."""

    def __init__(self):
        import queue
        import threading

        self._q = queue.Queue(maxsize=8)
        self._exc = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is None:
                handle, data = item
                try:
                    if callable(data):
                        data = data()
                    handle.write(data)
                except BaseException as exc:  # propagate to the producer
                    self._exc = exc

    def write(self, handle, data):
        if self._exc is not None:
            raise self._exc
        self._q.put((handle, data))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._exc is not None:
            raise self._exc


class _TurboRunnerBase:
    """Shared driver plumbing: eligibility helpers, output opening."""

    CHUNK_BYTES = 64 * 1024 * 1024
    MAX_BATCH = _env_int("ATROPOS_TPU_TURBO_BATCH", 32768)
    DEPTH = _env_int("ATROPOS_TPU_TURBO_DEPTH", 3)

    @staticmethod
    def _decline(reason):
        logging.getLogger().info("turbo path declined: %s", reason)
        return None

    @classmethod
    def _unwrap_handler(cls, record_handler):
        """(inner RecordHandler, stats wrapper | None), or a decline-reason
        string. ``--stats`` runs through turbo: pre/post ReadStatistics
        collect straight from the gathered matrices (only per-tile stats,
        which need per-record name parsing, stay scalar)."""
        from atropos_tpu.commands.trim import RecordHandler
        from atropos_tpu.commands.trim.pipeline import (
            StatsRecordHandlerWrapper,
        )

        if isinstance(record_handler, StatsRecordHandlerWrapper):
            inner = record_handler.record_handler
            if not isinstance(inner, RecordHandler):
                return "non-default record handler"
            for kw_name in ("pre_kwargs", "post_kwargs"):
                kwargs = getattr(record_handler, kw_name, None)
                if kwargs and kwargs.get("tiles"):
                    return "per-tile statistics"
            return inner, record_handler
        if isinstance(record_handler, RecordHandler):
            return record_handler, None
        return "non-default record handler"

    @classmethod
    def _check_common(cls, command_runner, record_handler):
        """Shared eligibility gates; returns a decline reason or None."""
        options = command_runner.options
        if not runtime.available():
            return "native runtime unavailable"
        if options.colorspace:
            return "colorspace input"
        if options.action != "trim" or options.times != 1:
            return "action!=trim or times>1"
        if options.merged_output:
            return "merged output"
        if options.subsample:
            return "subsample"
        for ftype in record_handler.filters.filters:
            if ftype not in (
                TooShortReadFilter,
                TooLongReadFilter,
                NContentFilter,
                TrimmedFilter,
                UntrimmedFilter,
            ):
                return "unsupported filter %s" % ftype.__name__
        return None

    @staticmethod
    def _stream_format(path, explicit=None):
        """The chunk-stream format ('fastq' or 'fasta') for a path, or
        None when the path is unusable (stdin/stdout, a demultiplex
        template, or an unrecognized extension). ``explicit`` carries the
        CLI ``--format`` override for inputs."""
        from atropos_tpu.io.seqio import guess_format_from_name

        if not path or not isinstance(path, str) or path == "-":
            return None
        if "{name}" in path:
            return None
        fmt = explicit or guess_format_from_name(path)
        return fmt if fmt in ("fastq", "fasta") else None

    @classmethod
    def _collect_output_formats(cls, formatters, allow_interleaved=False):
        """{path: format} for every destination formatter (main output
        plus untrimmed / too-short / too-long files), or a decline-reason
        string. The format comes from the formatter the builder already
        constructed (so extension-less paths like /dev/null work exactly
        like the scalar writers). Also rejects one path serving different
        mate roles (per-batch grouped writes could not reproduce the
        scalar byte interleaving then); interleaved formatters (both
        mates, one file, record-alternating) are tracked by role 3."""
        from atropos_tpu.io.seqio import (
            FastaFormat,
            FastqFormat,
            InterleavedFormatter,
        )

        fmts = {}
        role_of = {}
        for formatter in formatters.seq_formatters.values():
            fmt_obj = formatter.seq_format
            if type(fmt_obj) is FastqFormat:
                fmt = "fastq"
            elif (
                type(fmt_obj) is FastaFormat
                and fmt_obj.text_wrapper is None
            ):
                fmt = "fasta"
            else:
                return "unsupported output format"
            if isinstance(formatter, InterleavedFormatter):
                if not allow_interleaved:
                    return "interleaved output"
                roles = [(formatter.file1, 3)]
            else:
                roles = [(formatter.file1, 1)]
                file2 = getattr(formatter, "file2", None)
                if file2 is not None:
                    roles.append((file2, 2))
            for path, role in roles:
                if not path or not isinstance(path, str) or path == "-":
                    return "stdout/non-path output"
                fmts[path] = fmt
                if path != os.devnull and (
                    role_of.setdefault(path, role) != role
                ):
                    return "one path used for both mates"
        return fmts

    def _fmt_of(self, path):
        """Output format for a destination path (lazily resolved for
        demultiplex expansions)."""
        fmt = self._out_fmts.get(path)
        if fmt is None:
            fmt = self._stream_format(path)
            self._out_fmts[path] = fmt
        return fmt

    @staticmethod
    def _start_profile():
        """Optional JAX profiler trace around the turbo run (SURVEY §5
        tracing rebuild note): ``ATROPOS_TPU_PROFILE=<dir>`` captures a
        device+host trace viewable in TensorBoard/Perfetto."""
        trace_dir = os.environ.get("ATROPOS_TPU_PROFILE")
        if not trace_dir:
            return False
        import jax

        jax.profiler.start_trace(trace_dir)
        return True

    @staticmethod
    def _stop_profile(started):
        if started:
            import jax

            jax.profiler.stop_trace()

    def _open_output(self, path):
        """Binary output handle (bytes from the native formatter go
        straight through — no text-codec round trip). Honors the Writers
        shard suffix (multi-host mode) and registers with the container so
        close/force-create bookkeeping stays unified."""
        from atropos_tpu.commands.trim.writers import add_suffix_to_path
        from atropos_tpu.io import xopen

        handle = self.writers.writers.get(path)
        if handle is None:
            physical = (
                add_suffix_to_path(path, self.writers.suffix)
                if self.writers.suffix
                else path
            )
            handle = xopen(physical, "wb")
            self.writers.writers[path] = handle
        return handle

    def _update_counts(self, total_records, bp_counts):
        summary = self.command_runner.summary
        if total_records:
            summary.update(
                record_counts={0: total_records},
                total_record_count=total_records,
                bp_counts={0: list(bp_counts)},
                total_bp_counts=tuple(bp_counts),
                sum_total_bp_count=sum(bp_counts),
            )
        else:
            # empty input: match the scalar batcher, which never emits a
            # batch and leaves the count structures empty
            summary.update(
                record_counts={},
                total_record_count=0,
                bp_counts={},
                total_bp_counts=(),
                sum_total_bp_count=0,
            )
        handler = self.stats if self.stats is not None else self.record_handler
        summary.update(handler.summarize())

    # -- side files (info/rest/wildcard) --------------------------------------

    def _emit_side_files(self, mates):
        """Write the configured side files (``--info-file``/``-r``/
        ``--wildcard-file``) for one batch: per-record rows assembled
        from the chunk buffer + stashed match data, byte-identical to
        the scalar DelimFormatters (``writers.py:146-199``). Per-record
        Python here is fine — side-file configs are inspection runs and
        the main trim path stays fully vectorized."""
        from atropos_tpu.commands.trim.writers import (
            InfoFormatter,
            RestFormatter,
            WildcardFormatter,
        )

        side = self.record_handler.formatters.info_formatters
        if not side:
            return
        views = [self._side_view(lane, tok) for lane, tok in mates]
        batch = mates[0][1].batch
        rows_of = {
            InfoFormatter: self._info_rows,
            RestFormatter: self._rest_rows,
            WildcardFormatter: self._wildcard_rows,
        }
        for formatter in side:
            builder = rows_of[type(formatter)]
            delim = formatter.delim
            lines = []
            for i in range(batch):
                for view in views:
                    for fields in builder(view, i):
                        lines.append(
                            delim.join(str(f) for f in fields) + "\n"
                        )
            if lines:
                self._writer.write(
                    self._open_output(formatter.path),
                    "".join(lines).encode("latin-1"),
                )

    @staticmethod
    def _side_view(lane, tok):
        """Per-record strings for side-file assembly: full header names
        plus the pre-adapter window's sequence/quality slices (the read
        state AT MATCH TIME, which MatchInfo snapshots)."""
        chunk, sub = tok.chunk, tok.sub
        batch = tok.batch
        buf = chunk.buf
        name_off = chunk.name_off[sub]
        name_len = chunk.name_len[sub]
        seq_off = chunk.seq_off[sub]
        qual_off = chunk.qual_off[sub]
        qual_len = chunk.qual_len[sub]
        ws = tok.win_start if tok.win_start is not None else tok.keep_start
        wp = tok.win_stop if tok.win_stop is not None else tok.keep_stop

        def text(off, start, stop):
            return bytes(buf[off + start : off + stop]).decode("latin-1")

        names = [
            text(name_off[i], 0, name_len[i]) for i in range(batch)
        ]
        seqs = [
            text(seq_off[i], ws[i], wp[i]) for i in range(batch)
        ]
        quals = [
            text(qual_off[i], ws[i], wp[i]) if qual_len[i] else ""
            for i in range(batch)
        ]
        return dict(
            names=names, seqs=seqs, quals=quals,
            md=tok.match_data, adapters=lane.adapters,
        )

    @staticmethod
    def _info_rows(view, i):
        md = view["md"]
        if md is not None and md["matched"][i]:
            seq = view["seqs"][i]
            qual = view["quals"][i]
            rstart = int(md["rstart"][i])
            rstop = int(md["rstop"][i])
            adapter = view["adapters"][int(md["best_idx"][i])]
            yield (
                view["names"][i], int(md["errors"][i]), rstart, rstop,
                seq[:rstart], seq[rstart:rstop], seq[rstop:],
                adapter.name,
                qual[:rstart], qual[rstart:rstop], qual[rstop:],
            )
        else:
            yield (view["names"][i], -1, view["seqs"][i], view["quals"][i])

    @staticmethod
    def _rest_rows(view, i):
        md = view["md"]
        if md is not None and md["matched"][i]:
            seq = view["seqs"][i]
            if md["front"][i]:
                rest = seq[: int(md["rstart"][i])]
            else:
                rest = seq[int(md["rstop"][i]) :]
            if rest:
                yield (rest, view["names"][i])

    @staticmethod
    def _wildcard_rows(view, i):
        md = view["md"]
        if md is not None and md["matched"][i]:
            seq = view["seqs"][i]
            adapter = view["adapters"][int(md["best_idx"][i])]
            astart = int(md["astart"][i])
            rstart = int(md["rstart"][i])
            length = int(md["astop"][i]) - astart
            wildcards = "".join(
                seq[rstart + j]
                for j in range(length)
                if adapter.sequence[astart + j] == "N"
                and rstart + j < len(seq)
            )
            yield (wildcards, view["names"][i])

    # -- --stats collection (pre/post ReadStatistics from matrices) -----------

    @staticmethod
    def _stats_obj(table, stats_class, kwargs):
        if 0 not in table:
            table[0] = stats_class(**kwargs)
        return table[0]

    @staticmethod
    def _stats_parts(obj, n_mates):
        return [obj] if n_mates == 1 else [obj.read1, obj.read2]

    def _collect_turbo_stats(self, mates, dest_masks):
        """Feed pre/post ReadStatistics straight from gathered matrices.

        ``mates``: one (lane, tok, final_start, final_stop) per mate.
        ``dest_masks``: [(filter type, row mask)] in routing order,
        including the kept rows under NoFilter — exactly the scalar
        wrapper's per-destination post tables.
        """
        stats = self.stats
        if stats.pre is not None:
            obj = self._stats_obj(
                stats.pre, stats.read_statistics_class, stats.pre_kwargs
            )
            for part, (lane, tok, _, _) in zip(
                self._stats_parts(obj, len(mates)), mates
            ):
                zero = np.zeros(tok.batch, np.int32)
                seqs = lane._gather(
                    tok.chunk, tok.sub, tok.chunk.seq_off, zero, tok.width
                )
                quals = lane._gather(
                    tok.chunk, tok.sub, tok.chunk.qual_off, zero, tok.width
                )
                part.collect_matrices(seqs, quals, tok.n)
        if stats.post is not None:
            gathered = []
            for lane, tok, start, stop in mates:
                seqs = lane._gather(
                    tok.chunk, tok.sub, tok.chunk.seq_off, start, tok.width
                )
                quals = lane._gather(
                    tok.chunk, tok.sub, tok.chunk.qual_off, start, tok.width
                )
                gathered.append((seqs, quals, stop - start))
            for ftype, mask in dest_masks:
                if not mask.any():
                    continue
                table = stats.post.setdefault(ftype, {})
                obj = self._stats_obj(
                    table, stats.read_statistics_class, stats.post_kwargs
                )
                for part, (seqs, quals, lens) in zip(
                    self._stats_parts(obj, len(mates)), gathered
                ):
                    part.collect_matrices(
                        seqs[mask], quals[mask], lens[mask]
                    )


class TurboTrimRunner(_TurboRunnerBase):
    """Streaming interval-based trim for eligible single-end configs."""

    @classmethod
    def build(cls, command_runner, record_handler, writers):
        """Return a runner if the configuration is turbo-eligible."""
        options = command_runner.options
        if options.paired:
            return cls._decline("paired input")
        unwrapped = cls._unwrap_handler(record_handler)
        if isinstance(unwrapped, str):
            return cls._decline(unwrapped)
        inner, stats = unwrapped
        reason = cls._check_common(command_runner, inner)
        if reason:
            return cls._decline(reason)
        input1 = options.input1
        if not input1 or not isinstance(input1, str):
            return cls._decline("non-path input")
        if options.input2 or options.interleaved_input:
            return cls._decline("paired input")
        in_fmt = cls._stream_format(input1, options.format)
        if in_fmt is None:
            return cls._decline("unsupported input format")
        output = options.output
        if output and isinstance(output, str) and "{name}" in output:
            # demultiplexing: every {name} expansion must be a plain
            # stream path (routing happens per-adapter in the resolver)
            if cls._stream_format(output.replace("{name}", "x")) is None:
                return cls._decline("unsupported demultiplex template")
        out_fmts = cls._collect_output_formats(inner.formatters)
        if isinstance(out_fmts, str):
            return cls._decline(out_fmts)

        mods = [
            entry[0] if isinstance(entry, list) else entry
            for entry in inner.modifiers.modifiers
        ]
        lane = _MateLane.from_modifier_list(mods)
        if isinstance(lane, str):
            return cls._decline(lane)
        if in_fmt == "fasta":
            if lane._needs_quals:
                return cls._decline("quality stage without qualities")
            if stats is not None:
                return cls._decline("--stats on quality-less input")
        return cls(command_runner, inner, writers, lane, stats, in_fmt,
                   out_fmts)

    def __init__(self, command_runner, record_handler, writers, lane,
                 stats=None, in_fmt="fastq", out_fmts=None):
        self.command_runner = command_runner
        self.options = command_runner.options
        self.record_handler = record_handler
        self.writers = writers
        self.lane = lane
        self.stats = stats
        self._in_fmt = in_fmt
        self._out_fmts = dict(out_fmts or {})

    # -- main loop ------------------------------------------------------------

    def run(self):
        options = self.options
        logging.getLogger().info("Running turbo device trim pipeline")
        out = self._open_output(options.output)

        total_records = 0
        total_bp = 0
        inflight = collections.deque()
        # multi-host sharding: chunk boundaries are deterministic (same
        # file, same chunking), so round-robin chunk ownership partitions
        # the records exactly once across hosts
        shard_rank = getattr(self.command_runner, "shard_rank", 0)
        shard_count = getattr(self.command_runner, "shard_count", 1)
        chunk_index = 0
        # --max-reads caps the GLOBAL record stream (scalar batcher
        # semantics: the first N records of the input)
        from atropos_tpu.commands.cli import int_or_str

        quota = int_or_str(options.max_reads) or None
        seen = 0
        stream = _maybe_prefetch(
            _ChunkStream(options.input1, self.CHUNK_BYTES, self._in_fmt)
        )
        self._writer = _AsyncWriter()
        profiling = self._start_profile()
        try:
            while True:
                chunk = stream.next_chunk()
                if chunk is None:
                    break
                avail = chunk.n
                if quota is not None:
                    avail = min(avail, quota - seen)
                    if avail <= 0:
                        break
                seen += avail
                if chunk_index % shard_count == shard_rank:
                    total_records += avail
                    total_bp += int(chunk.seq_len[:avail].sum())
                    for start in range(0, avail, self.MAX_BATCH):
                        sub = slice(
                            start, min(start + self.MAX_BATCH, avail)
                        )
                        inflight.append(self.lane.submit(chunk, sub))
                        while len(inflight) >= self.DEPTH:
                            self._resolve(inflight.popleft())
                chunk_index += 1
        finally:
            stream.close()
        while inflight:
            self._resolve(inflight.popleft())
        self._writer.close()
        self._stop_profile(profiling)

        self._update_counts(total_records, (total_bp, 0))
        out.flush()
        self.writers.close()
        return 0

    # -- resolve: windows -> filters -> formatter -----------------------------

    def _resolve(self, tok):
        keep_start, keep_stop, matched = self.lane.resolve_windows(tok)
        keep_start, keep_stop = self.lane.apply_post(
            tok, keep_start, keep_stop, matched
        )
        final_len = keep_stop - keep_start

        # filters, in registration order (first match wins)
        dest_none = np.ones(tok.batch, bool)
        dest_masks = []
        for ftype, wrapper in self.record_handler.filters.filters.items():
            hit = dest_none & self.lane.criterion_hits(
                ftype, wrapper, tok, keep_start, keep_stop, matched
            )
            wrapper.filtered += int(hit.sum())
            dest_none &= ~hit
            dest_masks.append((ftype, hit))

        keep = dest_none
        if self.stats is not None:
            self._collect_turbo_stats(
                [(self.lane, tok, keep_start, keep_stop)],
                dest_masks + [(NoFilter, keep)],
            )
        # per-destination routing: each dest with a formatter writes its
        # rows to that formatter's file (several dests may share a file —
        # the union mask preserves the scalar per-record byte order);
        # dests without a formatter are discarded
        formatters = self.record_handler.formatters
        path_masks = {}

        def route(formatter, mask, count):
            formatter.written += count
            formatter.read1_bp += int(final_len[mask].sum())
            if count:
                prev = path_masks.get(formatter.file1)
                path_masks[formatter.file1] = (
                    mask if prev is None else (prev | mask)
                )

        for ftype, mask in dest_masks + [(NoFilter, keep)]:
            if formatters.multiplexed and ftype is NoFilter:
                # demultiplex: kept matched reads route to the {name}
                # expansion of their adapter; unmatched fall through to
                # the NoFilter ('unknown') formatter below
                best_idx = tok.match_data["best_idx"]
                mux = mask & matched
                for adapter_idx, adapter in enumerate(self.lane.adapters):
                    sub_mask = mux & (best_idx == adapter_idx)
                    count = int(sub_mask.sum())
                    if count:
                        route(
                            formatters.get_mux_formatter(adapter.name),
                            sub_mask, count,
                        )
                mask = mask & ~matched
            formatter = formatters.seq_formatters.get(ftype)
            count = int(mask.sum())
            if formatter is None:
                formatters.discarded += count
                continue
            route(formatter, mask, count)
        from functools import partial

        for path, mask in path_masks.items():
            self._writer.write(
                self._open_output(path),
                partial(
                    _format_records,
                    tok.chunk, tok.sub, keep_start, keep_stop, mask,
                    fmt=self._fmt_of(path),
                ),
            )
        self._emit_side_files([(self.lane, tok)])


class TurboPairedRunner(_TurboRunnerBase):
    """Streaming interval-based trim for eligible paired-end configs:
    two :class:`_MateLane`s fed by two synchronized chunk streams,
    vectorized pair filters, two outputs.

    Covers BOTH aligners: independent per-mate adapter matching, and
    insert-align (``--aligner insert``) via :class:`_InsertPair` (one
    fused device step per batch). Insert configs with
    ``--correct-mismatches`` decline and run through the batched engine.
    """

    @classmethod
    def build(cls, command_runner, record_handler, writers):
        options = command_runner.options
        if not options.paired:
            return cls._decline("single-end input")
        unwrapped = cls._unwrap_handler(record_handler)
        if isinstance(unwrapped, str):
            return cls._decline(unwrapped)
        inner, stats = unwrapped
        record_handler = inner
        reason = cls._check_common(command_runner, record_handler)
        if reason:
            return cls._decline(reason)
        if options.interleaved_input:
            if not isinstance(options.interleaved_input, str):
                return cls._decline("non-path interleaved input")
            in_fmt1 = in_fmt2 = cls._stream_format(
                options.interleaved_input, options.format
            )
            if in_fmt1 is None:
                return cls._decline("unsupported interleaved input format")
        else:
            input1, input2 = options.input1, options.input2
            if (
                not input1 or not input2
                or not isinstance(input1, str) or not isinstance(input2, str)
            ):
                return cls._decline("non-path paired input")
            in_fmt1 = cls._stream_format(input1, options.format)
            in_fmt2 = cls._stream_format(input2, options.format)
            if in_fmt1 is None or in_fmt2 is None:
                return cls._decline("unsupported paired input format")
        out_fmts = cls._collect_output_formats(
            record_handler.formatters, allow_interleaved=True
        )
        if isinstance(out_fmts, str):
            return cls._decline(out_fmts)

        from atropos_tpu.commands.trim.modifiers import OverwriteRead

        mods1, mods2 = [], []
        insert_cutter = None
        overwrite = None
        for pos, entry in enumerate(record_handler.modifiers.modifiers):
            if isinstance(entry, InsertAdapterCutter):
                if insert_cutter is not None:
                    return cls._decline("multiple insert cutters")
                insert_cutter = entry
                continue
            if isinstance(entry, OverwriteRead):
                # -w: whole-read replacement by the partner's reverse
                # complement. Two supported chain positions: FIRST
                # (cutadapt-compat op-order 'WCGQA' — a vectorized
                # pre-pass patches the lanes' inputs) and LAST (the
                # default 'CGQAW' — a resolve-time swap on the trimmed
                # windows). Mid-chain W would interleave with per-mate
                # stages on both sides; no conformance surface needs it.
                if overwrite is not None:
                    return cls._decline("multiple overwrite stages")
                overwrite = entry
                overwrite_pos = pos
                continue
            if isinstance(entry, ReadPairModifier):
                # merge: engine or scalar path
                return cls._decline(
                    "pair modifier %s" % type(entry).__name__
                )
            if entry[0] is not None:
                mods1.append(entry[0])
            if entry[1] is not None:
                mods2.append(entry[1])
        overwrite_mode = None
        if overwrite is not None:
            n_entries = len(record_handler.modifiers.modifiers)
            if overwrite_pos == 0:
                overwrite_mode = "pre"
            elif overwrite_pos == n_entries - 1:
                overwrite_mode = "post"
            else:
                return cls._decline("overwrite mid-chain")
            if insert_cutter is not None:
                return cls._decline("overwrite with insert aligner")
            if stats is not None:
                return cls._decline("--stats with overwrite")
            if record_handler.formatters.info_formatters:
                return cls._decline("side files with overwrite")
            if "fasta" in (in_fmt1, in_fmt2):
                return cls._decline("overwrite without qualities")
        insert_pair = None
        if insert_cutter is not None:
            lane1 = _MateLane.from_modifier_list(
                mods1, insert_adapter=insert_cutter.adapter1, insert_role=1
            )
            if isinstance(lane1, str):
                return cls._decline(lane1)
            lane2 = _MateLane.from_modifier_list(
                mods2, insert_adapter=insert_cutter.adapter2, insert_role=2
            )
            if isinstance(lane2, str):
                return cls._decline(lane2)
            insert_pair = _InsertPair(lane1, lane2, insert_cutter)
        else:
            lane1 = _MateLane.from_modifier_list(mods1)
            if isinstance(lane1, str):
                return cls._decline(lane1)
            lane2 = _MateLane.from_modifier_list(mods2)
            if isinstance(lane2, str):
                return cls._decline(lane2)
        if "fasta" in (in_fmt1, in_fmt2):
            if lane1._needs_quals or lane2._needs_quals:
                return cls._decline("quality stage without qualities")
            if stats is not None:
                return cls._decline("--stats on quality-less input")
        if insert_pair is not None and insert_cutter.mismatch_action:
            # correction rewrites record bytes: paths that snapshot them
            # from the chunk buffer cannot be served from intervals
            if "fasta" in (in_fmt1, in_fmt2):
                return cls._decline("insert correction without qualities")
            if stats is not None:
                return cls._decline("--stats with insert correction")
            if record_handler.formatters.info_formatters:
                return cls._decline("side files with insert correction")
        return cls(
            command_runner, record_handler, writers, lane1, lane2, stats,
            insert_pair, (in_fmt1, in_fmt2), out_fmts, overwrite,
            overwrite_mode,
        )

    def __init__(self, command_runner, record_handler, writers, lane1, lane2,
                 stats=None, insert_pair=None, in_fmts=("fastq", "fastq"),
                 out_fmts=None, overwrite=None, overwrite_mode=None):
        self.command_runner = command_runner
        self.options = command_runner.options
        self.record_handler = record_handler
        self.writers = writers
        self.lane1 = lane1
        self.lane2 = lane2
        self.stats = stats
        self.insert_pair = insert_pair
        self.overwrite = overwrite
        self._ow_mode = overwrite_mode
        self._in_fmts = in_fmts
        self._out_fmts = dict(out_fmts or {})

    # -- main loop ------------------------------------------------------------

    def run(self):
        options = self.options
        logging.getLogger().info("Running turbo paired device trim pipeline")
        if options.interleaved_output:
            self._open_output(options.interleaved_output)
        else:
            self._open_output(options.output)
            self._open_output(options.paired_output)

        self._total_pairs = 0
        self._bp = [0, 0]
        self._inflight = collections.deque()
        self._shard_rank = getattr(self.command_runner, "shard_rank", 0)
        self._shard_count = getattr(self.command_runner, "shard_count", 1)
        self._batch_index = 0
        self._writer = _AsyncWriter()
        profiling = self._start_profile()
        from atropos_tpu.commands.cli import int_or_str

        quota = int_or_str(options.max_reads) or None
        if options.interleaved_input:
            self._pump_interleaved(quota)
        else:
            self._pump_two_files(quota)
        while self._inflight:
            self._resolve_item(self._inflight.popleft())
        self._writer.close()
        self._stop_profile(profiling)

        self._update_counts(self._total_pairs, tuple(self._bp))
        self.writers.close()
        return 0

    def _submit_pair(self, chunk1, sub1, chunk2, sub2):
        """Submit one pair batch if this shard owns it; drain the
        pipeline window."""
        owned = self._batch_index % self._shard_count == self._shard_rank
        self._batch_index += 1
        if not owned:
            return
        lens1 = chunk1.seq_len[sub1]
        self._total_pairs += lens1.shape[0]
        self._bp[0] += int(lens1.sum())
        self._bp[1] += int(chunk2.seq_len[sub2].sum())
        if self.insert_pair is not None:
            self._inflight.append(
                self.insert_pair.submit(chunk1, sub1, chunk2, sub2)
            )
        else:
            ov1 = ov2 = None
            if self.overwrite is not None and self._ow_mode == "pre":
                ov1, ov2 = self._compute_overwrite(
                    chunk1, sub1, chunk2, sub2
                )
            tok1 = self.lane1.submit(chunk1, sub1, overrides=ov1)
            tok2 = self.lane2.submit(chunk2, sub2, overrides=ov2)
            tok1.ow = ov1
            tok2.ow = ov2
            self._inflight.append((tok1, tok2))
        while len(self._inflight) >= self.DEPTH:
            self._resolve_item(self._inflight.popleft())

    def _pump_two_files(self, quota):
        options = self.options
        s1 = _maybe_prefetch(
            _ChunkStream(options.input1, self.CHUNK_BYTES, self._in_fmts[0])
        )
        s2 = _maybe_prefetch(
            _ChunkStream(options.input2, self.CHUNK_BYTES, self._in_fmts[1])
        )
        seen_pairs = 0
        cur1 = cur2 = None
        pos1 = pos2 = 0
        try:
            while True:
                if quota is not None and seen_pairs >= quota:
                    break
                if cur1 is None or pos1 == cur1.n:
                    cur1 = s1.next_chunk()
                    pos1 = 0
                if cur2 is None or pos2 == cur2.n:
                    cur2 = s2.next_chunk()
                    pos2 = 0
                if cur1 is None or cur2 is None:
                    if (cur1 is None) != (cur2 is None):
                        from atropos_tpu.io.seqio import FormatError

                        more, less = (2, 1) if cur1 is None else (1, 2)
                        raise FormatError(
                            "Reads are improperly paired. There are more "
                            "reads in file {0} than in file {1}.".format(
                                more, less
                            )
                        )
                    break
                take = min(cur1.n - pos1, cur2.n - pos2, self.MAX_BATCH)
                if quota is not None:
                    take = min(take, quota - seen_pairs)
                seen_pairs += take
                sub1 = slice(pos1, pos1 + take)
                sub2 = slice(pos2, pos2 + take)
                pos1 += take
                pos2 += take
                self._submit_pair(cur1, sub1, cur2, sub2)
        finally:
            s1.close()
            s2.close()

    def _pump_interleaved(self, quota):
        """Single-stream pairing: even records are mate1, odd mate2
        (strided subs within a chunk; a chunk-boundary odd tail pairs as
        a one-pair batch with the next chunk's first record)."""
        from atropos_tpu.io.seqio import FormatError

        options = self.options
        stream = _maybe_prefetch(
            _ChunkStream(
                options.interleaved_input, self.CHUNK_BYTES, self._in_fmts[0]
            )
        )
        seen_pairs = 0
        leftover = None  # (chunk, record index) awaiting its partner
        try:
            while True:
                if quota is not None and seen_pairs >= quota:
                    return
                chunk = stream.next_chunk()
                if chunk is None:
                    break
                pos = 0
                if leftover is not None:
                    prev_chunk, prev_idx = leftover
                    leftover = None
                    self._submit_pair(prev_chunk, [prev_idx], chunk, [0])
                    seen_pairs += 1
                    pos = 1
                while chunk.n - pos >= 2:
                    if quota is not None and seen_pairs >= quota:
                        return
                    take = (chunk.n - pos) // 2
                    take = min(take, self.MAX_BATCH)
                    if quota is not None:
                        take = min(take, quota - seen_pairs)
                    sub1 = slice(pos, pos + 2 * take, 2)
                    sub2 = slice(pos + 1, pos + 1 + 2 * take, 2)
                    self._submit_pair(chunk, sub1, chunk, sub2)
                    seen_pairs += take
                    pos += 2 * take
                if chunk.n - pos == 1:
                    leftover = (chunk, pos)
            if leftover is not None:
                raise FormatError(
                    "Interleaved input file incomplete: Last record has no "
                    "partner."
                )
        finally:
            stream.close()

    # -- resolve: windows -> pair filters -> formatters ------------------------

    def _check_pair_names(self, tok1, tok2):
        validate_pair_names(
            tok1.chunk, tok1.sub, tok2.chunk, tok2.sub,
            interleaved=bool(self.options.interleaved_input),
        )

    def _compute_overwrite(self, chunk1, sub1, chunk2, sub2):
        """Vectorized OverwriteRead (``-w``) pre-pass (reference
        ``modifiers.py:511-563``): per pair, the mean quality of the
        first W bases decides whether one mate is replaced by the
        reverse complement of the other. Returns per-mate lane overrides
        (None = no replacements on that side)."""
        from atropos_tpu.runtime import _i32, _i64, _lib, _u8

        ow = self.overwrite
        win = ow.window_size
        len1 = chunk1.seq_len[sub1].astype(np.int64)
        len2 = chunk2.seq_len[sub2].astype(np.int64)
        eligible = (len1 >= win) & (len2 >= win)
        if not eligible.any():
            return None, None

        def window_mean(chunk, sub):
            offs = np.ascontiguousarray(chunk.qual_off[sub], np.int64)
            lens = np.ascontiguousarray(chunk.qual_len[sub], np.int32)
            out = np.zeros((offs.shape[0], win), np.uint8)
            _lib.gather_padded(
                _u8(chunk.buf), _i64(offs), _i32(lens),
                offs.shape[0], win, _u8(out),
            )
            return (out.astype(np.int64).sum(axis=1) - win * ow.base) / win

        score1 = window_mean(chunk1, sub1)
        score2 = window_mean(chunk2, sub2)
        worse, better = ow.worse_read_min_quality, ow.better_read_min_quality
        ow1 = eligible & (score1 < worse) & (score2 >= better)
        ow2 = eligible & ~ow1 & (score2 < worse) & (score1 >= better)

        def overrides(mask, src_chunk, src_sub, src_len):
            rows = np.nonzero(mask)[0]
            if rows.size == 0:
                return None
            abs_idx = np.arange(src_chunk.n)[src_sub][rows]
            lens = src_len[rows].astype(np.int32)
            wmax = max(1, int(lens.max()))
            offs_s = np.ascontiguousarray(src_chunk.seq_off[abs_idx], np.int64)
            offs_q = np.ascontiguousarray(src_chunk.qual_off[abs_idx], np.int64)
            lens_c = np.ascontiguousarray(lens, np.int32)
            seq = np.zeros((rows.size, wmax), np.uint8)
            qual = np.zeros((rows.size, wmax), np.uint8)
            _lib.gather_padded(
                _u8(src_chunk.buf), _i64(offs_s), _i32(lens_c),
                rows.size, wmax, _u8(seq),
            )
            _lib.gather_padded(
                _u8(src_chunk.buf), _i64(offs_q), _i32(lens_c),
                rows.size, wmax, _u8(qual),
            )
            comp = _complement_lut()[seq]
            for i in range(rows.size):
                length = int(lens[i])
                seq[i, :length] = comp[i, :length][::-1]
                qual[i, :length] = qual[i, :length][::-1].copy()
            return dict(
                rows=rows, n=lens, seq=seq, qual=qual,
                src_chunk=src_chunk, abs_idx=abs_idx,
            )

        return (
            overrides(ow1, chunk2, sub2, len2),
            overrides(ow2, chunk1, sub1, len1),
        )

    @staticmethod
    def _build_overwrite_alt(tok, keep_start, keep_stop):
        """Output patch data for overwritten records: the final
        (post-trim) replacement seq/qual windows plus the partner's
        name/plus header bytes — the correction alt layout extended with
        the name lanes."""
        ov = tok.ow
        if ov is None:
            return
        batch = tok.batch
        rows = ov["rows"]
        src_chunk = ov["src_chunk"]
        abs_idx = ov["abs_idx"]
        seg = np.maximum((keep_stop - keep_start)[rows], 0).astype(np.int64)
        nlens = src_chunk.name_len[abs_idx].astype(np.int64)
        plens = src_chunk.plus_len[abs_idx].astype(np.int64)
        total = int(2 * seg.sum() + nlens.sum() + plens.sum())
        buf = np.empty(total, np.uint8)
        sb = np.full(batch, -1, np.int64)
        se = np.full(batch, -1, np.int64)
        qb = np.full(batch, -1, np.int64)
        nb = np.full(batch, -1, np.int64)
        nl = np.zeros(batch, np.int32)
        pb = np.full(batch, -1, np.int64)
        pl = np.zeros(batch, np.int32)
        w = 0
        for i, row in enumerate(rows):
            a, b = int(keep_start[row]), int(keep_stop[row])
            length = max(0, b - a)
            sb[row] = w
            se[row] = w + length
            buf[w : w + length] = ov["seq"][i, a : a + length]
            w += length
            qb[row] = w
            buf[w : w + length] = ov["qual"][i, a : a + length]
            w += length
            n_len = int(nlens[i])
            n_off = int(src_chunk.name_off[abs_idx[i]])
            nb[row] = w
            nl[row] = n_len
            buf[w : w + n_len] = src_chunk.buf[n_off : n_off + n_len]
            w += n_len
            p_len = int(plens[i])
            p_off = int(src_chunk.plus_off[abs_idx[i]])
            pb[row] = w
            pl[row] = p_len
            buf[w : w + p_len] = src_chunk.buf[p_off : p_off + p_len]
            w += p_len
        tok.alt = (buf, sb, se, qb, nb, nl, pb, pl)

    def _overwrite_post(self, tok1, tok2, ks1, kp1, ks2, kp2):
        """W-last OverwriteRead (default 'CGQAW' op order): the quality
        window is measured on the TRIMMED reads, and the replacement is
        the reverse complement of the partner's trimmed window. Sets the
        affected rows' alt output data on each token and returns the
        (ow1, ow2) replacement masks, or None when no pair triggers."""
        ow = self.overwrite
        win = ow.window_size
        len1 = kp1 - ks1
        len2 = kp2 - ks2
        eligible = (len1 >= win) & (len2 >= win)
        if not eligible.any():
            return None

        from atropos_tpu.runtime import _i32, _i64, _lib, _u8

        def window_mean(tok, keep_start):
            chunk, sub = tok.chunk, tok.sub
            offs = np.ascontiguousarray(
                chunk.qual_off[sub] + keep_start.astype(np.int64), np.int64
            )
            lens = np.ascontiguousarray(
                (chunk.qual_len[sub] - keep_start).astype(np.int32)
            )
            out = np.zeros((offs.shape[0], win), np.uint8)
            _lib.gather_padded(
                _u8(chunk.buf), _i64(offs), _i32(lens),
                offs.shape[0], win, _u8(out),
            )
            return (out.astype(np.int64).sum(axis=1) - win * ow.base) / win

        score1 = window_mean(tok1, ks1)
        score2 = window_mean(tok2, ks2)
        worse, better = ow.worse_read_min_quality, ow.better_read_min_quality
        ow1 = eligible & (score1 < worse) & (score2 >= better)
        ow2 = eligible & ~ow1 & (score2 < worse) & (score1 >= better)
        if not (ow1.any() or ow2.any()):
            return None

        comp = _complement_lut()

        def build_alt(tok_dst, mask, tok_src, ks_src, kp_src):
            rows = np.nonzero(mask)[0]
            if rows.size == 0:
                return
            chunk, sub = tok_src.chunk, tok_src.sub
            abs_idx = np.arange(chunk.n)[sub][rows]
            batch = tok_dst.batch
            seg = np.maximum((kp_src - ks_src)[rows], 0).astype(np.int64)
            nlens = chunk.name_len[abs_idx].astype(np.int64)
            plens = chunk.plus_len[abs_idx].astype(np.int64)
            buf = np.empty(
                int(2 * seg.sum() + nlens.sum() + plens.sum()), np.uint8
            )
            sb = np.full(batch, -1, np.int64)
            se = np.full(batch, -1, np.int64)
            qb = np.full(batch, -1, np.int64)
            nb = np.full(batch, -1, np.int64)
            nl = np.zeros(batch, np.int32)
            pb = np.full(batch, -1, np.int64)
            pl = np.zeros(batch, np.int32)
            w = 0
            for i, row in enumerate(rows):
                a, b = int(ks_src[row]), int(kp_src[row])
                length = max(0, b - a)
                s_off = int(chunk.seq_off[abs_idx[i]])
                q_off = int(chunk.qual_off[abs_idx[i]])
                sb[row] = w
                se[row] = w + length
                buf[w : w + length] = comp[
                    chunk.buf[s_off + a : s_off + b][::-1]
                ]
                w += length
                qb[row] = w
                buf[w : w + length] = chunk.buf[q_off + a : q_off + b][::-1]
                w += length
                n_len, n_off = int(nlens[i]), int(chunk.name_off[abs_idx[i]])
                nb[row] = w
                nl[row] = n_len
                buf[w : w + n_len] = chunk.buf[n_off : n_off + n_len]
                w += n_len
                p_len, p_off = int(plens[i]), int(chunk.plus_off[abs_idx[i]])
                pb[row] = w
                pl[row] = p_len
                buf[w : w + p_len] = chunk.buf[p_off : p_off + p_len]
                w += p_len
            tok_dst.alt = (buf, sb, se, qb, nb, nl, pb, pl)

        build_alt(tok1, ow1, tok2, ks2, kp2)
        build_alt(tok2, ow2, tok1, ks1, kp1)
        return ow1, ow2

    def _resolve_item(self, item):
        """Resolve one in-flight batch: either an insert-pair token or a
        (tok1, tok2) per-mate pair."""
        if self.insert_pair is not None:
            tok1, tok2 = item.tok1, item.tok2
            self._check_pair_names(tok1, tok2)
            ks1, kp1, matched1, ks2, kp2, matched2 = (
                self.insert_pair.resolve(item)
            )
        else:
            tok1, tok2 = item
            self._check_pair_names(tok1, tok2)
            ks1, kp1, matched1 = self.lane1.resolve_windows(tok1)
            ks2, kp2, matched2 = self.lane2.resolve_windows(tok2)
        ks1, kp1 = self.lane1.apply_post(tok1, ks1, kp1, matched1)
        ks2, kp2 = self.lane2.apply_post(tok2, ks2, kp2, matched2)
        ow_masks = None
        if self.overwrite is not None:
            if self._ow_mode == "pre":
                self._build_overwrite_alt(tok1, ks1, kp1)
                self._build_overwrite_alt(tok2, ks2, kp2)
            else:
                ow_masks = self._overwrite_post(
                    tok1, tok2, ks1, kp1, ks2, kp2
                )
                if ow_masks is not None:
                    ow1, ow2 = ow_masks
                    # the replaced read carries a COPY of its partner's
                    # match (Sequence.reverse_complement provenance)
                    m1, m2 = matched1, matched2
                    matched1 = np.where(ow1, m2, m1)
                    matched2 = np.where(ow2, m1, m2)
        self._finish_pair(
            tok1, tok2, ks1, kp1, matched1, ks2, kp2, matched2,
            ow=ow_masks,
        )

    def _finish_pair(self, tok1, tok2, ks1, kp1, matched1, ks2, kp2,
                     matched2, ow=None):
        len1 = kp1 - ks1
        len2 = kp2 - ks2
        if ow is not None:
            # W-last overwrite: a replaced mate's filter-visible state
            # (length, N content) is its partner's trimmed window — the
            # reverse complement preserves both
            ow1, ow2 = ow
            raw1, raw2 = len1, len2
            len1 = np.where(ow1, raw2, raw1)
            len2 = np.where(ow2, raw1, raw2)

        # pair filters in registration order (first match wins). The
        # PairedWrapper combines per-mate criteria with min_affected
        # (1 = any, 2 = both); legacy 'first' mode wraps SingleWrapper,
        # which only inspects read1.
        dest_none = np.ones(tok1.batch, bool)
        dest_masks = []
        for ftype, wrapper in self.record_handler.filters.filters.items():
            c1 = self.lane1.criterion_hits(
                ftype, wrapper, tok1, ks1, kp1, matched1
            )
            if ow is not None and ow1.any():
                c1 = np.where(
                    ow1,
                    self.lane2.criterion_hits(
                        ftype, wrapper, tok2, ks2, kp2, matched1
                    ),
                    c1,
                )
            if isinstance(wrapper, PairedWrapper):
                c2 = self.lane2.criterion_hits(
                    ftype, wrapper, tok2, ks2, kp2, matched2
                )
                if ow is not None and ow2.any():
                    c2 = np.where(
                        ow2,
                        self.lane1.criterion_hits(
                            ftype, wrapper, tok1, ks1, kp1, matched2
                        ),
                        c2,
                    )
                hit = (c1 | c2) if wrapper.min_affected == 1 else (c1 & c2)
            else:
                hit = c1
            hit = dest_none & hit
            wrapper.filtered += int(hit.sum())
            dest_none &= ~hit
            dest_masks.append((ftype, hit))

        keep = dest_none
        if self.stats is not None:
            self._collect_turbo_stats(
                [
                    (self.lane1, tok1, ks1, kp1),
                    (self.lane2, tok2, ks2, kp2),
                ],
                dest_masks + [(NoFilter, keep)],
            )
        # per-destination routing (see the SE driver): dests with a
        # SingleEndFormatter write mate1 only — the scalar semantics when
        # a side output was given without its paired counterpart
        formatters = self.record_handler.formatters
        masks1 = {}
        masks2 = {}
        masks_il = {}
        from atropos_tpu.io.seqio import InterleavedFormatter

        for ftype, mask in dest_masks + [(NoFilter, keep)]:
            formatter = formatters.seq_formatters.get(ftype)
            count = int(mask.sum())
            if formatter is None:
                formatters.discarded += count
                continue
            formatter.written += count
            formatter.read1_bp += int(len1[mask].sum())
            interleaved = isinstance(formatter, InterleavedFormatter)
            file2 = getattr(formatter, "file2", None)
            if file2 is not None or interleaved:
                formatter.read2_bp += int(len2[mask].sum())
            if count:
                table = masks_il if interleaved else masks1
                prev = table.get(formatter.file1)
                table[formatter.file1] = (
                    mask if prev is None else (prev | mask)
                )
                if file2 is not None:
                    prev2 = masks2.get(file2)
                    masks2[file2] = mask if prev2 is None else (prev2 | mask)
        from functools import partial

        for tok, ks, kp, masks in (
            (tok1, ks1, kp1, masks1), (tok2, ks2, kp2, masks2),
        ):
            for path, mask in masks.items():
                self._writer.write(
                    self._open_output(path),
                    partial(
                        _format_records,
                        tok.chunk, tok.sub, ks, kp, mask,
                        fmt=self._fmt_of(path), alt=tok.alt,
                    ),
                )

        def interleave(fmt, mask):
            return _interleave_records(
                (
                    _format_records(
                        tok1.chunk, tok1.sub, ks1, kp1, mask, fmt,
                        alt=tok1.alt,
                    ),
                    _record_byte_lengths(
                        tok1.chunk, tok1.sub, ks1, kp1, mask, fmt,
                        alt=tok1.alt,
                    ),
                ),
                (
                    _format_records(
                        tok2.chunk, tok2.sub, ks2, kp2, mask, fmt,
                        alt=tok2.alt,
                    ),
                    _record_byte_lengths(
                        tok2.chunk, tok2.sub, ks2, kp2, mask, fmt,
                        alt=tok2.alt,
                    ),
                ),
            )

        for path, mask in masks_il.items():
            self._writer.write(
                self._open_output(path),
                partial(interleave, self._fmt_of(path), mask),
            )
        self._emit_side_files([(self.lane1, tok1), (self.lane2, tok2)])
