"""Batched XLA implementation of the semi-global alignment kernels.

This is the portable engine: the same DP the scalar oracle
(:mod:`atropos_tpu.align.oracle`) specifies, vectorized over a batch of
reads in plain ``jax.numpy``/``lax``, so it compiles for every JAX
backend. One kernel invocation aligns one adapter against B reads
simultaneously.

Design notes:

- **Column scan with per-read band state.** The reference kernel is
  column-sequential with Ukkonen banding whose band (``last``) evolves
  per column from computed costs, and abandoned cells keep stale values
  that are semantically observable. We reproduce this exactly: the j-loop
  is a ``lax.scan``; all (m+1) rows are computed each column but the
  writeback is masked to ``i <= last[b]``, and ``last`` is carried per
  read. This wastes a bounded amount of vector work in exchange for full
  vectorization and bit-exact parity.

- **Insertion chain as an associative scan.** Within a column, the cell
  recurrence has a loop-carried dependency through insertions:
  ``new[i] = eq ? diag : min(diag+1, old[i]+D, new[i-1]+I)`` with the
  tie-break order diagonal > insertion > deletion. We express each cell as
  a min-affine function ``f_i(x) = is_const ? C_i : min(C_i, x + t*I)``
  (match cells are constants) and compose with
  ``jax.lax.associative_scan`` in O(log m) steps. Tie-breaks are encoded
  in an integer subkey (diagonal-born candidates: ``m - i``; deletion-born
  and forced cells: ``m + i``) which provably reproduces the sequential
  resolution order for every candidate pair.

- **No float math.** All error-rate comparisons (``cost <= length *
  max_error_rate``) are precomputed host-side with Python doubles into an
  integer threshold table indexed by length, so kernel results are
  bit-exact with the reference's C-double comparisons regardless of
  device float semantics.

Scalar-kernel reference: ``atropos/align/_align.pyx:121-494`` (Aligner),
``:548-787`` (MultiAligner).
"""
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from atropos_tpu.align.flags import (
    ACGT_TABLE,
    IUPAC_TABLE,
    OVERHANG_MULTIPLIER,
    START_WITHIN_SEQ1,
    START_WITHIN_SEQ2,
    STOP_WITHIN_SEQ1,
    STOP_WITHIN_SEQ2,
)

NEG_LARGE = jnp.int32(-(2 ** 30))
POS_LARGE = jnp.int32(2 ** 30)


def _upper_table():
    table = np.arange(256, dtype=np.uint8)
    for c in range(ord("a"), ord("z") + 1):
        table[c] = c - 32
    return table


_UPPER = _upper_table()


def encode_reads(sequences, pad_to=None, upper=False):
    """Encode a list of read strings into (uint8 array [B, L], lengths).

    Bytes are raw ASCII (optionally uppercased, which is the caller's
    semantic responsibility — the kernel itself is case-sensitive like the
    scalar one); wildcard translation happens on device via lookup tables
    so one encoded batch serves all adapters.
    """
    batch = len(sequences)
    max_len = max((len(s) for s in sequences), default=0)
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    arr = np.zeros((batch, max_len), dtype=np.uint8)
    lengths = np.zeros(batch, dtype=np.int32)
    for idx, seq in enumerate(sequences):
        encoded = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        arr[idx, : len(encoded)] = encoded
        lengths[idx] = len(encoded)
    if upper:
        arr = _UPPER[arr]
    return arr, lengths


def _translation_lut(wildcard_ref, wildcard_query, for_query):
    """256-entry wildcard-translation LUT, mirroring the scalar kernel's
    rules (``_align.pyx:292-298``): query gets IUPAC if wildcard_query else
    ACGT if wildcard_ref; reference gets IUPAC if wildcard_ref else ACGT if
    wildcard_query; identity if neither."""
    lut = np.arange(256, dtype=np.uint8)
    if for_query:
        table = IUPAC_TABLE if wildcard_query else (
            ACGT_TABLE if wildcard_ref else None
        )
    else:
        table = IUPAC_TABLE if wildcard_ref else (
            ACGT_TABLE if wildcard_query else None
        )
    if table is None:
        return lut
    table_arr = np.frombuffer(table, dtype=np.uint8)
    return table_arr[lut]


def _error_thresholds(m, max_error_rate):
    """thresh[length] = max admissible cost for an alignment of that ref
    length, computed with Python doubles: cost <= length * max_error_rate
    <=> cost <= floor(length * max_error_rate) for integer cost."""
    return np.array(
        [int(np.floor(length * max_error_rate)) for length in range(m + 1)],
        dtype=np.int32,
    )


class BatchAligner:
    """Batched equivalent of the scalar ``Aligner`` for one adapter.

    Construct once per (adapter, parameters); call :meth:`locate_batch`
    with an encoded read batch. Results are bit-identical to
    ``oracle.Aligner.locate`` per read.
    """

    def __init__(
        self,
        reference,
        max_error_rate,
        flags,
        wildcard_ref=False,
        wildcard_query=False,
        min_overlap=1,
        indel_cost=1,
    ):
        self.reference = reference
        self.max_error_rate = max_error_rate
        self.flags = flags
        self.wildcard_ref = wildcard_ref
        self.wildcard_query = wildcard_query
        self.min_overlap = min_overlap
        self.indel_cost = indel_cost

        m = len(reference)
        self.m = m
        ref_b = reference.encode("ascii")
        if wildcard_ref:
            ref_b = ref_b.translate(IUPAC_TABLE)
        elif wildcard_query:
            ref_b = ref_b.translate(ACGT_TABLE)
        self._ref_arr = jnp.asarray(
            np.frombuffer(ref_b, dtype=np.uint8).astype(np.int32)
        )
        # query translation happens host-side (np fancy indexing), so one
        # translated upload serves the whole kernel
        self._query_lut_np = _translation_lut(
            wildcard_ref, wildcard_query, for_query=True
        ).astype(np.int32)
        self._thresholds = jnp.asarray(_error_thresholds(m, max_error_rate))
        self.k = int(max_error_rate * m)
        self._compare_ascii = not (wildcard_ref or wildcard_query)

        self._kernel_fn = functools.partial(
            _locate_kernel,
            m=m,
            k=self.k,
            flags=flags,
            min_overlap=min_overlap,
            ins_cost=indel_cost,
            del_cost=indel_cost,
            compare_ascii=self._compare_ascii,
        )
        self._kernel = jax.jit(self._kernel_fn)
        self._sharded_kernel = None

    def _get_sharded_kernel(self, mesh):
        """The same kernel wrapped in shard_map over the local device mesh:
        the batch axis is split across devices (pure data parallelism —
        every shard runs the identical program on its read slice)."""
        if self._sharded_kernel is None:
            from jax.sharding import PartitionSpec as P

            from atropos_tpu.parallel import READS_AXIS, _shard_map

            in_specs = (
                P(READS_AXIS, None),  # reads [B, L]
                P(READS_AXIS),        # lengths [B]
                P(None),              # ref
                P(None),              # thresholds
                P(None, READS_AXIS),  # cost0 [m+1, B]
                P(None, READS_AXIS),  # pay0
                P(None, READS_AXIS),  # last0
                P(None, READS_AXIS),  # done0
            )
            out_specs = {
                key: P(READS_AXIS)
                for key in (
                    "found", "start1", "stop1", "start2", "stop2",
                    "matches", "cost",
                )
            }
            self._sharded_kernel = jax.jit(
                _shard_map(self._kernel_fn, mesh, in_specs, out_specs)
            )
        return self._sharded_kernel

    def locate_batch(self, reads_u8, lengths):
        """Align the adapter to every read in the batch.

        Args:
            reads_u8: [B, L] uint8 raw ASCII (padding arbitrary).
            lengths: [B] int32 read lengths.

        Returns:
            dict of [B] arrays: found (bool), start1, stop1, start2,
            stop2, matches, cost — matching ``Aligner.locate``'s tuple.

        The initial DP column is built host-side with numpy and passed as
        a runtime input rather than embedded as batch-sized constants in
        the compiled executable.
        """
        translated = self._query_lut_np[np.asarray(reads_u8)]
        lengths = np.asarray(lengths, dtype=np.int32)

        from atropos_tpu.parallel import SHARD_COUNTS, data_parallel_mesh

        mesh = data_parallel_mesh()
        batch = lengths.shape[0]
        kernel = self._kernel
        if mesh is not None:
            ndev = mesh.devices.size
            pad = -batch % ndev
            if pad:
                translated = np.pad(translated, ((0, pad), (0, 0)))
                lengths = np.pad(lengths, (0, pad))
            kernel = self._get_sharded_kernel(mesh)
            SHARD_COUNTS["sharded_calls"] += 1

        init = _initial_state_np(
            lengths,
            m=self.m,
            k=self.k,
            flags=self.flags,
            ins_cost=self.indel_cost,
        )
        out = kernel(
            jnp.asarray(translated),
            jnp.asarray(lengths),
            self._ref_arr,
            self._thresholds,
            *(jnp.asarray(x) for x in init),
        )
        if mesh is not None and lengths.shape[0] != batch:
            out = {key: val[:batch] for key, val in out.items()}
        return out

    def locate_device(self, reads_dev, lengths_dev):
        """Device-resident variant of :meth:`locate_batch` for async
        pipelines: inputs are device arrays (reads [B, L] uint8/int32,
        already wildcard-translated unless ``compare_ascii``; lengths [B]
        int32), the initial DP column is built on device, and the returned
        dict holds device arrays — nothing synchronizes with the host."""
        init = _initial_state_jnp(
            lengths_dev,
            m=self.m,
            k=self.k,
            flags=self.flags,
            ins_cost=self.indel_cost,
        )
        return self._kernel(
            reads_dev.astype(jnp.int32),
            lengths_dev,
            self._ref_arr,
            self._thresholds,
            *init,
        )

    def locate(self, query):
        """Scalar-API convenience wrapper (single read)."""
        reads, lengths = encode_reads([query])
        out = self.locate_batch(reads, lengths)
        if not bool(out["found"][0]):
            return None
        return tuple(
            int(out[key][0])
            for key in ("start1", "stop1", "start2", "stop2", "matches", "cost")
        )


def _initial_state_np(lengths, *, m, k, flags, ins_cost):
    """Host-side construction of the initial DP column and trackers
    (reference ``_align.pyx:333-366``): cost0/pay0 [m+1, B], last0 [1, B],
    best cost init [1, B], done0 [1, B]."""
    start_in_ref = bool(flags & START_WITHIN_SEQ1)
    start_in_query = bool(flags & START_WITHIN_SEQ2)
    stop_in_query = bool(flags & STOP_WITHIN_SEQ2)

    def _pow2(x):
        p = 1
        while p < x:
            p *= 2
        return p

    PAY_BASE = _pow2(m + 1)
    CLAMP = 1 << 20

    batch = lengths.shape[0]
    n = lengths[None, :].astype(np.int32)
    if stop_in_query:
        min_n = np.zeros_like(n)
    else:
        min_n = np.maximum(0, n - m - k)
    rows = np.arange(m + 1, dtype=np.int32)[:, None]

    if not start_in_ref and not start_in_query:
        cost0 = np.maximum(rows, min_n) * ins_cost
        origin0 = np.zeros((m + 1, batch), np.int32)
    elif start_in_ref and not start_in_query:
        cost0 = np.broadcast_to(min_n * ins_cost, (m + 1, batch))
        origin0 = np.minimum(0, min_n - rows)
    elif not start_in_ref and start_in_query:
        cost0 = np.broadcast_to(rows * ins_cost, (m + 1, batch))
        origin0 = np.maximum(0, min_n - rows)
    else:
        cost0 = np.minimum(rows, min_n) * ins_cost
        origin0 = min_n - rows
    cost0 = np.minimum(
        np.broadcast_to(cost0, (m + 1, batch)), CLAMP
    ).astype(np.int32)
    origin0 = np.broadcast_to(origin0, (m + 1, batch)).astype(np.int32)
    pay0 = (origin0 + m) * PAY_BASE

    last0 = np.full((1, batch), m if start_in_ref else min(m, k + 1), np.int32)
    done0 = np.zeros((1, batch), bool)
    return cost0, pay0, last0, done0


def _initial_state_jnp(lengths, *, m, k, flags, ins_cost):
    """Device-side twin of :func:`_initial_state_np` (same outputs, jnp
    ops on a device-resident lengths vector so no host round-trip is
    needed to start a kernel)."""
    start_in_ref = bool(flags & START_WITHIN_SEQ1)
    start_in_query = bool(flags & START_WITHIN_SEQ2)
    stop_in_query = bool(flags & STOP_WITHIN_SEQ2)

    def _pow2(x):
        p = 1
        while p < x:
            p *= 2
        return p

    PAY_BASE = _pow2(m + 1)
    CLAMP = 1 << 20

    batch = lengths.shape[0]
    n = lengths[None, :].astype(jnp.int32)
    if stop_in_query:
        min_n = jnp.zeros_like(n)
    else:
        min_n = jnp.maximum(0, n - m - k)
    rows = jnp.arange(m + 1, dtype=jnp.int32)[:, None]

    if not start_in_ref and not start_in_query:
        cost0 = jnp.maximum(rows, min_n) * ins_cost
        origin0 = jnp.zeros((m + 1, batch), jnp.int32)
    elif start_in_ref and not start_in_query:
        cost0 = jnp.broadcast_to(min_n * ins_cost, (m + 1, batch))
        origin0 = jnp.minimum(0, min_n - rows)
    elif not start_in_ref and start_in_query:
        cost0 = jnp.broadcast_to(rows * ins_cost, (m + 1, batch))
        origin0 = jnp.maximum(0, min_n - rows)
    else:
        cost0 = jnp.minimum(rows, min_n) * ins_cost
        origin0 = min_n - rows
    cost0 = jnp.minimum(
        jnp.broadcast_to(cost0, (m + 1, batch)), CLAMP
    ).astype(jnp.int32)
    origin0 = jnp.broadcast_to(origin0, (m + 1, batch)).astype(jnp.int32)
    pay0 = (origin0 + m) * PAY_BASE

    last0 = jnp.full((1, batch), m if start_in_ref else min(m, k + 1), jnp.int32)
    done0 = jnp.zeros((1, batch), bool)
    return cost0, pay0, last0, done0


def _locate_kernel(
    reads,
    lengths,
    ref_arr,
    thresholds,
    cost0,
    pay0,
    last0,
    done0,
    *,
    m,
    k,
    flags,
    min_overlap,
    ins_cost,
    del_cost,
    compare_ascii,
    debug=False,
):
    """Core batched DP.

    Layout: all DP state is [m+1, B] so the batch is the minor-most
    (contiguous) axis; per-read scalars are kept as [1, B]. Cell state
    is packed into two int32 planes:
    ``pack = clamp(cost) * SUB_BASE + subkey`` (lexicographic min == the
    tie-break order) and ``pay = (origin + m) * PAY_BASE + matches``.
    Costs are clamped at CLAMP >> k, which cannot change any observable
    result: every cell with cost > k is permanently dead (cost along a DP
    path is non-decreasing) and only its > k property is ever read.
    """
    batch, L = reads.shape
    start_in_ref = bool(flags & START_WITHIN_SEQ1)
    start_in_query = bool(flags & START_WITHIN_SEQ2)
    stop_in_ref = bool(flags & STOP_WITHIN_SEQ1)
    stop_in_query = bool(flags & STOP_WITHIN_SEQ2)

    def _pow2(x):
        p = 1
        while p < x:
            p *= 2
        return p

    SUB_BASE = _pow2(2 * m + 2)
    PAY_BASE = _pow2(m + 1)
    CLAMP = 1 << 20

    n = lengths[None, :].astype(jnp.int32)  # [1, B]
    if start_in_query:
        max_n = n
    else:
        max_n = jnp.minimum(n, m + k)
    if stop_in_query:
        min_n = jnp.zeros_like(n)
    else:
        min_n = jnp.maximum(0, n - m - k)

    rows = jnp.arange(m + 1, dtype=jnp.int32)[:, None]  # [m+1, 1]

    best0 = dict(
        ref_stop=jnp.zeros_like(last0) + m,
        query_stop=n + 0,
        cost=m + n,
        origin=jnp.zeros_like(last0),
        matches=jnp.zeros_like(last0),
    )

    q_cols = reads.T[:, None, :]  # [L, 1, B]

    ref_col = ref_arr[:, None]  # [m, 1]
    pos_i = jnp.arange(1, m + 1, dtype=jnp.int32)[:, None]  # [m, 1]

    shift_unit = ins_cost * SUB_BASE

    def combine(F, G):
        """Compose min-affine elements (F = earlier rows, G = later)."""
        shifted = F["pack"] + G["t"] * shift_unit
        g_wins = G["pack"] <= shifted
        out_pack = jnp.where(g_wins, G["pack"], shifted)
        out_pay = jnp.where(g_wins, G["pay"], F["pay"])
        gc = G["const"]
        return dict(
            pack=jnp.where(gc, G["pack"], out_pack),
            pay=jnp.where(gc, G["pay"], out_pay),
            t=jnp.where(gc, G["t"], F["t"] + G["t"]),
            const=F["const"] | gc,
        )

    def column_step(carry, xs):
        cost_c, pay_c, last, best, done = carry
        j, qc = xs  # qc: [1, B]
        active = (j > min_n) & (j <= max_n) & (~done)  # [1, B]

        # row 0 update (reference ``_align.pyx:385-388``)
        org_row0 = pay_c[:1] // PAY_BASE - m
        mat_row0 = pay_c[:1] % PAY_BASE
        if start_in_query:
            new0_cost = cost_c[:1]
            new0_pay = (j + m) * PAY_BASE + mat_row0
        else:
            new0_cost = jnp.full((1, batch), j * ins_cost, jnp.int32)
            new0_cost = jnp.minimum(new0_cost, CLAMP)
            new0_pay = pay_c[:1]

        if compare_ascii:
            eq = ref_col == qc  # [m, B]
        else:
            eq = (ref_col & qc) != 0

        diag_cost = cost_c[:-1]
        diag_pay = pay_c[:-1]

        # local candidate per mismatch cell: min(diag+1, old+D); diag wins ties
        del_cost_arr = cost_c[1:] + del_cost
        diag_m_cost = diag_cost + 1
        pick_diag = diag_m_cost <= del_cost_arr
        loc_cost = jnp.where(pick_diag, diag_m_cost, del_cost_arr)
        loc_pay = jnp.where(pick_diag, diag_pay, pay_c[1:])
        loc_sub = jnp.where(pick_diag, m - pos_i, m + pos_i)

        # match cells are forced constants (no indel at a match)
        elem_cost = jnp.where(eq, diag_cost, loc_cost)
        elem_pay = jnp.where(eq, diag_pay + 1, loc_pay)  # matches += 1
        elem_sub = jnp.where(eq, m + pos_i, loc_sub)
        elem_t = jnp.where(eq, 0, 1)

        elems = dict(
            pack=jnp.concatenate(
                [new0_cost * SUB_BASE + m, elem_cost * SUB_BASE + elem_sub]
            ),
            pay=jnp.concatenate([new0_pay, elem_pay]),
            t=jnp.concatenate([jnp.zeros((1, batch), jnp.int32), elem_t]),
            const=jnp.concatenate([jnp.ones((1, batch), bool), eq]),
        )
        scanned = lax.associative_scan(combine, elems, axis=0)
        new_cost = jnp.minimum(scanned["pack"] // SUB_BASE, CLAMP)
        new_pay = scanned["pay"]

        # masked writeback: rows 1..last for active reads; row 0 always
        write = active & ((rows <= last) & (rows >= 1) | (rows == 0))
        cost_c = jnp.where(write, new_cost, cost_c)
        pay_c = jnp.where(write, new_pay, pay_c)

        # band update (reference ``_align.pyx:433-439``)
        in_band = (rows <= last) & (cost_c <= k)
        L_idx = jnp.max(jnp.where(in_band, rows, -1), axis=0, keepdims=True)
        new_last = jnp.minimum(L_idx + 1, m)

        # row-m check when the band still reaches row m
        if stop_in_query:
            at_bottom = active & (L_idx == m)
            org_m = pay_c[m:] // PAY_BASE - m
            mat_m = pay_c[m:] % PAY_BASE
            length_m = m + jnp.minimum(org_m, 0)
            cost_m = cost_c[m:]
            # threshold lookup as a one-hot select over the m+1 rows
            thresh_m = jnp.max(
                jnp.where(rows == length_m, thresholds[:, None], NEG_LARGE),
                axis=0,
                keepdims=True,
            )
            ok = (
                at_bottom
                & (length_m >= min_overlap)
                & (cost_m <= thresh_m)
                & (
                    (mat_m > best["matches"])
                    | ((mat_m == best["matches"]) & (cost_m < best["cost"]))
                )
            )
            best = dict(
                ref_stop=jnp.where(ok, m, best["ref_stop"]),
                query_stop=jnp.where(ok, j, best["query_stop"]),
                cost=jnp.where(ok, cost_m, best["cost"]),
                origin=jnp.where(ok, org_m, best["origin"]),
                matches=jnp.where(ok, mat_m, best["matches"]),
            )
            done = done | (ok & (cost_m == 0) & (mat_m == m))

        last = jnp.where(active, new_last, last)
        snapshot = (cost_c, write) if debug else None
        return (cost_c, pay_c, last, best, done), snapshot

    js = jnp.arange(1, L + 1, dtype=jnp.int32)
    (cost_c, pay_c, last, best, done), snapshots = lax.scan(
        column_step,
        (cost0, pay0, last0, best0, done0),
        (js, q_cols),
    )

    org_c = pay_c // PAY_BASE - m
    mat_c = pay_c % PAY_BASE

    # final-column scan (reference ``_align.pyx:461-474``)
    first_i = 0 if stop_in_ref else m
    lengths_i = rows + jnp.minimum(org_c, 0)  # [m+1, B]
    valid = (
        (rows >= first_i)
        & (lengths_i >= min_overlap)
        & (cost_c <= thresholds[jnp.clip(lengths_i, 0, m)])
        & (max_n == n)
    )
    cost_clamped = jnp.minimum(cost_c, 1023)
    key = mat_c * 2048 + (1023 - cost_clamped)
    key = key * (m + 2) + (m + 1 - rows)
    key = jnp.where(valid, key, NEG_LARGE)
    best_key = jnp.max(key, axis=0, keepdims=True)
    any_valid = best_key > NEG_LARGE
    sel = (key == best_key) & valid
    # first row achieving the best key (ties: smallest i by key design)
    best_idx = jnp.max(
        jnp.where(sel, rows, -1), axis=0, keepdims=True
    )
    pick = rows == best_idx
    take = lambda arr: jnp.max(
        jnp.where(pick, arr, NEG_LARGE), axis=0, keepdims=True
    )
    cand_cost = take(cost_c)
    cand_mat = take(mat_c)
    cand_org = take(org_c)
    better = any_valid & (
        (cand_mat > best["matches"])
        | ((cand_mat == best["matches"]) & (cand_cost < best["cost"]))
    )
    best = dict(
        ref_stop=jnp.where(better, best_idx, best["ref_stop"]),
        query_stop=jnp.where(better, n, best["query_stop"]),
        cost=jnp.where(better, cand_cost, best["cost"]),
        origin=jnp.where(better, cand_org, best["origin"]),
        matches=jnp.where(better, cand_mat, best["matches"]),
    )

    found = (best["cost"] != (m + n))[0]
    origin = best["origin"][0]
    start1 = jnp.where(origin >= 0, 0, -origin)
    start2 = jnp.where(origin >= 0, origin, 0)
    out = dict(
        found=found,
        start1=start1,
        stop1=best["ref_stop"][0],
        start2=start2,
        stop2=best["query_stop"][0],
        matches=best["matches"][0],
        cost=best["cost"][0],
    )
    if debug:
        # per-column (cost, writeback-mask) snapshots [L, m+1, B] — the
        # kernel's DP-matrix debug path (SURVEY §5; scalar counterpart
        # ``oracle.DPMatrix`` / reference ``_align.pyx:88-119``)
        out["debug_cost"], out["debug_write"] = snapshots
    return out


def debug_dp_matrix(reference, query, flags, max_error_rate=0.1,
                    min_overlap=1, indel_cost=1, wildcard_ref=False,
                    wildcard_query=False):
    """Run the batched kernel in debug mode for one read and return the
    oracle-format DP cost matrix: an (m+1) x (n+1) list-of-lists where
    cells the band never computed stay None — directly diffable against
    ``oracle.Aligner`` with ``enable_debug()``."""
    aligner = BatchAligner(
        reference, max_error_rate, flags,
        wildcard_ref=wildcard_ref, wildcard_query=wildcard_query,
        min_overlap=min_overlap, indel_cost=indel_cost,
    )
    reads, lengths = encode_reads([query])
    translated = aligner._query_lut_np[reads]
    init = _initial_state_np(
        lengths, m=aligner.m, k=aligner.k, flags=flags, ins_cost=indel_cost
    )
    kernel = jax.jit(functools.partial(aligner._kernel_fn, debug=True))
    out = kernel(
        jnp.asarray(translated),
        jnp.asarray(lengths),
        aligner._ref_arr,
        aligner._thresholds,
        *(jnp.asarray(x) for x in init),
    )
    cost_cols = np.asarray(out["debug_cost"])[:, :, 0]    # [L, m+1]
    write_cols = np.asarray(out["debug_write"])[:, :, 0]  # [L, m+1]
    m = aligner.m
    n = len(query)
    stop_in_query = bool(flags & STOP_WITHIN_SEQ2)
    min_n = 0 if stop_in_query else max(0, n - m - aligner.k)
    matrix = [[None] * (n + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        matrix[i][min_n] = int(init[0][i, 0])
    for j in range(1, n + 1):
        for i in range(m + 1):
            if write_cols[j - 1, i]:
                matrix[i][j] = int(cost_cols[j - 1, i])
    return matrix


# ---------------------------------------------------------------------------
# Batched quality trimming (reference ``_qualtrim.pyx``)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("base",))
def _quality_trim_kernel(quals, lengths, cutoff_front, cutoff_back, base):
    batch, L = quals.shape
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_read = idx < lengths[:, None]
    q = quals.astype(jnp.int32) - base

    # 5' scan: running sum of (cutoff - q); stop at first negative; trim at
    # the first position achieving the maximum positive sum.
    delta_f = jnp.where(in_read, cutoff_front[:, None] - q, 0)
    pref = jnp.cumsum(delta_f, axis=1)
    neg = (pref < 0) & in_read
    first_neg = jnp.min(jnp.where(neg, idx, L), axis=1)  # [B]
    valid_f = in_read & (idx < first_neg[:, None])
    maxval_f = jnp.max(jnp.where(valid_f, pref, NEG_LARGE), axis=1)
    is_max_f = valid_f & (pref == maxval_f[:, None])
    first_max_f = jnp.min(jnp.where(is_max_f, idx, L), axis=1)
    start = jnp.where(maxval_f > 0, first_max_f + 1, 0)

    # 3' scan (from the read end inward)
    delta_b = jnp.where(in_read, cutoff_back[:, None] - q, 0)
    total_b = jnp.sum(delta_b, axis=1, keepdims=True)
    # suffix sum including position i
    suff = total_b - jnp.cumsum(delta_b, axis=1) + delta_b
    neg_b = (suff < 0) & in_read
    last_neg = jnp.max(jnp.where(neg_b, idx, -1), axis=1)  # [B]
    valid_b = in_read & (idx > last_neg[:, None])
    maxval_b = jnp.max(jnp.where(valid_b, suff, NEG_LARGE), axis=1)
    is_max_b = valid_b & (suff == maxval_b[:, None])
    last_max_b = jnp.max(jnp.where(is_max_b, idx, -1), axis=1)
    stop = jnp.where(maxval_b > 0, last_max_b, lengths)

    both_zero = start >= stop
    return jnp.where(both_zero, 0, start), jnp.where(both_zero, 0, stop)


def quality_trim_batch(quals_u8, lengths, cutoff_front, cutoff_back, base=33):
    """Batched BWA-style quality trim. Returns (start, stop) [B] arrays,
    bit-identical to the scalar ``quality_trim_index`` per read."""
    batch = quals_u8.shape[0]
    cf = jnp.full((batch,), cutoff_front, jnp.int32)
    cb = jnp.full((batch,), cutoff_back, jnp.int32)
    return _quality_trim_kernel(
        jnp.asarray(quals_u8), jnp.asarray(lengths, jnp.int32), cf, cb, base
    )


@functools.partial(jax.jit, static_argnames=("base",))
def _nextseq_trim_kernel(seqs, quals, lengths, cutoff, base):
    batch, L = quals.shape
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_read = idx < lengths[:, None]
    q = quals.astype(jnp.int32) - base
    is_g = seqs == ord("G")
    q = jnp.where(is_g, cutoff[:, None] - 1, q)
    delta = jnp.where(in_read, cutoff[:, None] - q, 0)
    total = jnp.sum(delta, axis=1, keepdims=True)
    suff = total - jnp.cumsum(delta, axis=1) + delta
    neg = (suff < 0) & in_read
    last_neg = jnp.max(jnp.where(neg, idx, -1), axis=1)
    valid = in_read & (idx > last_neg[:, None])
    maxval = jnp.max(jnp.where(valid, suff, NEG_LARGE), axis=1)
    is_max = valid & (suff == maxval[:, None])
    last_max = jnp.max(jnp.where(is_max, idx, -1), axis=1)
    return jnp.where(maxval > 0, last_max, lengths)


def nextseq_trim_batch(seqs_u8, quals_u8, lengths, cutoff, base=33):
    """Batched NextSeq two-color 3' trim. Returns stop [B] array."""
    batch = quals_u8.shape[0]
    cut = jnp.full((batch,), cutoff, jnp.int32)
    return _nextseq_trim_kernel(
        jnp.asarray(seqs_u8),
        jnp.asarray(quals_u8),
        jnp.asarray(lengths, jnp.int32),
        cut,
        base,
    )


# ---------------------------------------------------------------------------
# Batched insert-overlap matcher (variable-length, diagonal closed form)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=())
def _diagonal_match_counts(refs_T, queries_T, lengths_row):
    """Per-diagonal match counts for the no-indel insert configuration.

    refs_T/queries_T: [W, B] int32 byte planes (pair-wise truncated to the
    same per-pair length m_b, zero-padded); lengths_row: [1, B] int32.
    Returns [W, B] int32 where row s = number of matching positions of
    the alignment that starts at ref offset s (diagonal origin -s):
    ``sum_t [ref[s+t] == query[t]]`` over ``t < m_b - s``.

    Without indels every DP path is a diagonal, so the whole MultiAligner
    DP collapses to W shifted compares — a fraction of the cell-update
    work of the banded scan kernel, with no in-kernel candidate slots.
    """
    W, B = queries_T.shape
    rows = jnp.arange(W, dtype=jnp.int32)[:, None]  # [W, 1]

    def step(ref_cur, s):
        eq = (ref_cur == queries_T) & (rows < (lengths_row - s))
        count = jnp.sum(eq.astype(jnp.int32), axis=0)  # [B]
        return jnp.roll(ref_cur, -1, axis=0), count

    _, counts = lax.scan(step, refs_T, jnp.arange(W, dtype=jnp.int32))
    return counts  # [W, B]


#: candidate slots carried per pair in the fused-step wire format
#: (typical pairs emit 0-3 candidates, so the device-to-host fetch stays
#: small); pairs with more candidates (rare: requires many admissible
#: diagonals) set an overflow condition and are reconstructed host-side
#: from recomputed counts
INSERT_CANDIDATE_SLOTS = 8


def insert_candidate_slots(
    counts, m_col, ref_plane, query_plane, err, min_overlap, max_matches,
    n_slots=INSERT_CANDIDATE_SLOTS,
):
    """Traced (device) twin of :meth:`BatchInsertMatcher.candidate_arrays`
    emitting a fixed-size wire format instead of the full counts plane.

    The full [W, B] counts plane is ~1 byte per diagonal per pair on the
    link; real pairs emit O(1) candidates, so the candidate stream itself
    is the natural wire format. This computes the EXACT candidate stream
    (band reach, admissibility, exact-match collapse, max_matches cap —
    integer-for-integer the host reconstruction, with the float
    ``int(err*m)`` thresholds baked in as static host-computed step
    tables) and returns:

    - ``slots`` [n_slots, B] int32: candidate c in stream order (s
      descending), packed ``(s+1) | count << 8`` biased by -32768 to
      survive the int16 bundle; 0-slot = no candidate.
    - ``meta`` [3, B] int32: [n_cand; final_s + 512*final_ok;
      final_count] — the final-column re-record (emitted after all
      candidates when present).

    Requires ``W <= 255`` (s and counts fit a byte). Pairs with
    ``n_cand > n_slots`` must be reconstructed host-side (the resolver
    recomputes their counts from the byte planes).
    """
    W, B = counts.shape
    tab = np.array([int(np.floor(s * err)) for s in range(W + 1)], np.int32)
    bounds = [s for s in range(1, W + 1) if tab[s] > tab[s - 1]]

    def thresh_of(length):
        out = jnp.full(length.shape, int(tab[0]), jnp.int32)
        for b in bounds:
            out = out + (length >= b).astype(jnp.int32) * int(
                tab[b] - tab[b - 1]
            )
        return out

    s_idx = jnp.arange(W, dtype=jnp.int32)[:, None]
    m_row = m_col[None, :].astype(jnp.int32)
    size = m_row - s_idx
    in_range = size > 0
    cost = jnp.where(in_range, size - counts, 0)
    k_col = thresh_of(m_row)

    # bottom-row mismatch of each diagonal (device twin of the host
    # byte compare in candidate_arrays)
    w_r = ref_plane.shape[1]
    last_idx = jnp.clip(m_col - 1, 0, w_r - 1)[:, None]
    last_ref = jnp.take_along_axis(ref_plane, last_idx, axis=1)  # [B,1]
    q_idx = jnp.clip(
        m_col[:, None] - 1 - jnp.arange(W, dtype=jnp.int32)[None, :],
        0, query_plane.shape[1] - 1,
    )
    q_last = jnp.take_along_axis(query_plane, q_idx, axis=1)  # [B, W]
    mm_last = (q_last.T != last_ref[:, 0][None, :]).astype(jnp.int32)

    alive_bot = in_range & (cost <= k_col)
    alive_bot_ext = alive_bot | ~in_range
    alive_m1 = in_range & ((cost - mm_last) <= k_col)
    reach = jnp.concatenate(
        [alive_bot_ext[1:], jnp.ones((1, B), bool)], axis=0
    )
    reach = (reach | alive_m1) & in_range
    rec = (
        reach
        & alive_bot
        & (size >= min_overlap)
        & (cost <= thresh_of(jnp.clip(size, 0, W)))
    )
    rec_i = rec.astype(jnp.int32)
    prefix_incl = jnp.cumsum(rec_i, axis=0)
    total = prefix_incl[-1:]
    rank = total - prefix_incl
    exact = rec[0:1] & (cost[0:1] == 0) & (rank[0:1] < max_matches)
    kept = rec & (rank < max_matches)
    cand = jnp.where(exact, (s_idx == 0) & rec, kept)
    rank = jnp.where(exact, 0, rank)
    n_cand = jnp.sum(cand.astype(jnp.int32), axis=0)

    slot_rows = []
    for c in range(n_slots):
        pick = cand & (rank == c)
        s_c = jnp.max(jnp.where(pick, s_idx, -1), axis=0)
        cnt_c = jnp.max(jnp.where(pick, counts, 0), axis=0)
        val = jnp.where(s_c >= 0, (s_c + 1) | (cnt_c << 8), 0) - 32768
        slot_rows.append(val[None, :])
    slots = jnp.concatenate(slot_rows, axis=0)

    broke = exact[0] | (total[0] >= max_matches)
    any_reach = jnp.any(reach, axis=0)
    first_reach = jnp.argmax(reach, axis=0).astype(jnp.int32)
    s_f = jnp.where(any_reach, first_reach, jnp.maximum(m_col - 1, 0))
    onehot_f = s_idx == s_f[None, :]
    cost_f = jnp.sum(jnp.where(onehot_f, cost, 0), axis=0)
    size_f = jnp.sum(jnp.where(onehot_f, size, 0), axis=0)
    count_f = jnp.sum(jnp.where(onehot_f, counts, 0), axis=0)
    final_ok = (
        (~broke)
        & (m_col > 0)
        & (size_f >= min_overlap)
        & (cost_f <= thresh_of(jnp.clip(size_f, 0, W)))
    )
    meta = jnp.stack(
        [n_cand, s_f + jnp.where(final_ok, 512, 0), count_f]
    ).astype(jnp.int32)
    return slots, meta


class BatchInsertMatcher:
    """Variable-length batched equivalent of ``MultiAligner.locate`` for
    the paired-end insert configuration (flags START_WITHIN_SEQ1 |
    STOP_WITHIN_SEQ2, reference and query truncated to the same per-pair
    length — exactly how ``InsertAligner.match_insert`` calls it,
    reference ``atropos/align/__init__.py:351`` / ``_align.pyx:593-772``).

    One kernel handles every pair length in the batch (per-pair length is
    data, not shape), eliminating the per-(m, L) compile churn of the
    same-length-group kernel.

    Device side: per-diagonal match counting (the no-indel DP collapses to
    shifted compares). Host side: closed-form reconstruction of the scalar
    kernel's candidate stream. The reconstruction provably reproduces the
    banded scan:

    - A cell value on a diagonal is exact wherever the band computed it,
      and a diagonal whose running cost is <= k is always inside the band
      (costs are non-decreasing along a diagonal, the band regrows one row
      per column, and start_in_ref initializes the band at m), so the
      bottom-row candidate of diagonal ``o = -s`` is recorded at column
      ``j = m - s`` iff the band reached row m there:
      ``reach(s) = alive(s+1, m) or alive(s, m-1)`` (the deepest fresh
      row with cost <= k at the previous column must be >= m-1), with
      ``alive(s, i)`` = running cost of diagonal -s at row i is <= k.
    - The final-column record re-reads row m after the loop, which holds
      the value of the LAST diagonal whose column reached row m (a stale
      cell re-recorded with query_stop = n — shipped scalar behavior).
    - The exact-match collapse and the max_matches cap truncate the
      stream exactly as the scalar loop does.

    Bit-exactness vs the scalar oracle is pinned by
    ``tests/test_multi_align.py``.
    """

    def __init__(self, max_error_rate, min_overlap=1, max_matches=100):
        self.max_error_rate = float(max_error_rate)
        self.min_overlap = min_overlap
        self.max_matches = max_matches

    def match_counts_device(self, refs_T_dev, queries_T_dev, lengths_row_dev):
        """Device-resident entry: [W, B] planes + [1, B] lengths in,
        [W, B] match-count device array out (no host synchronization)."""
        return _diagonal_match_counts(
            refs_T_dev, queries_T_dev, lengths_row_dev
        )

    def candidates(self, refs_u8, reads_u8, lengths):
        """Per-pair candidate lists in the scalar ``MultiAligner.locate``
        format. refs_u8/reads_u8: [B, W] uint8 (ref = rc(read2[:m_b]),
        query = read1[:m_b], zero-padded); lengths: [B] per-pair m_b.
        Returns a list of B entries, each a list of (refstart, refstop,
        querystart, querystop, matches, errors) tuples or None.
        """
        refs_u8 = np.asarray(refs_u8)
        reads_u8 = np.asarray(reads_u8)
        lengths = np.asarray(lengths, np.int32)
        counts = np.asarray(
            _diagonal_match_counts(
                jnp.asarray(refs_u8.T.astype(np.int32)),
                jnp.asarray(reads_u8.T.astype(np.int32)),
                jnp.asarray(lengths[None, :]),
            )
        )  # [W, B]
        return self.reconstruct(counts, refs_u8, reads_u8, lengths)

    def candidate_arrays(self, counts, refs_u8, reads_u8, lengths):
        """Fully-vectorized candidate-stream reconstruction (no per-pair
        loop; see class docstring for the banding derivation).

        Returns a dict of arrays describing the scalar kernel's candidate
        stream for every pair at once:

        - ``cand`` [W, B] bool: diagonal s emitted as a normal candidate
          (coords (s, m_b, 0, m_b - s, counts[s], cost[s])), already
          truncated by the exact-match collapse and the max_matches cap.
        - ``rank`` [W, B] int: 0-based position of the candidate in the
          scalar emission order (s descending).
        - ``final_ok`` [B] bool / ``final_s`` [B] int: the final-column
          re-record (coords (s_f, m_b, 0, m_b, counts[s_f], cost[s_f])),
          emitted last when present.
        - ``cost``/``size`` [W, B] int64 per-diagonal cost and overlap.
        """
        B, W = reads_u8.shape
        err = self.max_error_rate
        min_overlap = self.min_overlap
        max_matches = self.max_matches

        m = lengths.astype(np.int32)  # [B]
        s_idx = np.arange(W, dtype=np.int32)[:, None]  # [W, 1]
        size = m[None, :] - s_idx  # [W, B] overlap length per diagonal
        in_range = size > 0
        cost = np.where(in_range, size - counts, 0).astype(np.int32)
        k = (err * m).astype(np.int32)  # int(err*m): C-double truncation
        # the float admissibility check (cost <= size * err, C doubles)
        # as an exact integer threshold table: for integer cost,
        # cost <= size*err  <=>  cost <= floor(size*err)
        thresh = np.array(
            [int(np.floor(s * err)) for s in range(W + 1)], np.int32
        )

        # mismatch at the bottom row of each diagonal (host byte compare)
        last_ref = np.take_along_axis(
            refs_u8, np.maximum(m - 1, 0)[:, None].astype(np.int64), axis=1
        )  # [B, 1]
        q_idx = np.clip(m[None, :] - 1 - s_idx, 0, W - 1).T  # [B, W]
        q_last = np.take_along_axis(reads_u8, q_idx, axis=1).T  # [W, B]
        mm_last = (q_last != last_ref.T).astype(np.int32)

        alive_bot = in_range & (cost <= k[None, :])
        # s >= m_b: zero-length overlap, running cost 0 -> alive
        alive_bot_ext = alive_bot | ~in_range
        alive_m1 = in_range & ((cost - mm_last) <= k[None, :])
        # band reached row m at column j = m - s
        reach = np.empty_like(alive_bot)
        reach[:-1] = alive_bot_ext[1:]
        reach[-1] = True  # s = W-1: zero/negative overlap successor
        reach |= alive_m1
        reach &= in_range

        rec = (
            reach
            & alive_bot
            & (size >= min_overlap)
            & (cost <= thresh[np.clip(size, 0, W)])
        )

        # emission order is s descending; rank(s) = #candidates with
        # s' > s = total - inclusive-prefix-count (one forward cumsum —
        # a reversed-view cumsum costs 3x in strided traffic)
        rec_i = rec.astype(np.int32)
        prefix_incl = np.cumsum(rec_i, axis=0)
        total = prefix_incl[-1]
        rank = total[None, :] - prefix_incl
        # exact-match collapse: diagonal 0 with zero cost, if reached
        # before the cap, erases every earlier candidate
        exact = rec[0] & (cost[0] == 0) & (rank[0] < max_matches)
        kept = rec & (rank < max_matches)
        cand = np.where(exact[None, :], (s_idx == 0) & rec, kept)
        rank = np.where(exact[None, :], 0, rank)

        # final-column re-record: only for pairs that neither collapsed
        # nor hit the candidate cap
        broke = exact | (total >= max_matches)
        any_reach = reach.any(axis=0)
        first_reach = np.argmax(reach, axis=0)  # min s with reach
        s_f = np.where(any_reach, first_reach, np.maximum(m - 1, 0))
        rows_b = np.arange(B)
        cost_f = cost[s_f, rows_b]
        size_f = size[s_f, rows_b]
        final_ok = (
            (~broke)
            & (m > 0)
            & (size_f >= min_overlap)
            & (cost_f <= thresh[np.clip(size_f, 0, W)])
        )
        return dict(
            cand=cand,
            rank=rank,
            n_cand=cand.sum(axis=0).astype(np.int64),
            final_ok=final_ok,
            final_s=s_f,
            cost=cost,
            size=size,
        )

    def reconstruct(self, counts, refs_u8, reads_u8, lengths):
        """Scalar-format candidate lists (list-of-tuples per pair) built
        from :meth:`candidate_arrays`; the array form is the hot path
        (the turbo insert lane consumes it directly), this converter
        exists for the per-record engine API."""
        arrs = self.candidate_arrays(counts, refs_u8, reads_u8, lengths)
        m = lengths.astype(np.int64)
        B = m.shape[0]
        ss, bs = np.nonzero(arrs["cand"])
        # group candidates by pair, s descending
        order = np.lexsort((-ss, bs))
        ss, bs = ss[order], bs[order]
        bounds = np.searchsorted(bs, np.arange(B + 1))
        results = []
        for b in range(B):
            m_b = int(m[b])
            out = [
                (int(s), m_b, 0, m_b - int(s), int(counts[s, b]),
                 int(arrs["cost"][s, b]))
                for s in ss[bounds[b] : bounds[b + 1]]
            ]
            if arrs["final_ok"][b]:
                s_f = int(arrs["final_s"][b])
                out.append(
                    (s_f, m_b, 0, m_b, int(counts[s_f, b]),
                     int(arrs["cost"][s_f, b]))
                )
            results.append(out or None)
        return results


# ---------------------------------------------------------------------------
# Batched MultiAligner (no-indel top-K; reference ``_align.pyx:548-787``)
# ---------------------------------------------------------------------------


class BatchMultiAligner:
    """Batched no-indel aligner returning up to ``max_matches`` candidates
    per read, used by the paired-end insert matcher.

    Without indels the cell recurrence is a pure diagonal shift
    (``new[i] = old[i-1] + mismatch``), so the column update has no
    within-column dependency at all; only the band bookkeeping and
    candidate recording carry state. Candidate slots are fixed-size
    ([B, K]) with a per-read cursor, written via one-hot selects.
    """

    def __init__(self, max_error_rate, flags=None, min_overlap=1, max_matches=100):
        from atropos_tpu.align.flags import SEMIGLOBAL

        self.max_error_rate = max_error_rate
        self.flags = SEMIGLOBAL if flags is None else flags
        self.min_overlap = min_overlap
        self.max_matches = max_matches
        self._kernels = {}

    def _get_kernel(self, m, L):
        key = (m, L)
        if key not in self._kernels:
            thresholds = _error_thresholds(m, self.max_error_rate)
            self._kernels[key] = jax.jit(
                functools.partial(
                    _multi_locate_kernel,
                    m=m,
                    k=int(self.max_error_rate * m),
                    flags=self.flags,
                    min_overlap=self.min_overlap,
                    max_matches=self.max_matches,
                    thresholds=tuple(int(t) for t in thresholds),
                )
            )
        return self._kernels[key]

    def locate_batch(self, refs_u8, ref_lengths, reads_u8, lengths):
        """Align one (per-read) reference against each read; per-pair
        lengths may all differ. Returns a list of B candidate lists (the
        scalar ``MultiAligner.locate`` format) or None entries.

        The hot configuration — the paired-end insert matcher's flags
        with pair-wise equal lengths — runs through the single
        variable-length diagonal kernel (:class:`BatchInsertMatcher`);
        other flag combinations group by (m, L) shape and reuse the
        banded scan kernel per group.
        """
        refs_u8 = np.asarray(refs_u8)
        reads_u8 = np.asarray(reads_u8)
        ref_lengths = np.asarray(ref_lengths, np.int32)
        lengths = np.asarray(lengths, np.int32)
        batch = lengths.shape[0]

        insert_flags = START_WITHIN_SEQ1 | STOP_WITHIN_SEQ2
        if self.flags == insert_flags and np.array_equal(ref_lengths, lengths):
            matcher = BatchInsertMatcher(
                self.max_error_rate, self.min_overlap, self.max_matches
            )
            return matcher.candidates(refs_u8, reads_u8, lengths)

        results = [None] * batch
        groups = {}
        for b in range(batch):
            groups.setdefault(
                (int(ref_lengths[b]), int(lengths[b])), []
            ).append(b)
        for (m, n), members in groups.items():
            width = max(8, n)
            refs = np.zeros((len(members), m), np.uint8)
            reads = np.zeros((len(members), width), np.uint8)
            for row, b in enumerate(members):
                refs[row] = refs_u8[b, :m]
                reads[row, :n] = reads_u8[b, :n]
            out = self.locate_same_shape(
                refs, reads, m, np.full(len(members), n, np.int32)
            )
            out_np = {key: np.asarray(val) for key, val in out.items()}
            for row, b in enumerate(members):
                results[b] = self.extract(out_np, row)
        return results

    def locate_same_shape(self, refs_u8, reads_u8, m, lengths):
        """Batch where every ref has length m and every read is padded to
        the same width. refs_u8: [B, m]; reads_u8: [B, L]; lengths: [B]
        (query lengths). Returns fixed-K candidate arrays."""
        kernel = self._get_kernel(m, reads_u8.shape[1])
        return kernel(
            jnp.asarray(np.ascontiguousarray(refs_u8.T).astype(np.int32)),
            jnp.asarray(np.ascontiguousarray(reads_u8.T).astype(np.int32)),
            jnp.asarray(np.asarray(lengths, np.int32)),
        )

    @staticmethod
    def extract(out_np, b):
        """Convert kernel output for read ``b`` into the scalar API's
        candidate list (``MultiAligner.locate`` format): a list of
        (refstart, refstop, querystart, querystop, matches, errors)
        tuples, or None. Exact matches collapse to a single candidate,
        reproducing the reference (``_align.pyx:773-776``)."""
        count = int(out_np["count"][b])
        if count == 0:
            return None
        exact = int(out_np["exact"][b])
        slots = (exact,) if exact >= 0 else range(count)
        result = []
        for s in slots:
            origin = int(out_np["origin"][b, s])
            cost = int(out_np["cost"][b, s])
            matches = int(out_np["matches"][b, s])
            ref_stop = int(out_np["ref_stop"][b, s])
            query_stop = int(out_np["query_stop"][b, s])
            if origin >= 0:
                start1, start2 = 0, origin
            else:
                start1, start2 = -origin, 0
            result.append(
                (start1, ref_stop, start2, query_stop, matches, cost)
            )
        return result


def _multi_locate_kernel(
    refs_T,     # [m, B] int32 — per-read reference bytes
    reads_T,    # [L, B] int32
    lengths,    # [B]
    *,
    m,
    k,
    flags,
    min_overlap,
    max_matches,
    thresholds,
):
    from atropos_tpu.align.flags import (
        OVERHANG_MULTIPLIER,
        START_WITHIN_SEQ1,
        START_WITHIN_SEQ2,
        STOP_WITHIN_SEQ1,
        STOP_WITHIN_SEQ2,
    )

    L, batch = reads_T.shape
    start_in_ref = bool(flags & START_WITHIN_SEQ1)
    start_in_query = bool(flags & START_WITHIN_SEQ2)
    stop_in_ref = bool(flags & STOP_WITHIN_SEQ1)
    stop_in_query = bool(flags & STOP_WITHIN_SEQ2)

    K_SLOTS = max_matches + m + 2
    OM = OVERHANG_MULTIPLIER

    n = lengths[None, :].astype(jnp.int32)  # [1, B]
    max_n = n if start_in_query else jnp.minimum(n, m + k)
    min_n = jnp.zeros_like(n) if stop_in_query else jnp.maximum(0, n - m - k)

    rows = jnp.arange(m + 1, dtype=jnp.int32)[:, None]  # [m+1, 1]
    thresh_col = jnp.asarray(np.asarray(thresholds, np.int32))[:, None]

    # initial column (reference ``_align.pyx:646-665``)
    if not start_in_ref and not start_in_query:
        cost0 = jnp.maximum(rows, min_n) * OM
        org0 = jnp.zeros((m + 1, batch), jnp.int32)
    elif start_in_ref and not start_in_query:
        cost0 = jnp.broadcast_to(min_n * OM, (m + 1, batch))
        org0 = jnp.minimum(0, min_n - rows)
    elif not start_in_ref and start_in_query:
        cost0 = jnp.broadcast_to(rows * OM, (m + 1, batch))
        org0 = jnp.maximum(0, min_n - rows)
    else:
        cost0 = jnp.minimum(rows, min_n) * OM
        org0 = min_n - rows
    cost0 = jnp.broadcast_to(cost0, (m + 1, batch)).astype(jnp.int32)
    org0 = jnp.broadcast_to(org0, (m + 1, batch)).astype(jnp.int32)
    mat0 = jnp.zeros((m + 1, batch), jnp.int32)

    last0 = jnp.full((1, batch), m if start_in_ref else min(m, k + 1), jnp.int32)
    done0 = jnp.zeros((1, batch), bool)
    broke0 = jnp.zeros((1, batch), bool)
    count0 = jnp.zeros((1, batch), jnp.int32)
    exact0 = jnp.full((1, batch), -1, jnp.int32)

    slots0 = dict(
        origin=jnp.zeros((K_SLOTS, batch), jnp.int32),
        cost=jnp.zeros((K_SLOTS, batch), jnp.int32),
        matches=jnp.zeros((K_SLOTS, batch), jnp.int32),
        ref_stop=jnp.zeros((K_SLOTS, batch), jnp.int32),
        query_stop=jnp.zeros((K_SLOTS, batch), jnp.int32),
    )
    slot_rows = jnp.arange(K_SLOTS, dtype=jnp.int32)[:, None]

    def record(slots, count, mask, origin, cost, matches, ref_stop, query_stop):
        """Append a candidate at each read's cursor where mask is set."""
        sel = mask & (slot_rows == count)
        upd = lambda arr, val: jnp.where(sel, val, arr)
        slots = dict(
            origin=upd(slots["origin"], origin),
            cost=upd(slots["cost"], cost),
            matches=upd(slots["matches"], matches),
            ref_stop=upd(slots["ref_stop"], ref_stop),
            query_stop=upd(slots["query_stop"], query_stop),
        )
        return slots, count + mask.astype(jnp.int32)

    def column_step(carry, xs):
        cost_c, mat_c, org_c, last, done, broke, count, exact, slots = carry
        j, qc = xs  # qc [1, B]
        active = (j > min_n) & (j <= max_n) & (~done)

        if start_in_query:
            new0_cost = cost_c[0:1]
            new0_org = jnp.full((1, batch), j, jnp.int32)
            new0_mat = mat_c[0:1]
        else:
            new0_cost = jnp.minimum(j * OM, jnp.int32(2 ** 30))[None, None][0]
            new0_cost = jnp.broadcast_to(new0_cost, (1, batch))
            new0_org = org_c[0:1]
            new0_mat = mat_c[0:1]

        eq = refs_T == qc  # [m, B]
        new_cost = jnp.concatenate(
            [new0_cost, cost_c[:-1] + jnp.where(eq, 0, 1)], axis=0
        )
        new_org = jnp.concatenate([new0_org, org_c[:-1]], axis=0)
        new_mat = jnp.concatenate(
            [new0_mat, mat_c[:-1] + eq.astype(jnp.int32)], axis=0
        )

        write = active & (((rows <= last) & (rows >= 1)) | (rows == 0))
        cost_c = jnp.where(write, new_cost, cost_c)
        org_c = jnp.where(write, new_org, org_c)
        mat_c = jnp.where(write, new_mat, mat_c)

        in_band = (rows <= last) & (cost_c <= k)
        L_idx = jnp.max(jnp.where(in_band, rows, -1), axis=0, keepdims=True)
        new_last = jnp.minimum(L_idx + 1, m)

        if stop_in_query:
            at_bottom = active & (L_idx == m)
            cost_m = cost_c[m : m + 1]
            org_m = org_c[m : m + 1]
            mat_m = mat_c[m : m + 1]
            length_m = m + jnp.minimum(org_m, 0)
            thresh_m = jnp.max(
                jnp.where(rows == length_m, thresh_col, -(2 ** 30)),
                axis=0,
                keepdims=True,
            )
            ok = (
                at_bottom
                & (length_m >= min_overlap)
                & (cost_m <= thresh_m)
            )
            slots, count = record(
                slots, count, ok, org_m, cost_m, mat_m,
                jnp.full((1, batch), m, jnp.int32),
                jnp.broadcast_to(j, (1, batch)).astype(jnp.int32),
            )
            is_exact = ok & (cost_m == 0) & (mat_m == m)
            exact = jnp.where(is_exact & (exact < 0), count - 1, exact)
            hit_cap = ok & (count >= max_matches)
            newly_done = is_exact | hit_cap
            broke = broke | (active & newly_done)
            done = done | newly_done

        last = jnp.where(active, new_last, last)
        return (
            cost_c, mat_c, org_c, last, done, broke, count, exact, slots
        ), None

    js = jnp.arange(1, L + 1, dtype=jnp.int32)
    q_cols = reads_T[:, None, :]  # [L, 1, B]
    (cost_c, mat_c, org_c, last, done, broke, count, exact, slots), _ = lax.scan(
        column_step,
        (cost0, mat0, org0, last0, done0, broke0, count0, exact0, slots0),
        (js, q_cols),
    )

    # final-column scan, only for reads that did not break out early
    # (reference for-else semantics, ``_align.pyx:746-763``)
    first_i = 0 if stop_in_ref else m
    do_final = (~broke) & (max_n == n)
    max_cost = m + n
    for i in range(first_i, m + 1):
        cost_i = cost_c[i : i + 1]
        org_i = org_c[i : i + 1]
        mat_i = mat_c[i : i + 1]
        length_i = i + jnp.minimum(org_i, 0)
        thresh_i = jnp.max(
            jnp.where(rows == length_i, thresh_col, -(2 ** 30)),
            axis=0,
            keepdims=True,
        )
        ok = (
            do_final
            & (cost_i <= max_cost)
            & (length_i >= min_overlap)
            & (cost_i <= thresh_i)
        )
        slots, count = record(
            slots, count, ok, org_i, cost_i, mat_i,
            jnp.full((1, batch), i, jnp.int32), jnp.broadcast_to(n, (1, batch)),
        )

    return dict(
        count=count[0],
        exact=exact[0],
        origin=slots["origin"].T,
        cost=slots["cost"].T,
        matches=slots["matches"].T,
        ref_stop=slots["ref_stop"].T,
        query_stop=slots["query_stop"].T,
    )
