"""Packed-integer k-mer machinery for contaminant detection.

The reference counts k-mers as Python string slices in dicts
(``atropos/commands/detect/__init__.py:552-744``). Here every window is
packed into a base-5 integer code (A,C,G,T,N -> 0..4) with one
sliding-window matrix multiply, and counting/membership reduce to sorts
and run-length scans over flat int64 arrays — the same shape as a device
segment-sum, and vectorized on host via numpy. Sequences containing
bytes outside ACGTN (or k-mers too long to pack, k > 27) fall back to
string slicing so observable behavior never changes.
"""
import functools

import numpy as np

from atropos_tpu.align import backend

_CODES = np.full(256, 4, np.int64)
for _i, _base in enumerate(b"ACGT"):
    _CODES[_base] = _i
_ALPHABET = "ACGTN"
_VALID = frozenset(_ALPHABET)

#: largest k such that 5**k fits in int64
MAX_PACKED_K = 27

#: largest k such that 5**k fits in int32 (device sorts run in int32,
#: JAX's default integer width)
MAX_DEVICE_K = 13

#: telemetry: k-mer batches whose sort+count (``batches``) or batched
#: contaminant intersections (``intersect_batches``) ran on device
DEVICE_KMER_COUNTS = {"batches": 0, "intersect_batches": 0}

_DEVICE_MIN_CODES = 1 << 14
_SENTINEL32 = np.int32(2 ** 31 - 1)


@functools.lru_cache(maxsize=None)
def _device_count_fn(size):
    """Device sort + run-length count over a padded code vector.

    Fixed-shape segment counting (the device image of a segment-sum over
    sorted codes, reference semantics
    ``atropos/commands/detect/__init__.py:552-744``): boundaries come
    from a shifted compare, each run's length from the distance to the
    NEXT boundary, computed with a reversed inclusive cummin over start
    positions. The host then only compacts by the boundary mask.
    """
    import jax
    import jax.numpy as jnp

    def count(codes):
        ordered = jnp.sort(codes)
        pos = jnp.arange(size, dtype=jnp.int32)
        is_start = jnp.concatenate(
            [jnp.ones(1, bool), ordered[1:] != ordered[:-1]]
        )
        start_pos = jnp.where(is_start, pos, jnp.int32(size))
        # next boundary at-or-after each position, then shift left by one
        # to get the boundary strictly after i
        next_at = jax.lax.cummin(start_pos[::-1])[::-1]
        next_after = jnp.concatenate(
            [next_at[1:], jnp.full(1, size, jnp.int32)]
        )
        counts = jnp.where(is_start, next_after - pos, 0)
        return ordered, is_start, counts

    return jax.jit(count)


def _unique_counts(flat):
    """(codes, counts) over a flat packed-code array.

    When the codes fit int32 (k <= MAX_DEVICE_K) and the array is
    large, the sort AND the run-length counting run on device; the host
    only compacts by the returned boundary mask.
    """
    if (
        flat.size >= _DEVICE_MIN_CODES
        and flat.size
        and flat.max() < 2 ** 31 - 1
        and backend.use_device_kmers()
    ):
        import jax.numpy as jnp

        size = 1 << (flat.size - 1).bit_length()
        padded = np.full(size, _SENTINEL32, np.int32)
        padded[: flat.size] = flat.astype(np.int32)
        ordered, is_start, counts = (
            np.asarray(arr)
            for arr in _device_count_fn(size)(jnp.asarray(padded))
        )
        DEVICE_KMER_COUNTS["batches"] += 1
        # pads (sentinel) sort after every real code into their own run,
        # so masking them cannot disturb any real run's count
        keep = is_start & (ordered != _SENTINEL32)
        return ordered[keep].astype(np.int64), counts[keep].astype(np.int64)
    return np.unique(flat, return_counts=True)


def packable(seq, k):
    """Whether ``seq``'s k-mers can be represented as packed codes."""
    return k <= MAX_PACKED_K and not (set(seq) - _VALID)


def pack_windows(seq, k):
    """int64 codes of every k-window of ``seq`` (caller checks packable)."""
    data = _CODES[np.frombuffer(seq.encode("ascii"), np.uint8)]
    n_windows = data.shape[0] - k + 1
    if n_windows <= 0:
        return np.empty(0, np.int64)
    powers = 5 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(data, k)
    return windows @ powers


def unpack(code, k):
    """Inverse of pack_windows for a single code."""
    out = []
    for _ in range(k):
        code, digit = divmod(code, 5)
        out.append(_ALPHABET[digit])
    return "".join(reversed(out))


def packed_kmer_set(seq, k):
    """Sorted unique packed codes of ``seq`` (or None if unpackable)."""
    if not packable(seq, k):
        return None
    return np.unique(pack_windows(seq, k))


def count_corpus(seqs, k, with_membership=False):
    """Count every k-mer occurrence across ``seqs``.

    Returns {kmer_string: count} or, with membership,
    {kmer_string: (count, set_of_seqs)} — the exact structures the
    detection algorithms consume. Packed counting handles the ACGTN
    sequences in one vectorized pass; the rest go through string slicing.
    """
    seqs = list(seqs)
    packed_codes = []
    packed_owner = []
    slow = []
    for idx, seq in enumerate(seqs):
        if packable(seq, k):
            codes = pack_windows(seq, k)
            packed_codes.append(codes)
            if with_membership:
                packed_owner.append(np.full(codes.shape[0], idx, np.int64))
        else:
            slow.append(idx)

    table = {}
    if packed_codes:
        flat = np.concatenate(packed_codes)
        codes, counts = _unique_counts(flat)
        if with_membership:
            owners = np.concatenate(packed_owner)
            # unique (code, owner) pairs -> membership lists per code
            pair_codes, pair_owners = _unique_pairs(flat, owners)
            boundaries = np.searchsorted(pair_codes, codes)
            boundaries = np.append(boundaries, pair_codes.shape[0])
            for row, code in enumerate(codes):
                members = pair_owners[boundaries[row] : boundaries[row + 1]]
                table[unpack(int(code), k)] = [
                    int(counts[row]),
                    {seqs[owner] for owner in members},
                ]
        else:
            for row, code in enumerate(codes):
                table[unpack(int(code), k)] = int(counts[row])

    for idx in slow:
        seq = seqs[idx]
        for start in range(len(seq) - k + 1):
            kmer = seq[start : start + k]
            if with_membership:
                entry = table.setdefault(kmer, [0, set()])
                entry[0] += 1
                entry[1].add(seq)
            else:
                table[kmer] = table.get(kmer, 0) + 1
    return table


def _unique_pairs(codes, owners):
    """Unique (code, owner) pairs, sorted by code then owner."""
    order = np.lexsort((owners, codes))
    codes = codes[order]
    owners = owners[order]
    keep = np.ones(codes.shape[0], bool)
    keep[1:] = (codes[1:] != codes[:-1]) | (owners[1:] != owners[:-1])
    return codes[keep], owners[keep]


def intersection_size(set_a, set_b):
    """|A ∩ B| for two sorted unique code arrays."""
    return np.intersect1d(set_a, set_b, assume_unique=True).shape[0]


@functools.lru_cache(maxsize=None)
def _device_intersect_fn(n_contam, c_max, r_max):
    """All-pairs sorted-set intersection sizes on device.

    For every (contaminant, read) pair: count read codes present in the
    contaminant's sorted code set via a vectorized binary-search
    membership test — one op for the whole contaminant panel instead of
    the reference's per-read per-contaminant Python set intersection
    (``atropos/commands/detect/__init__.py:231-286``).
    """
    import jax
    import jax.numpy as jnp

    def intersect(contams, reads):
        # contams: [M, Cmax] int32 sorted, sentinel-padded
        # reads: [R, Rmax] int32 sorted, sentinel-padded
        def one_pair(contam_row, read_row):
            idx = jnp.searchsorted(contam_row, read_row)
            hit = (
                contam_row[jnp.clip(idx, 0, c_max - 1)] == read_row
            ) & (read_row != _SENTINEL32)
            return jnp.sum(hit.astype(jnp.int32))

        per_contam = jax.vmap(one_pair, in_axes=(None, 0))
        return jax.vmap(per_contam, in_axes=(0, None))(contams, reads)

    return jax.jit(intersect)


def batch_intersections(contam_sets, read_sets):
    """[M, R] intersection-size matrix between contaminant and read
    packed-code sets (device when enabled and worthwhile, host numpy
    otherwise). All inputs are sorted unique int code arrays."""
    n_contam = len(contam_sets)
    n_reads = len(read_sets)
    out = np.zeros((n_contam, n_reads), np.int64)
    if not n_contam or not n_reads:
        return out
    c_max = max(arr.shape[0] for arr in contam_sets)
    r_max = max((arr.shape[0] for arr in read_sets), default=0)
    max_code = max(
        max((int(arr[-1]) for arr in contam_sets if arr.size), default=0),
        max((int(arr[-1]) for arr in read_sets if arr.size), default=0),
    )
    if (
        backend.use_device_kmers()
        and max_code < 2 ** 31 - 1
        and c_max > 0
        and r_max > 0
        and n_contam * n_reads >= 256
    ):
        import jax.numpy as jnp

        contams = np.full((n_contam, c_max), _SENTINEL32, np.int32)
        for row, arr in enumerate(contam_sets):
            contams[row, : arr.shape[0]] = arr.astype(np.int32)
        reads = np.full((n_reads, r_max), _SENTINEL32, np.int32)
        for row, arr in enumerate(read_sets):
            reads[row, : arr.shape[0]] = arr.astype(np.int32)
        fn = _device_intersect_fn(n_contam, c_max, r_max)
        out[:] = np.asarray(fn(jnp.asarray(contams), jnp.asarray(reads)))
        DEVICE_KMER_COUNTS["intersect_batches"] += 1
        return out
    for m_idx, contam in enumerate(contam_sets):
        for r_idx, read in enumerate(read_sets):
            out[m_idx, r_idx] = intersection_size(contam, read)
    return out
