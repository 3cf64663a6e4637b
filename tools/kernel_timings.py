"""Device timings of the trim path's kernels and their plain XLA forms.

Each function builds seeded inputs on the device, compiles once (set-up,
not timed), then times ``reps`` calls that each end in
``block_until_ready`` and returns the median seconds per call with the
spread. Used by ``chip_smoke.py`` (phase 2); run alone it prints the
same set:

    python tools/kernel_timings.py

Timings mean something only on the card; on the CPU they time XLA's CPU
backend.
"""
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
#: the turbo driver's device batch (engine/turbo.py MAX_BATCH)
TURBO_BATCH = 32768


def time_call(fn, *args, reps=10):
    """(median seconds, min, max) of ``fn(*args)`` over ``reps`` calls,
    after one untimed warm-up call that compiles."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times), max(times)


def random_reads(batch, read_len, adapter=TRUSEQ, seed=0):
    """[batch, read_len] uint8 ACGT reads, ~half carrying an adapter
    prefix from a random position on (the ``bench.py`` composition)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    arr = bases[rng.integers(0, 4, size=(batch, read_len), dtype=np.uint8)]
    ad = np.frombuffer(adapter.encode(), np.uint8)
    pos = rng.integers(20, read_len - 5, size=batch)
    has = rng.random(batch) < 0.5
    cols = np.arange(read_len)[None, :] - pos[:, None]
    plant = has[:, None] & (cols >= 0) & (cols < len(ad))
    arr[plant] = ad[np.clip(cols, 0, len(ad) - 1)][plant]
    return arr


def dp_timings(batch, read_len, adapter=TRUSEQ, reps=10):
    """Seconds per call of the XLA column scan (``BatchAligner``) on one
    batch of 3'-adapter alignments from device-resident inputs:
    (median, min, max)."""
    import numpy as np

    import jax

    from atropos_tpu.align.batched import BatchAligner
    from atropos_tpu.align.flags import (
        START_WITHIN_SEQ2,
        STOP_WITHIN_SEQ1,
        STOP_WITHIN_SEQ2,
    )

    back = START_WITHIN_SEQ2 | STOP_WITHIN_SEQ2 | STOP_WITHIN_SEQ1
    scan = BatchAligner(adapter, 0.1, back, min_overlap=3)
    reads = jax.device_put(random_reads(batch, read_len, adapter))
    lens = jax.device_put(np.full(batch, read_len, np.int32))
    return time_call(jax.jit(scan.locate_device), reads, lens, reps=reps)


def insert_timings(batch, width, reps=10):
    """Seconds per call of the insert matcher's diagonal counts (the
    ``lax.scan`` with a roll) on ``[width, batch]`` planes: (median, min,
    max)."""
    import jax

    from atropos_tpu.align.batched import _diagonal_match_counts

    args = [jax.device_put(x) for x in insert_planes(batch, width)]
    return time_call(_diagonal_match_counts, *args, reps=reps)


def insert_planes(batch, width, seed=1):
    """Seeded insert-matcher inputs: [W, B] int32 ref/query planes where
    half the pairs overlap with ~2% errors, and [1, B] lengths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    queries = bases[rng.integers(0, 4, size=(width, batch))]
    refs = queries.copy()
    noise = rng.random((width, batch)) < 0.02
    refs[noise] = bases[rng.integers(0, 4, size=int(noise.sum()))]
    shift = rng.integers(0, width // 2, size=batch)
    half = batch // 2
    refs[:, half:] = bases[rng.integers(0, 4, size=(width, batch - half))]
    for s in np.unique(shift[:half]):
        cols = np.nonzero(shift[:half] == s)[0]
        refs[s:, cols] = refs[: width - s, cols]
    lens = rng.integers(width // 2, width + 1, size=(1, batch)).astype(np.int32)
    return refs.astype(np.int32), queries.astype(np.int32), lens


def decode_timings(batch, width, reps=10):
    """Seconds per call of the two forms of the turbo upload's code->byte
    decode: a one-hot select chain over the 4 codes and a ``jnp.take``
    gather from the decode table."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    codes = jax.device_put(
        rng.integers(0, 4, size=(batch, width)).astype(np.int32)
    )
    table = jax.device_put(np.frombuffer(b"ACGT", np.uint8).astype(np.int32))

    @jax.jit
    def one_hot(codes, table):
        acc = jnp.zeros(codes.shape, jnp.int32)
        for code in range(4):
            acc = acc + jnp.where(codes == code, table[code], 0)
        return acc

    @jax.jit
    def take(codes, table):
        return jnp.take(table, codes)

    return {
        "one_hot": time_call(one_hot, codes, table, reps=reps),
        "take": time_call(take, codes, table, reps=reps),
    }


if __name__ == "__main__":
    from atropos_tpu import configure_compile_cache

    configure_compile_cache()
    for read_len in (100, 150):
        for batch in (TURBO_BATCH, 8 * TURBO_BATCH):
            print("dp scan", read_len, batch, dp_timings(batch, read_len))
    for batch in (TURBO_BATCH, 8 * TURBO_BATCH):
        print("insert counts", batch, insert_timings(batch, 128))
    print("decode", TURBO_BATCH, decode_timings(TURBO_BATCH, 128))
