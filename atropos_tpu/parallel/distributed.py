"""Multi-host scale-out over the JAX distributed runtime.

This is the device-runtime replacement for the reference's fork+Queue
parallelism (``atropos/commands/multicore.py``; architecture narrative at
``atropos/commands/trim/__init__.py:693-750``). The mapping:

- the reader/feeder process  -> per-host input sharding: every host
  streams the same input and owns batches where ``index % hosts == rank``
  (zero coordination; no batch is read twice into device memory);
- worker processes           -> hosts (each trims its shard with the same
  serial/turbo pipeline and device kernels);
- parallel-write mode        -> per-host output shard files
  (``output.<rank>``), the reference's fastest mode;
- pickled-summary Queue      -> byte-tensor allgather over the
  collective fabric (Gloo on CPU hosts, NCCL between GPUs), merged with
  the same ``merge_dicts`` algebra.

Activation: run one process per host with ``jax.distributed.initialize``
(explicit coordinator/rank arguments — see :func:`initialize`), then
invoke the normal CLI. The trim
command detects ``jax.process_count() > 1`` and shards automatically.
"""
import logging
import pickle

import numpy as np


def initialize(coordinator=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """Initialize the JAX distributed runtime.

    Pass ``coordinator`` ("host:port"), ``num_processes`` and
    ``process_id``: nothing on a CPU or GPU cluster tells JAX of them.
    Safe to call when already initialized (no-op)."""
    import jax

    if jax.process_count() > 1:
        return
    kwargs = {}
    if coordinator is not None:
        kwargs.update(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    if local_device_ids is not None:
        kwargs.update(local_device_ids=local_device_ids)
    jax.distributed.initialize(**kwargs)


def process_info():
    """(process_id, process_count) of the current JAX runtime; (0, 1)
    when the distributed runtime is not initialized."""
    try:
        import jax

        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def shard_batches(batch_iter, process_id, process_count):
    """Round-robin batch ownership: yield only the batches this host owns.

    Batch metadata indices are global (assigned by the reader), so the
    writer-side batch audit still sees a contiguous global numbering."""
    for batch in batch_iter:
        if batch[0]["index"] % process_count == process_id:
            yield batch


def allgather_object(obj):
    """Exchange an arbitrary picklable object across all hosts; returns
    the list of objects ordered by process id.

    JAX collectives move arrays, not objects, so this pads each host's
    pickle to the global max length and allgathers bytes — the distributed
    analog of the reference's summary Queue (``multicore.py:255``)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    nprocs = jax.process_count()
    if nprocs == 1:
        return [obj]

    payload = np.frombuffer(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), dtype=np.uint8
    )
    size = np.asarray([payload.size], dtype=np.int32)
    all_sizes = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(size))
    ).reshape(nprocs)
    width = int(all_sizes.max())
    padded = np.zeros(width, np.uint8)
    padded[: payload.size] = payload
    gathered = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(padded))
    ).reshape(nprocs, width)
    return [
        pickle.loads(gathered[rank, : all_sizes[rank]].tobytes())
        for rank in range(nprocs)
    ]


def merge_summaries(local_summary):
    """Allgather every host's summary dict and merge them with the same
    typed merge algebra the reference uses for worker summaries
    (``atropos/commands/multicore.py:368-389`` ->
    ``atropos/util/__init__.py:401-464``).

    ``timing`` is per-host (the reference's workers never carry one) and
    is excluded from the exchange; the caller keeps its local timing."""
    from atropos_tpu.util import merge_dicts

    payload = {
        key: value for key, value in local_summary.items() if key != "timing"
    }
    summaries = allgather_object(payload)
    merged = summaries[0]
    for other in summaries[1:]:
        merge_dicts(merged, other)
    return merged


def barrier(name="atropos"):
    """Cross-host synchronization point (e.g. before process 0 writes the
    merged report)."""
    import jax
    from jax.experimental import multihost_utils

    if jax.process_count() > 1:
        multihost_utils.sync_global_devices(name)


def log_topology():
    import jax

    logging.getLogger().info(
        "Distributed trim: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )
