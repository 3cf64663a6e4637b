"""Which implementation runs the device work: decided here, once.

Every caller that picks between two forms of a device step, or between
a device path and a host path, reads these functions, so one platform
test governs the whole program:

- ``"gpu"`` (an NVIDIA card through JAX's CUDA plugin): the device
  paths of ``qc`` and ``detect``;
- any other platform: their host paths.

The trim path's device work (adapter DP, insert matcher, quality
trimming) is plain XLA (:mod:`.batched`) on every platform.

Each choice has one environment switch that forces it either way
(``ATROPOS_TPU_DEVICE_STATS``, ``ATROPOS_TPU_DEVICE_KMERS``:
``0``/``1``). Tests use them to compare the two paths on the CPU.

A device backend that fails to initialise raises here: nothing falls
back to the CPU behind the caller's back.
"""
import os

_OFF = ("0", "false", "no", "off")


def platform():
    """The platform of the default JAX device (``"gpu"``, ``"cpu"``)."""
    import jax

    return jax.default_backend()


def _choose(switch):
    value = os.environ.get(switch)
    if value is None:
        return platform() == "gpu"
    return value.strip().lower() not in _OFF


def use_device_stats():
    """``qc`` per-position byte counts on the device or on the host."""
    return _choose("ATROPOS_TPU_DEVICE_STATS")


def use_device_kmers():
    """``detect`` k-mer sort and count on the device or on the host."""
    return _choose("ATROPOS_TPU_DEVICE_KMERS")
