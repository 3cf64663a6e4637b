"""atropos_tpu — an accelerator-batched NGS read-trimming framework.

A from-scratch rebuild of the capabilities of Atropos (jdidion/atropos) as
a batched device engine: reads are encoded as padded struct-of-array
device batches, the semi-global adapter-alignment DP runs as one batched
XLA column scan over (reads x adapter-rows), quality trimming is a masked
prefix-scan, statistics are fixed-shape tensors merged with ``psum``
collectives, and multi-device scale-out is data-parallel read sharding
over a ``jax.sharding.Mesh`` instead of fork+Queue multiprocessing.

Layer map (mirrors the reference's layering, reference SURVEY.md §1):

- ``atropos_tpu.util``      — host-side primitives (merge algebra, RMP, ...)
- ``atropos_tpu.align``     — alignment kernels: NumPy oracle + JAX/XLA
- ``atropos_tpu.io``        — sequence I/O (FASTA/FASTQ/SAM), device batches
- ``atropos_tpu.adapters``  — adapter parsing/matching/caching
- ``atropos_tpu.commands``  — trim/detect/error/qc pipelines, CLI, reports
- ``atropos_tpu.parallel``  — device-mesh sharding + collective stat merge
"""

import os

__version__ = "0.1.0"

#: the checkout this package runs from (holds ``.jax_cache``)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class AtroposError(Exception):
    """Base exception for expected errors (analog of the reference's
    ``atropos.AtroposError``)."""


def check_importability():  # pragma: no cover
    """The reference checks its compiled Cython extensions here
    (``atropos/__init__.py``). Our accelerated path is JAX; it is always
    importable, so this only verifies jax presence lazily."""
    try:
        import jax  # noqa: F401
        return True
    except ImportError:
        return False


def configure_compile_cache():
    """Point JAX's persistent compilation cache at
    ``JAX_COMPILATION_CACHE_DIR`` when it is set, else at
    ``<checkout>/.jax_cache``; returns the directory. Called by the
    command-line entry point and the standalone scripts, never by library
    code, so in-process callers keep their own JAX configuration."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path
