"""The one place that picks device implementations, and what rides on it:
the per-platform choice, turbo's batch padding, the compile-cache rule,
the native library's build key, CPU-held worker processes and the smoke
script's refusal to run without a GPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from atropos_tpu.align import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SWITCHES = {
    backend.use_device_stats: "ATROPOS_TPU_DEVICE_STATS",
    backend.use_device_kmers: "ATROPOS_TPU_DEVICE_KMERS",
}


@pytest.mark.parametrize("choice", list(_SWITCHES), ids=lambda f: f.__name__)
@pytest.mark.parametrize(
    "platform,switch,expected",
    [
        ("gpu", None, True),
        ("cpu", None, False),
        ("gpu", "0", False),
        ("cpu", "1", True),
    ],
)
def test_choice_per_platform(monkeypatch, choice, platform, switch, expected):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    name = _SWITCHES[choice]
    if switch is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, switch)
    assert choice() is expected


def test_platform_is_the_jax_backend():
    import jax

    assert backend.platform() == jax.default_backend() == "cpu"


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_make_batch_aligner_per_platform(monkeypatch, platform):
    """The adapter DP is the XLA scan on every platform."""
    from atropos_tpu.adapters import Adapter, BACK
    from atropos_tpu.align.batched import BatchAligner
    from atropos_tpu.engine import make_batch_aligner

    monkeypatch.setattr(backend, "platform", lambda: platform)
    aligner = make_batch_aligner(
        Adapter("AGATCGGAAGAGCACACGTCTGAACTCCAGTCA", BACK, 0.1)
    )
    assert type(aligner) is BatchAligner


_HAND_KERNEL_CODE = re.compile(
    r"jax\.experimental\.pallas|pallas_call|memory_space|interpret=True"
)


def test_device_path_is_plain_xla():
    """No module of the program, the bench, the tools or the smoke script
    imports Pallas, places blocks in a memory space or asks for
    interpret mode: the device path is plain XLA, which compiles for
    every backend."""
    files = [os.path.join(REPO, "bench.py"), os.path.join(REPO, "chip_smoke.py")]
    for root in ("atropos_tpu", "tools"):
        for dirpath, _, names in os.walk(os.path.join(REPO, root)):
            files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as handle:
            found = _HAND_KERNEL_CODE.search(handle.read())
        assert found is None, (path, found and found.group(0))


class _Mesh:
    def __init__(self, ndev):
        self.devices = np.empty(ndev)


@pytest.mark.parametrize("ndev", [1, 4, 8])
@pytest.mark.parametrize("batch", [1, 100, 5000, 20000, 32768])
def test_turbo_batch_padding(monkeypatch, ndev, batch):
    """Turbo's device batch: a power of two, at least the batch and 64,
    and a whole number of rows on every device of the mesh."""
    from atropos_tpu import parallel
    from atropos_tpu.engine.turbo import _MateLane

    monkeypatch.setattr(
        parallel, "data_parallel_mesh",
        lambda: _Mesh(ndev) if ndev > 1 else None,
    )
    size = _MateLane._pad_batch(None, batch)
    assert size >= max(batch, 64) and size & (size - 1) == 0
    assert size % ndev == 0
    assert size < 2 * max(batch, 64)


@pytest.mark.parametrize("preset", [None, "elsewhere"])
def test_compile_cache_rule(monkeypatch, tmp_path, preset):
    import jax

    import atropos_tpu

    previous = jax.config.jax_compilation_cache_dir
    if preset is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expected = os.path.join(REPO, ".jax_cache")
    else:
        expected = str(tmp_path / preset)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", expected)
    try:
        assert atropos_tpu.configure_compile_cache() == expected
        assert jax.config.jax_compilation_cache_dir == expected
    finally:
        jax.config.update("jax_compilation_cache_dir", previous)


def test_native_library_key():
    """The library is keyed to its source, flags and CPU, and lives in a
    git-ignored build directory."""
    from atropos_tpu import runtime

    base = runtime.library_path(cpu="cpu-a")
    assert base == runtime.library_path(cpu="cpu-a")
    assert base != runtime.library_path(cpu="cpu-b")
    assert base != runtime.library_path(flags=("-O2",), cpu="cpu-a")
    assert os.path.dirname(base) == runtime._BUILD_DIR
    with open(os.path.join(REPO, ".gitignore")) as handle:
        assert "atropos_tpu/runtime/_build/" in handle.read().split()
    if runtime.available():
        assert os.path.exists(runtime.library_path())


def _report_platform(queue):
    queue.put(os.environ.get("JAX_PLATFORMS"))


def test_spawned_workers_start_on_the_cpu(monkeypatch):
    """Worker and writer processes start with JAX_PLATFORMS=cpu, whatever
    the parent holds; the parent's environment is left as it was."""
    from atropos_tpu.commands import multicore

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    queue = multicore.Queue()
    proc = multicore.Process(target=_report_platform, args=(queue,))
    proc.start()
    try:
        assert queue.get(timeout=60) == "cpu"
    finally:
        proc.join(60)
    assert os.environ["JAX_PLATFORMS"] == "cuda"
    assert issubclass(multicore.WorkerProcess, multicore.Process)
    assert issubclass(multicore.ResultProcess, multicore.Process)


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_the_cpu():
    proc = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_needs_the_repo(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
