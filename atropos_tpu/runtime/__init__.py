"""Native runtime: C++ FASTQ parser/formatter with ctypes bindings.

Compiles ``fastq.cpp`` on first import into ``_build/`` next to the
source (git-ignored). The library's file name carries a key of what
built it — the source, the compiler command and the host CPU — so a
checkout copied to another machine, or an edited source, builds afresh
instead of loading a library made for another CPU. Falls back to None
exports if no compiler is available — callers must then use the Python
I/O path.
"""
import ctypes
import hashlib
import logging
import os
import platform
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastq.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _host_cpu():
    """What ``-march=native`` resolves against: the CPU model and its
    feature flags (Linux), else the platform's processor string."""
    try:
        with open("/proc/cpuinfo") as handle:
            lines = [
                line for line in handle
                if line.startswith(("model name", "flags"))
            ]
        return "".join(lines[:2])
    except OSError:
        return platform.processor() + platform.machine()


def library_path(source=_SRC, flags=_FLAGS, cpu=None):
    """The keyed path of the library built from ``source`` with
    ``flags`` on this CPU."""
    digest = hashlib.sha256()
    with open(source, "rb") as handle:
        digest.update(handle.read())
    digest.update(" ".join(flags).encode())
    digest.update((_host_cpu() if cpu is None else cpu).encode())
    return os.path.join(
        _BUILD_DIR, "libfastq-%s.so" % digest.hexdigest()[:16]
    )


def _build(lib_path):
    """Compile to a private name, then move into place atomically, so
    concurrent first imports never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib_path, os.getpid())
    cmd = ["g++"] + list(_FLAGS) + [_SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib_path)


def _load():
    try:
        lib_path = library_path()
        if not os.path.exists(lib_path):
            _build(lib_path)
        lib = ctypes.CDLL(lib_path)
    except Exception as exc:  # pragma: no cover - no toolchain
        logging.getLogger(__name__).warning(
            "native fastq runtime unavailable (%s); using Python I/O", exc
        )
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    lib.fastq_parse.restype = ctypes.c_int64
    lib.fastq_parse.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64,
        i64p, i32p, i64p, i32p, i64p, i32p, i64p, i32p, i64p,
    ]
    lib.gather_padded.restype = None
    lib.gather_padded.argtypes = [
        u8p, i64p, i32p, ctypes.c_int64, ctypes.c_int64, u8p,
    ]
    lib.fasta_parse.restype = ctypes.c_int64
    lib.fasta_parse.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i32p, i64p, i32p, i64p, u8p, i64p, i64p,
    ]
    lib.fasta_format_trimmed.restype = ctypes.c_int64
    lib.fasta_format_trimmed.argtypes = [
        u8p, i64p, i32p, i64p,
        i32p, i32p, u8p, ctypes.c_int64,
        u8p, ctypes.c_int64,
    ]
    lib.scan_alphabet.restype = None
    lib.scan_alphabet.argtypes = [u8p, i64p, i32p, ctypes.c_int64, u8p]
    lib.quality_trim_windows.restype = None
    lib.quality_trim_windows.argtypes = [
        u8p, i64p, i64p, i32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p,
    ]
    lib.gather_packed.restype = None
    lib.gather_packed.argtypes = [
        u8p, i64p, i32p, ctypes.c_int64, ctypes.c_int64,
        u8p, ctypes.c_int64, u8p,
    ]
    lib.fastq_format_trimmed.restype = ctypes.c_int64
    lib.fastq_format_trimmed.argtypes = [
        u8p,
        i64p, i32p, i64p, i64p, i32p, i64p,
        i32p, i32p, u8p, ctypes.c_int64,
        u8p, ctypes.c_int64,
        u8p, i64p, i64p, i64p,
        i64p, i32p, i64p, i32p,
    ]
    return lib


_lib = _load()


def available():
    return _lib is not None


def _u8(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class FastqChunk:
    """Parsed index over a raw FASTQ buffer."""

    __slots__ = (
        "buf", "n", "consumed",
        "name_off", "name_len", "seq_off", "seq_len",
        "plus_off", "plus_len", "qual_off", "qual_len",
        "_alphabet",
    )

    def __init__(self, buf, n, consumed, arrays):
        self.buf = buf
        self.n = n
        self.consumed = consumed
        self._alphabet = None
        (
            self.name_off, self.name_len,
            self.seq_off, self.seq_len,
            self.plus_off, self.plus_len,
            self.qual_off, self.qual_len,
        ) = arrays

    @property
    def alphabet(self):
        """Sorted array of distinct sequence byte values in this chunk
        (computed once, native scan)."""
        if self._alphabet is None:
            present = np.zeros(256, np.uint8)
            if self.n:
                _lib.scan_alphabet(
                    _u8(self.buf), _i64(self.seq_off), _i32(self.seq_len),
                    self.n, _u8(present),
                )
            self._alphabet = np.nonzero(present)[0].astype(np.uint8)
        return self._alphabet

    def padded_sequences(self, width=None):
        """Zero-padded [n, width] uint8 matrix of the sequences."""
        if width is None:
            width = int(self.seq_len.max()) if self.n else 0
        out = np.zeros((self.n, width), dtype=np.uint8)
        _lib.gather_padded(
            _u8(self.buf), _i64(self.seq_off), _i32(self.seq_len),
            self.n, width, _u8(out),
        )
        return out

    def padded_qualities(self, width=None):
        if width is None:
            width = int(self.qual_len.max()) if self.n else 0
        out = np.zeros((self.n, width), dtype=np.uint8)
        _lib.gather_padded(
            _u8(self.buf), _i64(self.qual_off), _i32(self.qual_len),
            self.n, width, _u8(out),
        )
        return out

    def format_trimmed(self, keep_start, keep_stop, keep=None):
        """Assemble trimmed FASTQ bytes for kept records."""
        keep_start = np.ascontiguousarray(keep_start, dtype=np.int32)
        keep_stop = np.ascontiguousarray(keep_stop, dtype=np.int32)
        if keep is None:
            keep = np.ones(self.n, dtype=np.uint8)
        else:
            keep = np.ascontiguousarray(keep, dtype=np.uint8)
        cap = int(
            self.n * 8
            + self.name_len.sum()
            + self.plus_len.sum()
            + 2 * np.maximum(keep_stop - keep_start, 0).sum()
        ) + 16
        out = np.empty(cap, dtype=np.uint8)
        written = _lib.fastq_format_trimmed(
            _u8(self.buf),
            _i64(self.name_off), _i32(self.name_len),
            _i64(self.seq_off),
            _i64(self.plus_off), _i32(self.plus_len),
            _i64(self.qual_off),
            _i32(keep_start), _i32(keep_stop), _u8(keep),
            self.n,
            _u8(out), cap,
            None, None, None, None, None, None, None, None,
        )
        if written < 0:
            raise RuntimeError("fastq_format_trimmed: output capacity exceeded")
        return out[:written].tobytes()


class FastqParseError(Exception):
    pass


class FastaParseError(Exception):
    """Malformed FASTA content; ``offset`` is the offending line's byte
    offset in the parsed buffer (for exact error-message reconstruction)."""

    def __init__(self, message, offset):
        super().__init__(message)
        self.offset = offset


def parse_fasta_chunk(buf, final=False, max_records=None):
    """Parse a bytes/ndarray FASTA buffer into a :class:`FastqChunk`
    (qual/plus fields zeroed; ``chunk.buf`` is a NORMALIZED buffer with
    names and compacted sequences — wrapped records become contiguous).

    Unless ``final``, the trailing record is left unconsumed (a record
    only completes at the next '>' line); ``chunk.consumed`` reports the
    input bytes used.
    """
    if _lib is None:
        raise RuntimeError("native fastq runtime not available")
    if isinstance(buf, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if max_records is None:
        max_records = max(16, int(np.count_nonzero(buf == ord(">"))) + 2)
    name_off = np.empty(max_records, np.int64)
    name_len = np.empty(max_records, np.int32)
    seq_off = np.empty(max_records, np.int64)
    seq_len = np.empty(max_records, np.int32)
    consumed = np.zeros(1, np.int64)
    out = np.empty(buf.size + 1, np.uint8)
    out_used = np.zeros(1, np.int64)
    err_off = np.zeros(1, np.int64)
    n = _lib.fasta_parse(
        _u8(buf), buf.size, max_records, 1 if final else 0,
        _i64(name_off), _i32(name_len),
        _i64(seq_off), _i32(seq_len),
        _i64(consumed), _u8(out), _i64(out_used), _i64(err_off),
    )
    if n == -1:
        raise FastaParseError(
            "FASTA content line outside any record", int(err_off[0])
        )
    if n < 0:
        raise FastqParseError(_ERRORS.get(int(n), "unknown error {}".format(n)))
    n = int(n)
    zeros64 = np.zeros(n, np.int64)
    zeros32 = np.zeros(n, np.int32)
    arrays = (
        name_off[:n], name_len[:n],
        seq_off[:n], seq_len[:n],
        zeros64, zeros32,          # plus
        zeros64.copy(), zeros32.copy(),  # qual
    )
    return FastqChunk(out, n, int(consumed[0]), arrays)


_ERRORS = {
    -1: "malformed record start (expected '@')",
    -2: "missing '+' separator line",
    -3: "sequence/quality length mismatch",
    -4: "record capacity exceeded",
}


def parse_chunk(buf, max_records=None):
    """Parse a bytes/ndarray FASTQ buffer into a :class:`FastqChunk`.

    The final record must be complete (ends with a newline or the chunk
    is truncated before it; ``chunk.consumed`` reports how many bytes were
    used, so streaming callers can carry the remainder forward).
    """
    if _lib is None:
        raise RuntimeError("native fastq runtime not available")
    if isinstance(buf, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if max_records is None:
        # exact bound from the newline count (4 lines per record); the
        # byte scan is ~memory-bandwidth, far cheaper than allocating
        # index arrays for the worst-case 8-bytes-per-record estimate
        max_records = max(16, int(np.count_nonzero(buf == 10)) // 4 + 2)
    name_off = np.empty(max_records, np.int64)
    name_len = np.empty(max_records, np.int32)
    seq_off = np.empty(max_records, np.int64)
    seq_len = np.empty(max_records, np.int32)
    plus_off = np.empty(max_records, np.int64)
    plus_len = np.empty(max_records, np.int32)
    qual_off = np.empty(max_records, np.int64)
    qual_len = np.empty(max_records, np.int32)
    consumed = np.zeros(1, np.int64)
    n = _lib.fastq_parse(
        _u8(buf), buf.size, max_records,
        _i64(name_off), _i32(name_len),
        _i64(seq_off), _i32(seq_len),
        _i64(plus_off), _i32(plus_len),
        _i64(qual_off), _i32(qual_len),
        _i64(consumed),
    )
    if n < 0:
        raise FastqParseError(_ERRORS.get(int(n), "unknown error {}".format(n)))
    n = int(n)
    arrays = tuple(
        arr[:n]
        for arr in (
            name_off, name_len, seq_off, seq_len,
            plus_off, plus_len, qual_off, qual_len,
        )
    )
    return FastqChunk(buf, n, int(consumed[0]), arrays)
