"""ctypes bindings for the C++ host runtime (``native/disq_host.cpp``).

The port builds its own copy of the shared library from the unedited
source with ``g++`` into the package's git-ignored ``_build`` directory
on first use, with libdeflate where the machine has it and zlib alone
where it does not. The library is named by a digest of the source, the
build variant's flags, the compiler's identity and the host
(``library_path``), so a library that another machine, compiler or
variant built is never loaded; a checkout copied between machines
builds its own. When no toolchain is present the load raises
``ImportError`` and every caller takes its numpy/zlib path — these are
host helpers, and the fallback is the reference's own host behaviour.

Byte-identity note: deflate uses zlib with the pinned parameters (level
6, memLevel 8, raw), so outputs match whichever path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "disq_host.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_CXX = "g++"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# the build variants in order of preference: with libdeflate, zlib alone
VARIANTS = (
    ("-DDISQ_HAVE_LIBDEFLATE", "-ldeflate", "-lz", "-pthread"),
    ("-lz", "-pthread"),
)

_lock = threading.Lock()
_lib = None
_load_error: Exception | None = None


def compiler_id() -> str:
    """The compiler's version banner and target, as it reports them."""
    out = [subprocess.run([_CXX, arg], check=True, capture_output=True,
                          text=True).stdout.strip()
           for arg in ("--version", "-dumpmachine")]
    return "\n".join(out)


def host_id() -> str:
    """The machine: its name, architecture and operating system."""
    return " ".join((platform.node(), platform.machine(), platform.platform()))


def library_path(flags: Sequence[str], compiler: str, host: str) -> str:
    """Where the host library built with ``flags`` by ``compiler`` on
    ``host`` lives: named by a digest of the source and all three."""
    digest = hashlib.sha1()
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    for part in (" ".join(flags), compiler, host):
        digest.update(b"\0" + part.encode())
    return os.path.join(BUILD_DIR, f"libdisq_host-{digest.hexdigest()[:12]}.so")


def _build(paths: List[str]) -> str:
    """Build the first variant that compiles and links here into its
    path; returns that path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    err = None
    for variant, path in zip(VARIANTS, paths):
        # a unique temp name per process, published with an atomic
        # replace: concurrent first-use builds never interleave
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run([_CXX, *_FLAGS, _SRC, "-o", tmp, *variant],
                           check=True, capture_output=True)
            os.replace(tmp, path)
            return path
        except subprocess.CalledProcessError as e:
            err = e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    raise err


def _bind(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.disq_scan_bam_offsets.restype = ctypes.c_int64
    lib.disq_scan_bam_offsets.argtypes = [u8p, ctypes.c_int64, i64p, ctypes.c_int64]
    lib.disq_count_bam_records.restype = ctypes.c_int64
    lib.disq_count_bam_records.argtypes = [u8p, ctypes.c_int64]
    lib.disq_bgzf_walk.restype = ctypes.c_int64
    lib.disq_bgzf_walk.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p, ctypes.c_int64,
    ]
    lib.disq_bgzf_inflate_many.restype = ctypes.c_int64
    lib.disq_bgzf_inflate_many.argtypes = [
        u8p, i64p, i32p, i32p, i32p, ctypes.c_int64, u8p, i64p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.disq_bgzf_deflate_many.restype = ctypes.c_int64
    lib.disq_bgzf_deflate_many.argtypes = [
        u8p, i64p, ctypes.c_int64, u8p, ctypes.c_int64, i32p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.disq_bam_fixed_columns.restype = ctypes.c_int64
    lib.disq_bam_fixed_columns.argtypes = [
        u8p, ctypes.c_int64, i64p, ctypes.c_int64, i32p, i32p, u8p,
        u16p, u16p, i32p, i32p, i32p, i64p, i64p, i64p, i64p,
    ]
    lib.disq_bam_fill_ragged.restype = ctypes.c_int64
    lib.disq_bam_fill_ragged.argtypes = [
        u8p, i64p, ctypes.c_int64, i64p, u8p, i64p, u32p, i64p, u8p,
        u8p, i64p, u8p,
    ]
    lib.disq_rans_encode0.restype = ctypes.c_int64
    lib.disq_rans_encode0.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    lib.disq_rans_encode1.restype = ctypes.c_int64
    lib.disq_rans_encode1.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    lib.disq_rans_decode.restype = ctypes.c_int64
    lib.disq_rans_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    lib.disq_bam_encode.restype = ctypes.c_int64
    lib.disq_bam_encode.argtypes = [
        u8p, i64p, ctypes.c_int64, i32p, i32p, u8p, u16p, u16p, i32p,
        i32p, i32p, i64p, u8p, i64p, u32p, i64p, u8p, u8p, i64p, u8p,
    ]
    lib.disq_segment_gather.restype = ctypes.c_int64
    lib.disq_segment_gather.argtypes = [
        u8p, ctypes.c_int64, i64p, ctypes.c_int64, i64p, ctypes.c_int64,
        i64p, u8p, ctypes.c_int64,
    ]


def _load() -> ctypes.CDLL:
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:
        raise ImportError(f"native library unavailable: {_load_error}")
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise ImportError(f"native library unavailable: {_load_error}")
        try:
            compiler, host = compiler_id(), host_id()
            paths = [library_path(_FLAGS + v, compiler, host)
                     for v in VARIANTS]
            # a variant built here before is reused; else build the
            # first one that compiles and links here
            path = next((p for p in paths if os.path.exists(p)), None) \
                or _build(paths)
            lib = ctypes.CDLL(path)
            _bind(lib)
        except (OSError, subprocess.CalledProcessError,
                AttributeError, TypeError) as e:
            _load_error = e
            raise ImportError(f"cannot load native library: {e}") from e
        _lib = lib
        return lib


def _as_u8(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf, dtype=np.uint8)
    return np.frombuffer(buf, dtype=np.uint8)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


DEFAULT_THREADS = max(1, (os.cpu_count() or 1))


def scan_bam_offsets_native(buf, base: int = 0) -> np.ndarray:
    """BAM record-offset scan; returns (N+1,) int64 offsets (+``base``)."""
    lib = _load()
    arr = _as_u8(buf)
    n = lib.disq_count_bam_records(_ptr(arr, ctypes.c_uint8), len(arr))
    if n < 0:
        raise ValueError(f"corrupt BAM record at offset {-(n + 1)}")
    out = np.empty(n + 1, dtype=np.int64)
    got = lib.disq_scan_bam_offsets(
        _ptr(arr, ctypes.c_uint8), len(arr), _ptr(out, ctypes.c_int64), n + 1
    )
    if got != n:
        raise ValueError(f"corrupt BAM record at offset {-(got + 1)}")
    if base:
        out += base
    return out


def walk_bgzf_blocks_native(buf, stop: int):
    """Walk BGZF headers in ``buf`` (which starts at a block start),
    collecting every complete block whose start is ``< stop``: returns
    (rel_pos i64, csize i32, usize i32) and stops cleanly at a block
    straddling the buffer end."""
    lib = _load()
    arr = _as_u8(buf)
    max_out = len(arr) // 28 + 1  # minimal BGZF block is 28 bytes
    rel = np.empty(max_out, dtype=np.int64)
    cs = np.empty(max_out, dtype=np.int32)
    us = np.empty(max_out, dtype=np.int32)
    n = lib.disq_bgzf_walk(
        _ptr(arr, ctypes.c_uint8), len(arr), stop,
        _ptr(rel, ctypes.c_int64), _ptr(cs, ctypes.c_int32),
        _ptr(us, ctypes.c_int32), max_out,
    )
    if n < 0:
        raise ValueError(f"malformed BGZF block header at offset {-(n + 1)}")
    return rel[:n], cs[:n], us[:n]


def inflate_blocks_native(data, block_off, hdr_len, csize, usize,
                          verify_crc: bool = True) -> np.ndarray:
    """Threaded batched BGZF inflate into one uint8 array."""
    lib = _load()
    arr = _as_u8(data)
    block_off = np.ascontiguousarray(block_off, dtype=np.int64)
    hdr_len = np.ascontiguousarray(hdr_len, dtype=np.int32)
    csize = np.ascontiguousarray(csize, dtype=np.int32)
    usize = np.ascontiguousarray(usize, dtype=np.int32)
    out_off = np.zeros(len(usize) + 1, dtype=np.int64)
    np.cumsum(usize, out=out_off[1:])
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    rc = lib.disq_bgzf_inflate_many(
        _ptr(arr, ctypes.c_uint8), _ptr(block_off, ctypes.c_int64),
        _ptr(hdr_len, ctypes.c_int32), _ptr(csize, ctypes.c_int32),
        _ptr(usize, ctypes.c_int32), len(usize),
        _ptr(out, ctypes.c_uint8), _ptr(out_off, ctypes.c_int64),
        1 if verify_crc else 0, DEFAULT_THREADS,
    )
    if rc == len(usize) + 1:
        raise MemoryError("libdeflate decompressor allocation failed")
    if rc > 0:
        raise ValueError(f"BGZF inflate failed at block {rc - 1}")
    if rc < 0:
        raise ValueError(f"BGZF CRC mismatch at block {-rc - 1}")
    return out


def fixed_columns_native(buf, offsets: np.ndarray) -> dict:
    """Pass 2's fixed part in C: the 8 fixed columns and each record's
    ``name_len`` (without the NUL), ``n_cigar``, ``l_seq`` and
    ``tag_len``. Raises ``ValueError`` on a record whose sections do not
    fit it (or whose ``l_read_name`` or ``l_seq`` is impossible)."""
    lib = _load()
    arr = _as_u8(buf)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    c_u8, c_i32, c_i64, c_u16 = (ctypes.c_uint8, ctypes.c_int32,
                                 ctypes.c_int64, ctypes.c_uint16)
    cols = dict(
        refid=np.empty(n, np.int32), pos=np.empty(n, np.int32),
        mapq=np.empty(n, np.uint8), bin=np.empty(n, np.uint16),
        flag=np.empty(n, np.uint16), next_refid=np.empty(n, np.int32),
        next_pos=np.empty(n, np.int32), tlen=np.empty(n, np.int32),
        name_len=np.empty(n, np.int64), n_cigar=np.empty(n, np.int64),
        l_seq=np.empty(n, np.int64), tag_len=np.empty(n, np.int64),
    )
    ctype = {np.dtype(np.int32): c_i32, np.dtype(np.uint8): c_u8,
             np.dtype(np.uint16): c_u16, np.dtype(np.int64): c_i64}
    rc = lib.disq_bam_fixed_columns(
        _ptr(arr, c_u8), len(arr), _ptr(offsets, c_i64), n,
        *(_ptr(a, ctype[a.dtype]) for a in cols.values()))
    if rc != 0:
        raise ValueError(f"record {-(rc + 1)}: malformed sections")
    return cols


def decode_records_native(buf, offsets: np.ndarray) -> dict:
    """Full pass-2 decode in C: returns the dict of ReadBatch columns."""
    lib = _load()
    arr = _as_u8(buf)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    c_u8, c_i64, c_u32 = ctypes.c_uint8, ctypes.c_int64, ctypes.c_uint32
    fixed = fixed_columns_native(arr, offsets)
    name_len, n_cigar, l_seq, tag_len = (
        fixed.pop(k) for k in ("name_len", "n_cigar", "l_seq", "tag_len"))

    def cum(lens):
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        return off

    name_off, cigar_off, seq_off, tag_off = (
        cum(name_len), cum(n_cigar), cum(l_seq), cum(tag_len)
    )
    names = np.empty(int(name_off[-1]), np.uint8)
    cigars = np.empty(int(cigar_off[-1]), np.uint32)
    seqs = np.empty(int(seq_off[-1]), np.uint8)
    quals = np.empty(int(seq_off[-1]), np.uint8)
    tags = np.empty(int(tag_off[-1]), np.uint8)
    rc = lib.disq_bam_fill_ragged(
        _ptr(arr, c_u8), _ptr(offsets, c_i64), n,
        _ptr(name_off, c_i64), _ptr(names, c_u8),
        _ptr(cigar_off, c_i64), _ptr(cigars, c_u32),
        _ptr(seq_off, c_i64), _ptr(seqs, c_u8), _ptr(quals, c_u8),
        _ptr(tag_off, c_i64), _ptr(tags, c_u8),
    )
    if rc != 0:
        raise ValueError("ragged fill failed")
    return dict(
        **fixed,
        name_offsets=name_off, names=names,
        cigar_offsets=cigar_off, cigars=cigars,
        seq_offsets=seq_off, seqs=seqs, quals=quals,
        tag_offsets=tag_off, tags=tags,
    )


def encode_records_native(batch) -> tuple[bytes, np.ndarray]:
    """Columns → record bytes + (N+1,) record offsets, one C pass."""
    lib = _load()
    n = batch.count
    c_u8, c_i32, c_i64 = ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64
    c_u16, c_u32 = ctypes.c_uint16, ctypes.c_uint32
    name_len = np.diff(batch.name_offsets)
    n_cigar = np.diff(batch.cigar_offsets)
    l_seq = np.diff(batch.seq_offsets)
    tag_len = np.diff(batch.tag_offsets)
    sizes = 4 + 32 + (name_len + 1) + 4 * n_cigar + (l_seq + 1) // 2 + l_seq + tag_len
    rec_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(sizes, out=rec_off[1:])
    out = np.empty(int(rec_off[-1]), np.uint8)
    keep = []  # contiguous copies must outlive the C call

    def c_arr(a, dt, ct):
        a = np.ascontiguousarray(a, dtype=dt)
        keep.append(a)
        return _ptr(a, ct)

    rc = lib.disq_bam_encode(
        _ptr(out, c_u8), _ptr(rec_off, c_i64), n,
        c_arr(batch.refid, np.int32, c_i32), c_arr(batch.pos, np.int32, c_i32),
        c_arr(batch.mapq, np.uint8, c_u8), c_arr(batch.bin, np.uint16, c_u16),
        c_arr(batch.flag, np.uint16, c_u16),
        c_arr(batch.next_refid, np.int32, c_i32),
        c_arr(batch.next_pos, np.int32, c_i32),
        c_arr(batch.tlen, np.int32, c_i32),
        c_arr(batch.name_offsets, np.int64, c_i64), c_arr(batch.names, np.uint8, c_u8),
        c_arr(batch.cigar_offsets, np.int64, c_i64), c_arr(batch.cigars, np.uint32, c_u32),
        c_arr(batch.seq_offsets, np.int64, c_i64), c_arr(batch.seqs, np.uint8, c_u8),
        c_arr(batch.quals, np.uint8, c_u8),
        c_arr(batch.tag_offsets, np.int64, c_i64), c_arr(batch.tags, np.uint8, c_u8),
    )
    if rc != 0:
        i = -(rc + 1)
        raise ValueError(
            f"record {i}: name or CIGAR field exceeds BAM limits "
            "(254 name bytes / 65535 CIGAR ops)"
        )
    return out.tobytes(), rec_off


def rans_encode0_native(raw) -> bytes:
    """rANS 4x8 order-0 encode (CRAM 3.0 §13); full stream incl. the
    9-byte header. Byte-identical to the Python codec's output."""
    lib = _load()
    arr = _as_u8(raw)
    n = len(arr)
    cap = 9 + 771 + 16 + (n * 3) // 2 + 64
    out = np.empty(cap, dtype=np.uint8)
    got = lib.disq_rans_encode0(
        _ptr(arr, ctypes.c_uint8), n, _ptr(out, ctypes.c_uint8), cap)
    if got < 0:
        raise ValueError("rANS encode buffer too small")
    return out[:got].tobytes()


def rans_encode1_native(raw) -> bytes:
    """rANS 4x8 order-1 encode (htslib wire format); byte-identical to
    the Python codec's ``rans_encode_order1``."""
    lib = _load()
    arr = _as_u8(raw)
    n = len(arr)
    cap = 9 + 256 * 775 + 16 + (n * 3) // 2 + 64
    out = np.empty(cap, dtype=np.uint8)
    got = lib.disq_rans_encode1(
        _ptr(arr, ctypes.c_uint8), n, _ptr(out, ctypes.c_uint8), cap)
    if got < 0:
        raise ValueError("rANS o1 encode buffer too small")
    return out[:got].tobytes()


def rans_decode_native(data) -> bytes:
    """rANS 4x8 decode, order 0 or 1; ``data`` is the full stream."""
    import struct

    lib = _load()
    arr = _as_u8(data)
    if len(arr) < 9:
        raise ValueError("truncated rANS stream")
    raw_size = struct.unpack_from("<I", arr, 5)[0]
    out = np.empty(raw_size, dtype=np.uint8)
    rc = lib.disq_rans_decode(
        _ptr(arr, ctypes.c_uint8), len(arr), _ptr(out, ctypes.c_uint8),
        raw_size)
    if rc != 0:
        raise ValueError(f"rANS decode failed (code {rc})")
    return out.tobytes()


def deflate_blocks_native(payload, payload_offsets: np.ndarray,
                          level: int = 6):
    """Batched canonical BGZF deflate: block i's bytes are
    ``rows[i, :sizes[i]]``."""
    lib = _load()
    arr = _as_u8(payload)
    pay_off = np.ascontiguousarray(payload_offsets, dtype=np.int64)
    nblocks = len(pay_off) - 1
    stride = 65600
    out = np.empty(nblocks * stride, dtype=np.uint8)
    sizes = np.zeros(nblocks, dtype=np.int32)
    rc = lib.disq_bgzf_deflate_many(
        _ptr(arr, ctypes.c_uint8), _ptr(pay_off, ctypes.c_int64), nblocks,
        _ptr(out, ctypes.c_uint8), stride, _ptr(sizes, ctypes.c_int32),
        level, DEFAULT_THREADS,
    )
    if rc != 0:
        raise ValueError(f"BGZF deflate failed at block {rc - 1}")
    return out.reshape(nblocks, stride), sizes


def segment_gather_native(flat: np.ndarray, offsets: np.ndarray,
                          indices: np.ndarray):
    """Ragged segment gather (per-segment C memcpy); returns
    (new_flat, new_offsets)."""
    lib = _load()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    nseg = len(offsets) - 1
    if len(indices) and (
        int(indices.min()) < -nseg or int(indices.max()) >= nseg
    ):
        raise IndexError("segment index out of range")
    if len(indices) and int(indices.min()) < 0:
        indices = np.where(indices < 0, indices + nseg, indices)
    flat_c = np.ascontiguousarray(flat)
    if nseg > 0:
        if int(offsets[0]) < 0 or np.any(np.diff(offsets) < 0):
            raise ValueError(
                "segment_gather: offsets must be non-negative and "
                "monotone non-decreasing")
        if int(offsets[-1]) > len(flat_c):
            raise ValueError(
                f"segment_gather: offsets[-1]={int(offsets[-1])} exceeds "
                f"flat length {len(flat_c)}")
    lens = np.diff(offsets)[indices]
    new_off = np.zeros(len(indices) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_off[1:])
    out = np.empty(int(new_off[-1]), dtype=flat_c.dtype)
    rc = lib.disq_segment_gather(
        _ptr(flat_c.view(np.uint8), ctypes.c_uint8), len(flat_c),
        _ptr(offsets, ctypes.c_int64), nseg,
        _ptr(indices, ctypes.c_int64), len(indices),
        _ptr(new_off, ctypes.c_int64),
        _ptr(out.view(np.uint8), ctypes.c_uint8),
        flat_c.dtype.itemsize,
    )
    if rc != 0:
        raise ValueError(f"segment_gather failed validation (code {rc})")
    return out, new_off
