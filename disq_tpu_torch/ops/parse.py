"""BAM fixed-field parse on the device (kernel B2).

``parse_records(blob, starts)`` reads each record's 36-byte prefix
(the ``block_size`` word plus the 32-byte fixed section, SAM spec §4.2)
at its byte offset in the decoded blob and returns the 12 int32 fields
of ``_FIELD_ORDER`` as columns. Word layout:

  w0 block_size · w1 refID · w2 pos ·
  w3 = l_read_name | mapq<<8 | bin<<16 · w4 = n_cigar | flag<<16 ·
  w5 l_seq · w6 next_refID · w7 next_pos · w8 tlen

On a CUDA tensor it launches the CUDA kernel (``csrc/parse.cu``), which
fuses the prefix gather with the parse and reads the blob in place
(aligned 16-byte loads of the prefix where it lies inside the blob,
byte loads where it runs past the end); on a CPU tensor it runs
``parse_records_plain``, the same gather and split as torch ops.
``edge_starts`` gives the starts at the kernel's edges, which the tests
and ``chip_smoke.py`` hold the kernel and its plain version to.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.device_pipeline import N_WORDS, gather_record_words

_FIELD_ORDER = (
    "block_size", "refid", "pos", "l_read_name", "mapq", "bin",
    "n_cigar", "flag", "l_seq", "next_refid", "next_pos", "tlen",
)


def record_prefix_words(blob: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Host staging: each record's 36-byte prefix as ``(N, 9)`` int32."""
    starts = offsets[:-1].astype(np.int64)
    fixed = blob[starts[:, None] + np.arange(4 * N_WORDS)]
    return np.ascontiguousarray(fixed).view("<i4").reshape(-1, N_WORDS)


def edge_starts(length: int) -> np.ndarray:
    """Record starts at B2's edges in a blob of ``length`` bytes: the
    first 64 offsets (every residue mod 16 of the address, for any
    alignment of the blob), and every start from the one whose 36-byte
    prefix ends 40 bytes before the blob's end to the blob's end itself
    (prefixes ending exactly at the end, within 40 bytes of it, and past
    it, where bytes read as zero)."""
    front = np.arange(min(64, length), dtype=np.int64)
    back = np.arange(max(0, length - 4 * N_WORDS - 40), length + 1,
                     dtype=np.int64)
    return np.concatenate([front, back])


def _split_words(w):
    """The field math (shared shape with the reference's)."""
    return dict(
        block_size=w[:, 0],
        refid=w[:, 1],
        pos=w[:, 2],
        l_read_name=w[:, 3] & 0xFF,
        mapq=(w[:, 3] >> 8) & 0xFF,
        bin=(w[:, 3] >> 16) & 0xFFFF,
        n_cigar=w[:, 4] & 0xFFFF,
        flag=(w[:, 4] >> 16) & 0xFFFF,
        l_seq=w[:, 5],
        next_refid=w[:, 6],
        next_pos=w[:, 7],
        tlen=w[:, 8],
    )


def parse_records_plain(blob: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(12, N)`` int32, rows in ``_FIELD_ORDER``."""
    if starts.numel() == 0:
        return torch.empty((len(_FIELD_ORDER), 0), dtype=torch.int32,
                           device=blob.device)
    fields = _split_words(gather_record_words(blob, starts))
    return torch.stack([fields[k] for k in _FIELD_ORDER]).contiguous()


def _lib():
    from disq_tpu_torch.ops import cuda_build

    lib = cuda_build.load("parse")
    if lib.disq_parse_launch.argtypes is None:
        lib.disq_parse_launch.restype = ctypes.c_int
        lib.disq_parse_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
    return lib


def parse_records(blob: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Parse the records starting at byte offsets ``starts`` (int64) of
    the decoded ``blob`` (uint8): ``(12, N)`` int32, rows in
    ``_FIELD_ORDER``."""
    dev = blob.device
    if blob.dtype != torch.uint8 or blob.dim() != 1 or not blob.is_contiguous():
        raise ValueError(f"blob: want a contiguous 1-D uint8 tensor, got "
                         f"{blob.dtype} {tuple(blob.shape)}")
    if starts.dtype != torch.int64 or starts.dim() != 1 \
            or not starts.is_contiguous() or starts.device != dev:
        raise ValueError(f"starts: want a contiguous 1-D int64 tensor on "
                         f"{dev}, got {starts.dtype} on {starts.device}")
    if dev.type == "cpu":
        return parse_records_plain(blob, starts)
    if dev.type != "cuda":
        raise ValueError(f"parse runs on cuda or cpu, not {dev}")
    n = starts.numel()
    out = torch.empty((len(_FIELD_ORDER), n), dtype=torch.int32, device=dev)
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.disq_parse_launch(
                blob.data_ptr(), blob.numel(), starts.data_ptr(), n,
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        from disq_tpu_torch.ops.cuda_build import check_launch

        check_launch("parse", rc)
        counters.book_launch("parse")
    return out


def columns(parsed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The ``(12, N)`` result as a name → column dict (views)."""
    return dict(zip(_FIELD_ORDER, parsed.unbind(0)))


def parse_fixed_words(words: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 12 fixed fields of ``(N, 9)`` int32 record-prefix words, as
    torch ops on the words' device."""
    return _split_words(words)


def parse_fixed_words_pallas(words: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's kernel entry over ``(N, 9)`` int32 prefix words,
    under its name: the words' bytes are a blob of 36-byte records that
    ``parse_records`` (kernel B2 on ``cuda``) parses."""
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != N_WORDS:
        raise ValueError(f"words: want (N, {N_WORDS}) int32, got "
                         f"{words.dtype} {tuple(words.shape)}")
    blob = words.contiguous().view(torch.uint8).reshape(-1)
    starts = torch.arange(words.shape[0], dtype=torch.int64,
                          device=words.device) * (4 * N_WORDS)
    return columns(parse_records(blob, starts))
