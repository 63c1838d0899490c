"""Resident record gather (kernel W1).

``gather_records(blob, src, dst, nbytes)`` copies record ``i``'s bytes,
``blob[src[i]:][:dst[i+1] - dst[i]]``, to ``out[dst[i]:dst[i+1]]`` of a
new ``nbytes``-byte payload (``nbytes == dst[-1]``). With ``src`` in the
sort's order this is the record encode of a sorted shard
(``runtime/device_write.py``): the BAM bytes of an unmodified record
are its decoded bytes.

On a CUDA tensor it launches the CUDA kernel (``csrc/record_gather.cu``,
one warp per record); on a CPU tensor it runs ``gather_plain``, the same
gather as torch ops (``repeat_interleave`` of the record indices, then
``index_select``), whose int64 index per byte is what the kernel avoids.
"""

from __future__ import annotations

import ctypes

import torch

from disq_tpu_torch.runtime import counters


def gather_plain(blob: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 nbytes: int) -> torch.Tensor:
    """The plain version of ``gather_records``."""
    lens = dst[1:] - dst[:-1]
    rec = torch.repeat_interleave(
        torch.arange(src.numel(), device=blob.device), lens,
        output_size=nbytes)
    within = torch.arange(nbytes, device=blob.device) - dst[:-1][rec]
    return torch.index_select(blob, 0, src[rec] + within)


def _lib():
    from disq_tpu_torch.ops import cuda_build

    lib = cuda_build.load("record_gather")
    if lib.disq_record_gather_launch.argtypes is None:
        lib.disq_record_gather_launch.restype = ctypes.c_int
        lib.disq_record_gather_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def gather_records(blob: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   nbytes: int) -> torch.Tensor:
    """The records at byte offsets ``src`` (int64, n) of ``blob`` (uint8)
    laid out at ``dst`` (int64, n+1, from 0 to ``nbytes``): a new uint8
    tensor of ``nbytes``. ``blob`` is only read, so several threads may
    gather from one blob at once."""
    dev = blob.device
    if blob.dtype != torch.uint8 or blob.dim() != 1 \
            or not blob.is_contiguous():
        raise ValueError(f"blob: want a contiguous 1-D uint8 tensor, got "
                         f"{blob.dtype} {tuple(blob.shape)}")
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{name}: want a contiguous 1-D int64 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if dst.numel() != src.numel() + 1:
        raise ValueError(f"dst holds {dst.numel()} offsets for "
                         f"{src.numel()} records")
    if dev.type == "cpu":
        return gather_plain(blob, src, dst, nbytes)
    if dev.type != "cuda":
        raise ValueError(f"record_gather runs on cuda or cpu, not {dev}")
    out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    n = src.numel()
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.disq_record_gather_launch(
                blob.data_ptr(), src.data_ptr(), dst.data_ptr(), n,
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        from disq_tpu_torch.ops.cuda_build import check_launch

        check_launch("record_gather", rc)
        counters.book_launch("record_gather")
    return out
