"""rANS-4x8 order-0 decode through a 4096-slot lookup (kernel B5).

The legacy route (``DISQ_TPU_TORCH_DEVICE_RANS=legacy``), the function
of the reference's ``_rans0_kernel``, which is the function of B3
(``ops/rans_simd.py``): the same inputs, outputs and status 6 on an
overrun. Only the kernel's table step differs — ``csrc/rans.cu`` gives
each stream one warp that builds the stream's slot -> symbol lookup as
the reference's wrapper does and fills B3's packed slot table from it,
then decodes with B3's decode (``csrc/rans_core.cuh``) — and the host
side raises on a flagged stream with the reference's message.

On a CUDA tensor ``rans0_decode_legacy`` launches the kernel; on a CPU
tensor it runs ``rans0_decode_plain``, which reads each symbol from a
4096-slot lookup as the kernel does, through the superstep loop it
shares with B3's plain version.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from disq_tpu_torch.ops.rans_simd import (
    TOTFREQ,
    check_inputs,
    decode_streams,
    decode_supersteps,
    launch,
)

__all__ = ["rans0_decode_device", "rans0_decode_legacy", "rans0_decode_plain"]

# the rANS coder's constants: the lower bound of a renormalized state and
# the frequency table's precision (frequencies sum to 1 << TF_SHIFT)
RANS_LOW = 1 << 23
TF_SHIFT = 12

# cumulative dispatch diagnostics, as ops/rans_simd.last_stats
last_stats = {"device_lanes": 0, "host_big": 0, "host_fallback": 0}


def slot_lookup(freq: torch.Tensor) -> torch.Tensor:
    """(n, 4096) int64 slot -> symbol tables: symbol s repeated freq[s]
    times, as the reference's wrapper builds them, and every slot past
    the row's total read as 255."""
    n = freq.shape[0]
    lookup = torch.full((n, TOTFREQ), 255, dtype=torch.int64,
                        device=freq.device)
    symbols = torch.arange(256, device=freq.device)
    for i in range(n):
        row = torch.repeat_interleave(symbols, freq[i].long())[:TOTFREQ]
        lookup[i, :row.numel()] = row
    return lookup


def rans0_decode_plain(ren: torch.Tensor, ren_off: torch.Tensor,
                       out_off: torch.Tensor, states: torch.Tensor,
                       freq: torch.Tensor):
    """B5's plain version: the kernel's inputs and outputs, each symbol
    read from the stream's 4096-slot lookup."""
    lookup = slot_lookup(freq)
    return decode_supersteps(ren, ren_off, out_off, states, freq,
                             lambda m: lookup.gather(1, m))


def rans0_decode_legacy(ren: torch.Tensor, ren_off: torch.Tensor,
                        out_off: torch.Tensor, states: torch.Tensor,
                        freq: torch.Tensor, total: int):
    """Decode n order-0 streams: ``(out uint8[total], used int64[n],
    status int32[n])``, inputs as for ``rans_simd.rans0_decode``."""
    check_inputs(ren, ren_off, out_off, states, freq)
    if ren.device.type == "cpu":
        return rans0_decode_plain(ren, ren_off, out_off, states, freq)
    return launch("rans", "disq_rans_legacy_launch", ren, ren_off, out_off,
                  states, freq, total)


def rans0_decode_device(streams: Sequence[bytes], device,
                        bad: Optional[Dict[int, BaseException]] = None
                        ) -> List[Optional[bytes]]:
    """Decode order-0 rANS 4x8 streams (full streams incl. the 9-byte
    header) on ``device`` in one launch of B5; an overrun raises
    ``ValueError`` as the reference's wrapper does, or with ``bad`` is
    recorded there (``ops/rans_simd.decode_streams``)."""
    return decode_streams(streams, device, rans0_decode_legacy, last_stats,
                          bad, {"kernel": "rans", "streams": len(streams)})
