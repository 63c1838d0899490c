"""Read-path errors under the strict policy.

The strict policy is the only one this slice has: a block that fails
decode with certainty raises ``CorruptBlockError`` carrying its
coordinates, with the same message shape as the reference's
``ShardErrorContext.handle_corrupt_block``. Skip and quarantine salvage
come in a later slice.
"""

from __future__ import annotations

from typing import Optional


class CorruptBlockError(ValueError):
    """A compressed block failed decode with certainty (CRC mismatch,
    invalid DEFLATE bits, impossible framing), with its coordinates."""

    def __init__(
        self,
        message: str,
        *,
        path: str = "",
        shard_id: int = -1,
        block_offset: int = -1,
        virtual_offset: Optional[int] = None,
    ) -> None:
        detail = (
            f"{message} [path={path!r} shard={shard_id} "
            f"block_offset={block_offset}"
            + (f" voffset={virtual_offset:#x}"
               if virtual_offset is not None else "")
            + "]"
        )
        super().__init__(detail)
        self.path = path
        self.shard_id = shard_id
        self.block_offset = block_offset
        self.virtual_offset = virtual_offset


class MissingReferenceError(ValueError):
    """Reference FASTA absent or wrong for reference-compressed CRAM — a
    configuration error, never reported as a corrupt block."""


class TruncatedReadError(OSError, ValueError):
    """A range read returned fewer bytes than the on-disk structure
    requires (an I/O symptom, and a ValueError for callers of the block
    walk)."""


def corrupt(error: BaseException, *, kind: str, path: str, shard_id: int,
            block_offset: int,
            virtual_offset: Optional[int] = None) -> CorruptBlockError:
    """The strict policy's error for one corrupt block or record run."""
    return CorruptBlockError(
        f"corrupt {kind}: {error}", path=path, shard_id=shard_id,
        block_offset=block_offset, virtual_offset=virtual_offset)


def inflate_blocks_strict(data, blocks, base: int, path: str,
                          shard_id: int) -> None:
    """Per-block host inflate of a batch whose batched inflate failed:
    raises ``CorruptBlockError`` at the first block that fails alone,
    returns when every block decodes (the caller then surfaces its
    original error — a codec bug, not corruption)."""
    from disq_tpu_torch.bgzf.block import make_virtual_offset
    from disq_tpu_torch.bgzf.codec import inflate_block

    for b in blocks:
        try:
            inflate_block(data, b.pos - base)
        except ValueError as e:
            raise corrupt(
                e, kind="BGZF block", path=path, shard_id=shard_id,
                block_offset=b.pos,
                virtual_offset=make_virtual_offset(b.pos, 0)) from e
