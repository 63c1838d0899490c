"""BGZF blocks: framing, the block guesser, and the codec."""

from disq_tpu_torch.bgzf.block import (  # noqa: F401
    BGZF_EOF_MARKER,
    BGZF_HEADER_SIZE,
    BGZF_MAX_BLOCK_SIZE,
    BgzfBlock,
    make_virtual_offset,
    split_virtual_offset,
)
from disq_tpu_torch.bgzf.codec import (  # noqa: F401
    BgzfReader,
    BgzfWriter,
    compress_to_bgzf,
    decompress_bgzf,
    deflate_block,
    inflate_block,
    inflate_blocks,
)
from disq_tpu_torch.bgzf.guesser import (  # noqa: F401
    BgzfBlockGuesser,
    find_block_table,
)
