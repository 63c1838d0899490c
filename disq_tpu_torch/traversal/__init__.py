"""Indexed (interval) reads through the BAI."""

from disq_tpu_torch.traversal.bai_query import (  # noqa: F401
    read_with_traversal,
)
