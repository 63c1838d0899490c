"""Coordinate sort of a read batch."""

from disq_tpu_torch.sort.coordinate import (  # noqa: F401
    coordinate_keys,
    coordinate_sort_batch,
)
