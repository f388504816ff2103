"""Segment shape descriptor, the counterpart of
coreth_tpu/ops/keccak_fused.py:SegmentSpec (the rest of that module, the
legacy fused executor, is not ported)."""

from __future__ import annotations

from typing import NamedTuple


class SegmentSpec(NamedTuple):
    """Static shape descriptor for one (level, bucket) group."""

    blocks: int        # rate blocks per lane in this segment
    lanes: int         # padded lane count
    gstart: int        # start offset in the global digest array
    n_patches: int     # padded patch count
