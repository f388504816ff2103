"""Segment Keccak in plain torch: the counterpart of
coreth_tpu/ops/keccak_staged.py:_segment_keccak.

Every lane of a segment has exactly L pre-padded rate blocks (the planner
buckets by block count), so there is no masking: absorb all blocks, and the
state after the last permutation is the digest. This is kernel K1's plain
version: the CPU path of ops/keccak_cuda.segment_keccak and the yardstick
K1 is held against on the card.
"""

from __future__ import annotations

import torch

from .keccak_torch import WORDS_PER_BLOCK, digest_words, keccak_f1600, \
    lanes_from_words


def segment_keccak_plain(words: torch.Tensor) -> torch.Tensor:
    """int32[P, L, 34] (u32 bits) -> int32[P, 8]; all lanes have L blocks."""
    if words.dim() != 3 or words.shape[2] != WORDS_PER_BLOCK:
        raise ValueError(f"expected [P, L, 34] words, got {tuple(words.shape)}")
    p, blocks, _ = words.shape
    zero = torch.zeros(p, dtype=torch.int64, device=words.device)
    a = [zero] * 25
    for j in range(blocks):
        lanes = lanes_from_words(words[:, j])
        a = [a[i] ^ lanes[i] for i in range(17)] + a[17:]
        a = keccak_f1600(a)
    return digest_words(a)
