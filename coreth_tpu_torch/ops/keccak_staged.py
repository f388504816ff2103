"""Staged trie commit: the counterpart of coreth_tpu/ops/keccak_staged.py.

One upload and one dispatch per segment, with the digest array resident
on the device and no host synchronisation until the last readback:

    dig8 = zeros[G, 32]                        # on the device
    for seg in plan.segments:
        x    = upload(seg.bytes)
        dig8 = seg_step(dig8, x, patches, gstart)
    root = dig8[root_pos]                      # the only sync

Within a segment every lane has the same rate-block count (the planner
buckets exactly), so the segment hash needs no masking: absorb all blocks,
and the state after the last permutation is the digest. Child digests come
from dig8 by a gather and are scattered into the raw bytes before the word
packing, so the parent <- child chain never touches the host.

segment_keccak_plain is the segment hash in plain torch (the counterpart
of the reference's _segment_keccak): kernel K1's plain version, the CPU
path of ops/keccak_cuda.segment_keccak and the yardstick K1 is held
against on the card. StagedCommit's default segment hash is K1 itself.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .keccak_fused import _u8_to_words, _words_to_u8
from .keccak_torch import RATE, WORDS_PER_BLOCK, digest_words, \
    keccak_f1600, lanes_from_words


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


def _seg_step_patched(seg_impl, dig8: torch.Tensor, seg_u8: torch.Tensor,
                      pl: torch.Tensor, po: torch.Tensor, pc: torch.Tensor,
                      gstart: int, blocks: int) -> None:
    """One segment with child-digest patches; dig8 updated in place."""
    ar32 = torch.arange(32, device=seg_u8.device)
    seg_u8[pl.long()[:, None], po.long()[:, None] + ar32[None, :]] = \
        dig8[pc.long()]  # gathered from earlier segments
    out = seg_impl(_u8_to_words(seg_u8, blocks))
    dig8[gstart:gstart + out.shape[0]] = _words_to_u8(out)


def _seg_step_plain(seg_impl, dig8: torch.Tensor, seg_u8: torch.Tensor,
                    gstart: int, blocks: int) -> None:
    """Patch-free segment (leaves)."""
    out = seg_impl(_u8_to_words(seg_u8, blocks))
    dig8[gstart:gstart + out.shape[0]] = _words_to_u8(out)


class StagedCommit:
    """Execute a CommitPlan's segment layout (CommitPlan.export()) one
    segment at a time on `device` (None: CUDA).

    seg_impl: the per-segment keccak, int32[P, L, 34] -> int32[P, 8]
    (default ops/keccak_cuda.segment_keccak: K1 on CUDA, its plain version
    on the CPU) — the counterpart of the reference's
    keccak_pallas.staged_seg_impl."""

    def __init__(self, seg_impl=None, device: DeviceLike = None):
        if seg_impl is None:
            from .keccak_cuda import segment_keccak as seg_impl
        self.seg_impl = seg_impl
        self.device = resolve(device)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        # a copy even on the CPU: the patch step writes into the segment
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            copy=True)

    def run(self, specs, flat: np.ndarray, nblocks: np.ndarray,
            patch_lane: np.ndarray, patch_off: np.ndarray,
            patch_child: np.ndarray, root_pos: int,
            want_digests: bool = True) -> Tuple[bytes, Optional[np.ndarray]]:
        """Returns (root32, uint8[G, 32] digests | None)."""
        total = int(nblocks.shape[0])
        dig8 = torch.zeros((total, 32), dtype=torch.uint8, device=self.device)
        byte_base = patch_pos = 0
        for spec in specs:
            width = spec.blocks * RATE
            size = spec.lanes * width
            x = self._upload(flat[byte_base:byte_base + size]).view(
                spec.lanes, width)
            byte_base += size
            if spec.n_patches:
                sl = slice(patch_pos, patch_pos + spec.n_patches)
                patch_pos += spec.n_patches
                _seg_step_patched(self.seg_impl, dig8, x,
                                  self._upload(patch_lane[sl]),
                                  self._upload(patch_off[sl]),
                                  self._upload(patch_child[sl]),
                                  spec.gstart, spec.blocks)
            else:
                _seg_step_plain(self.seg_impl, dig8, x, spec.gstart,
                                spec.blocks)
        if want_digests:
            host = dig8.cpu().numpy()
            return host[root_pos].tobytes(), host
        return dig8[root_pos].cpu().numpy().tobytes(), None


_default_staged: Dict[str, StagedCommit] = {}


def default_staged_commit(device: DeviceLike = None) -> StagedCommit:
    """The per-device StagedCommit with the default segment hash."""
    d = resolve(device)
    sc = _default_staged.get(str(d))
    if sc is None:
        sc = _default_staged[str(d)] = StagedCommit(device=d)
    return sc
