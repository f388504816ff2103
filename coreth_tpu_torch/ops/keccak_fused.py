"""Fused multi-level trie commitment on the device: the counterpart of
coreth_tpu/ops/keccak_fused.py.

A parent's RLP length never depends on its children's digest values (a
hashed child reference is always 33 encoded bytes), so the host lays out
every node's keccak-padded message with zeroed digest slots plus a patch
table (parent lane, byte offset, child lane), and the device resolves the
dependency chain itself:

    for each (level, bucket) segment:
        scatter child digests into the segment's messages
        keccak the segment
        write its digests into the global digest array

One upload of the concatenated byte-space segments, the block counts and
the patch tables; one readback of uint8[G, 32]. The reference compiles the
loop into one XLA program; the port runs it as torch ops on the device,
each segment hashed by one K2 launch (ops/keccak_cuda.keccak256_blocks,
the plain version on a CPU tensor): the segment hash is variable-length,
so a lane's own block count applies and a lane whose count is outside
[1, L] (a pad lane) gets an all-zero digest, as the reference's masked
scan gives it.

SegmentSpec is also the shape descriptor of the planned and staged
executors' segment tables.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .keccak_torch import RATE, WORDS_PER_BLOCK, to_int32


class SegmentSpec(NamedTuple):
    """Static shape descriptor for one (level, bucket) group."""

    blocks: int        # rate blocks per lane in this segment
    lanes: int         # padded lane count
    gstart: int        # start offset in the global digest array
    n_patches: int     # padded patch count


def _u8_to_words(a_u8: torch.Tensor, blocks: int) -> torch.Tensor:
    """uint8[P, blocks*136] -> int32[P, blocks, 34]: each word the
    little-endian u32 of its four bytes (byte 0 lowest), as int32 bits."""
    p = a_u8.shape[0]
    b = a_u8.reshape(p, blocks, WORDS_PER_BLOCK, 4).long()
    return to_int32(b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
                    | (b[..., 3] << 24))


def _words_to_u8(w: torch.Tensor) -> torch.Tensor:
    """int32[P, 8] digest words (u32 bits) -> uint8[P, 32], little-endian."""
    w = w.long()
    out = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return out.to(torch.uint8).reshape(w.shape[0], 32)


def fused_commit(specs: Sequence[SegmentSpec], flat_msgs, nblocks,
                 patch_lane, patch_off, patch_child,
                 device: DeviceLike = None, impl=None) -> np.ndarray:
    """Run the whole level-synchronised commit on `device` (None: CUDA).

    flat_msgs:  uint8[sum(lanes*blocks*136)]  segment messages, concatenated
    nblocks:    int32[G]                      per-lane block counts
    patch_*:    int32[sum(n_patches)]         per-segment patch tables
    impl:       the variable-length keccak, int32[B, L, 34] + int32[B] ->
                int32[B, 8] (default K2)
    returns     uint8[G, 32] digests in global lane order, on the host
    """
    if impl is None:
        from .keccak_cuda import keccak256_blocks as impl
    dev = resolve(device)
    # two uploads: the bytes (a private copy, patched in place) and the
    # block counts with the three patch tables
    msgs = torch.from_numpy(np.ascontiguousarray(flat_msgs, np.uint8)).to(
        dev, copy=True)
    g = len(nblocks)
    n_pat = sum(s.n_patches for s in specs)
    tables = torch.from_numpy(np.concatenate([
        np.asarray(a, np.int64) for a in (
            nblocks, patch_lane[:n_pat], patch_off[:n_pat],
            patch_child[:n_pat])])).to(dev)
    nb = tables[:g].to(torch.int32)
    pl_all = tables[g:g + n_pat]
    po_all = tables[g + n_pat:g + 2 * n_pat]
    pc_all = tables[g + 2 * n_pat:]
    dig8 = torch.zeros((g, 32), dtype=torch.uint8, device=dev)
    ar32 = torch.arange(32, device=dev)
    msg_off = patch_pos = 0
    for spec in specs:
        width = spec.blocks * RATE
        size = spec.lanes * width
        seg = msgs[msg_off:msg_off + size].reshape(spec.lanes, width)
        msg_off += size
        if spec.n_patches:
            sl = slice(patch_pos, patch_pos + spec.n_patches)
            patch_pos += spec.n_patches
            vals = dig8[pc_all[sl]]  # [P, 32] from earlier levels
            seg[pl_all[sl][:, None], po_all[sl][:, None] + ar32[None, :]] = \
                vals
        words = _u8_to_words(seg, spec.blocks)
        out = impl(words, nb[spec.gstart:spec.gstart + spec.lanes])
        dig8[spec.gstart:spec.gstart + spec.lanes] = _words_to_u8(out)
    return dig8.cpu().numpy()


def _pow2_at_least(v: int, floor: int = 16) -> int:
    t = floor
    while t < v:
        t *= 2
    return t


class FusedBatch:
    """Host-side builder collecting levels of (padded message, patches).

    add_level() takes the level's messages (keccak-padded bytes with zeroed
    digest slots) and patches [(msg_idx_in_level, byte_off, child_gidx)];
    returns the global indices assigned to the level's lanes. run() makes
    one device call and returns all digests.
    """

    def __init__(self):
        self.levels: List[dict] = []
        self.total = 0

    def add_level(self, padded_msgs: List[bytes], nblocks: List[int],
                  patches: List[Tuple[int, int, int]]) -> List[int]:
        gids = list(range(self.total, self.total + len(padded_msgs)))
        self.levels.append({
            "msgs": padded_msgs,
            "nblocks": nblocks,
            "patches": patches,
            "gids": gids,
        })
        self.total += len(padded_msgs)
        return gids

    def run(self, impl=None) -> List[bytes]:
        """Build segment arrays (bucketed by block count, padded to
        power-of-two lane counts) and execute them with `impl`, a callable
        of fused_commit's first six arguments (default: fused_commit on
        CUDA). Returns digests by gid."""
        if impl is None:
            impl = fused_commit
        specs: List[SegmentSpec] = []
        seg_msgs: List[np.ndarray] = []
        all_nblocks: List[np.ndarray] = []
        all_pl: List[np.ndarray] = []
        all_po: List[np.ndarray] = []
        all_pc: List[np.ndarray] = []
        remap = np.zeros(max(self.total, 1), dtype=np.int64)
        gpos = 0

        for level in self.levels:
            msgs = level["msgs"]
            if not msgs:
                continue
            nb = np.asarray(level["nblocks"], dtype=np.int32)
            patches = level["patches"]  # (msg_idx, off, child_gid)

            # bucket by power-of-two block count
            keys = np.asarray([1 << int(b - 1).bit_length() if b > 1 else 1
                               for b in nb])
            patch_msgs = {mi for mi, _, _ in patches}
            for key in np.unique(keys):
                (idxs,) = np.nonzero(keys == key)
                has_patches = any(int(mi) in patch_msgs for mi in idxs)
                lanes = _pow2_at_least(len(idxs) + (1 if has_patches else 0))
                width = int(key) * RATE
                arr = np.zeros((lanes, width), dtype=np.uint8)
                # one vectorised scatter of the bucket's messages
                lengths = np.asarray([len(msgs[int(mi)]) for mi in idxs],
                                     dtype=np.int64)
                if len(idxs):
                    src = np.frombuffer(b"".join(msgs[int(mi)] for mi in idxs),
                                        dtype=np.uint8)
                    starts = np.zeros(len(idxs), dtype=np.int64)
                    np.cumsum(lengths[:-1], out=starts[1:])
                    within = np.arange(int(lengths.sum()), dtype=np.int64) \
                        - np.repeat(starts, lengths)
                    dest = np.repeat(np.arange(len(idxs), dtype=np.int64)
                                     * width, lengths) + within
                    arr.reshape(-1)[dest] = src
                seg_nb = np.ones(lanes, dtype=np.int32)
                seg_nb[: len(idxs)] = nb[idxs]
                remap[np.asarray(level["gids"], dtype=np.int64)[idxs]] = (
                    gpos + np.arange(len(idxs), dtype=np.int64)
                )
                # per-bucket patch tables (msg_idx -> bucket lane)
                lane_of = {int(mi): lane for lane, mi in enumerate(idxs)}
                pl, po, pc = [], [], []
                for mi, off, child in patches:
                    lane = lane_of.get(mi)
                    if lane is not None:
                        pl.append(lane)
                        po.append(off)
                        pc.append(child)
                scratch = lanes - 1
                n_patches = _pow2_at_least(len(pl), 16) if pl else 0
                for _ in range(n_patches - len(pl)):
                    pl.append(scratch)
                    po.append(0)
                    pc.append(-1)
                specs.append(SegmentSpec(int(key), lanes, gpos, n_patches))
                seg_msgs.append(arr)
                all_nblocks.append(seg_nb)
                all_pl.append(np.asarray(pl, dtype=np.int32))
                all_po.append(np.asarray(po, dtype=np.int32))
                all_pc.append(np.asarray(pc, dtype=np.int64))
                gpos += lanes

        # child gids -> packed positions (pads (-1) -> lane 0, harmless:
        # their write lands in the scratch lane)
        flat_pc = [
            np.where(pc >= 0, remap[np.maximum(pc, 0)], 0).astype(np.int32)
            for pc in all_pc
        ]

        def cat(parts, dtype):
            return np.concatenate(parts) if parts else np.zeros(0, dtype)

        dig8 = np.asarray(impl(
            tuple(specs), cat([a.reshape(-1) for a in seg_msgs], np.uint8),
            cat(all_nblocks, np.int32), cat(all_pl, np.int32),
            cat(all_po, np.int32), cat(flat_pc, np.int32)))
        # one gather puts digests back into gid order
        ordered = dig8[remap[: self.total]]
        raw = ordered.tobytes()
        return [raw[i * 32: i * 32 + 32] for i in range(self.total)]
