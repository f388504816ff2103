"""Planned trie commit in torch: the counterpart of
coreth_tpu/ops/keccak_planned.py.

One bulk upload of the planner's little-endian u32 word stream plus three
patch tables; the parent <- child digest dependency resolves on the device
in word space; every segment hashes through one segment Keccak call
(kernel K1 on CUDA, its plain torch version on the CPU).

Word space on the device: the stream is uploaded as int32 (same bits) and
widened once to int64 holding values in [0, 2**32). For each patch a
9-word contribution strip is built from the child's digest, barrel-shifted
to the byte offset (shift = offset % 4), and index_add_-ed into the int64
words; the template bytes under a hole are zero and neighbouring strips
touch disjoint bits, so the sum is exact and independent of order. A
segment's words are masked to 32 bits and narrowed back to int32 when it
is hashed. Indices at or past the stream's end are discarded, not clamped
(JAX's mode="drop"): they land in one scratch word past the end.

The digest table dig is int32[1 + G, 8]: row 0 is an all-zero sentinel
that padding patches (child lane -1) point at, and segment s writes its
digests at rows gstart + 1 onwards.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .device import DeviceLadder, LadderedKeccak
from .keccak_fused import SegmentSpec
from .keccak_torch import MASK32, WORDS_PER_BLOCK, default_batched_keccak, \
    to_int32

MAX_SEGMENTS = 64


def _strips(d: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """[P, 8] digest words (u32 bits, int32 or int64) and byte shifts 0..3
    -> int64[P, 9] contribution strips with values in [0, 2**32): the
    digest's bytes moved to byte `shift` of a 9-word window, all other
    bytes zero. Counterpart of coreth_tpu/ops/keccak_resident.py:_strips.

    Values are non-negative int64 below 2**32, so `>>` is a logical shift
    and a shift by 32 (byte shift 0) yields 0, which JAX spells as
    minimum(rsh, 31) plus a where."""
    d = d.long() & MASK32
    z = torch.zeros((d.shape[0], 1), dtype=torch.int64, device=d.device)
    dpad = torch.cat([z, d, z], dim=1)                   # dpad[:, j] == D[j-1]
    lsh = (8 * shift.long())[:, None]
    rsh = 32 - lsh
    lo = dpad[:, :9] >> rsh
    hi = (dpad[:, 1:] << lsh) & MASK32
    return lo | hi


def _strip_contributions(dig: torch.Tensor, child_row: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """[P] child rows (+1-offset, 0 = zero sentinel) and byte shifts 0..3
    -> the int64[P, 9] strips of those rows of dig (_strips)."""
    return _strips(dig[child_row.long()], shift)


def _apply_patches(flat64: torch.Tensor, dig: torch.Tensor,
                   dstw: torch.Tensor, child: torch.Tensor,
                   shift: torch.Tensor) -> None:
    """Scatter-add one segment's strips into flat64 (length W + 1, the last
    word being scratch for dropped indices)."""
    w = flat64.shape[0] - 1
    strips = _strip_contributions(dig, child, shift)
    ar9 = torch.arange(9, dtype=torch.int64, device=flat64.device)
    idx = (dstw.long()[:, None] + ar9[None, :]).reshape(-1)
    idx = torch.where((idx >= 0) & (idx < w), idx, torch.full_like(idx, w))
    flat64.index_add_(0, idx, strips.reshape(-1))


def _step(seg_impl, flat64: torch.Tensor, dig: torch.Tensor,
          dstw: torch.Tensor, child: torch.Tensor, shift: torch.Tensor,
          word_off: int, spec: SegmentSpec) -> None:
    """One segment (keccak_planned.py:67): patch, slice, hash, store."""
    if spec.n_patches:
        _apply_patches(flat64, dig, dstw, child, shift)
    n_words = spec.lanes * spec.blocks * WORDS_PER_BLOCK
    words = to_int32(flat64[word_off:word_off + n_words] & MASK32)
    out = seg_impl(words.view(spec.lanes, spec.blocks, WORDS_PER_BLOCK))
    dig[spec.gstart + 1:spec.gstart + 1 + spec.lanes] = out


class PlannedCommit:
    """Execute a planner's word-space export on one device.

    seg_impl: the per-segment keccak, int32[P, L, 34] -> int32[P, 8]
    (default ops/keccak_cuda.segment_keccak: K1 for CUDA tensors, the plain
    version for CPU ones).

    fused=True runs the whole commit from TWO uploads (the word stream and
    one concatenated patch table); fused=False uploads the three patch
    tables separately and counts one host-level step per segment. Both give
    identical digests.

    After every run(): last_h2d_bytes / last_transfers / last_dispatches
    hold the commit's host-to-device traffic and host-level step count,
    last_device_ms the CUDA-event time from the first upload to the last
    digest and last_upload_ms its upload part (both None on the CPU)."""

    def __init__(self, seg_impl=None, fused: bool = True,
                 device: DeviceLike = None):
        if seg_impl is None:
            from .keccak_cuda import segment_keccak as seg_impl
        self._impl = seg_impl
        self.fused = fused
        self.device = resolve(device)
        self.last_h2d_bytes = 0
        self.last_transfers = 0
        self.last_dispatches = 0
        self.last_device_ms: Optional[float] = None
        self.last_upload_ms: Optional[float] = None

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=False)

    def run(self, specs: Sequence[SegmentSpec], flat_words: np.ndarray,
            dst_word: np.ndarray, child_lane: np.ndarray, shift: np.ndarray,
            root_pos: int, want_digests: bool = False
            ) -> Tuple[bytes, Optional[np.ndarray]]:
        """Returns (root32, dig uint32[G, 8] | None)."""
        n_seg = len(specs)
        if n_seg > MAX_SEGMENTS:
            raise ValueError(f"{n_seg} segments > MAX_SEGMENTS={MAX_SEGMENTS}")
        total_lanes = sum(s.lanes for s in specs)
        n_pat = len(dst_word)
        flat_i32 = np.ascontiguousarray(flat_words, dtype=np.uint32).view(
            np.int32)
        cuda = self.device.type == "cuda"
        if cuda:
            t0, t_up, t1 = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
            t0.record()

        fw = self._upload(flat_i32)
        if self.fused:
            aux = np.concatenate([
                dst_word.astype(np.int32),
                (child_lane + 1).astype(np.int32),
                shift.astype(np.int32),
            ]) if n_pat else np.zeros(0, np.int32)
            ax = self._upload(aux)
            dw, ch, sh = ax[:n_pat], ax[n_pat:2 * n_pat], ax[2 * n_pat:]
            self.last_h2d_bytes = flat_i32.nbytes + aux.nbytes
            self.last_transfers = 2
            self.last_dispatches = 1
        else:
            ch = self._upload((child_lane + 1).astype(np.int32))
            dw = self._upload(dst_word.astype(np.int32))
            sh = self._upload(shift.astype(np.int32))
            self.last_h2d_bytes = (flat_i32.nbytes + 3 * 4 * n_pat)
            self.last_transfers = 4
            self.last_dispatches = n_seg
        if cuda:
            t_up.record()

        # int64 word space plus one scratch word for dropped indices
        flat64 = torch.empty(fw.shape[0] + 1, dtype=torch.int64,
                             device=self.device)
        flat64[:-1] = fw.long() & MASK32
        flat64[-1] = 0
        del fw
        dig = torch.zeros((1 + total_lanes, 8), dtype=torch.int32,
                          device=self.device)
        word_off = patch_off = 0
        for s in specs:
            sl = slice(patch_off, patch_off + s.n_patches)
            _step(self._impl, flat64, dig, dw[sl], ch[sl], sh[sl], word_off, s)
            word_off += s.lanes * s.blocks * WORDS_PER_BLOCK
            patch_off += s.n_patches

        if cuda:
            t1.record()
        if want_digests:
            host = dig.cpu().numpy().view(np.uint32)
            root = host[root_pos + 1].astype("<u4").tobytes()
            result = (root, host[1:])
        else:
            root = dig[root_pos + 1].cpu().numpy().view(np.uint32)
            result = (root.astype("<u4").tobytes(), None)
        if cuda:
            t1.synchronize()
            self.last_device_ms = t0.elapsed_time(t1)
            self.last_upload_ms = t0.elapsed_time(t_up)
        return result


def plan_from_export(specs, flat_words, dst, child, shift, root_pos):
    """A plan exported by the JAX package (numpy arrays, specs as
    (blocks, lanes, gstart, n_patches) tuples) -> PlannedCommit.run's
    positional inputs, so one plan can feed both executors."""
    return (
        tuple(SegmentSpec(*map(int, s)) for s in specs),
        np.ascontiguousarray(flat_words, dtype=np.uint32),
        np.asarray(dst, dtype=np.int32),
        np.asarray(child, dtype=np.int32),
        np.asarray(shift, dtype=np.int32),
        int(root_pos),
    )


_default_commits: Dict[str, PlannedCommit] = {}


def default_planned_commit(device: DeviceLike = None) -> PlannedCommit:
    """Per-device PlannedCommit: K1 on CUDA, the plain torch version on the
    CPU (keccak_cuda.segment_keccak picks by the tensor's device)."""
    d = resolve(device)
    key = str(d)
    pc = _default_commits.get(key)
    if pc is None:
        pc = _default_commits[key] = PlannedCommit(device=d)
    return pc


class PlannedMode(LadderedKeccak):
    """Marker handed to Trie / StateTrie as `batch_keccak`: Trie.hash and
    StateDB.intermediate_root take the planned path when `planned` and
    `unhashed >= BATCH_THRESHOLD`. Counterpart of
    coreth_tpu/ops/device.py:PlannedModeKeccak.

    `planned` is a dynamic property, not a class attribute: while the
    degradation ladder is demoted it reads False, which flips both
    consumers (they getattr the marker per call) to their host-routed
    paths mid-run. Host and device hashing are bit-exact, so the only
    observable change is where the keccak runs.

    As there, it is the "batched" seam too (a LadderedKeccak on the
    commit's device: kernel K2 on CUDA, the host batch keccak while
    demoted), so the planned fallbacks' BatchedHasher and every other
    consumer of the seam call it as a plain batch keccak, msgs ->
    digests."""

    def __init__(self, commit: Optional[PlannedCommit] = None,
                 device: DeviceLike = None,
                 ladder: Optional[DeviceLadder] = None):
        self.commit = commit if commit is not None else \
            default_planned_commit(device)
        super().__init__(default_batched_keccak(self.commit.device), ladder)

    @property
    def planned(self) -> bool:
        return self._ladder.healthy
