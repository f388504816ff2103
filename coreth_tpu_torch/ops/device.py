"""The device-hasher seam: resolve a CacheConfig.device_hasher mode to the
batch keccak the tries carry. Counterpart of coreth_tpu/ops/device.py:325-449
(get_batch_keccak, LadderedKeccak, PlannedModeKeccak), without the
degradation ladder (ROADMAP "Still to port", item 5): a device error
propagates instead of demoting the seam to the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..device import DeviceLike
from ..trie.hasher import count_keccak_batch
from .keccak_torch import BatchedKeccak, default_batched_keccak


class BatchedModeKeccak:
    """The "batched" mode's seam, msgs -> digests: counts each batch in
    trie.hasher.count_keccak_batch, then hashes it with BatchedKeccak
    (kernel K2 on CUDA). Trie.hash hands it to BatchedHasher, which hashes
    each trie level in one call. Counterpart of LadderedKeccak, minus the
    ladder. The planned marker (ops/keccak_planned.PlannedMode) is one too,
    as the reference's PlannedModeKeccak is a LadderedKeccak."""

    def __init__(self, batched: BatchedKeccak):
        self.batched = batched

    def __call__(self, msgs: Sequence[bytes]) -> list:
        count_keccak_batch(len(msgs))
        return self.batched.digests(msgs)


def get_batch_keccak(mode: str = "auto", device: DeviceLike = None
                     ) -> Optional[BatchedModeKeccak]:
    """Resolve a device-hasher mode to a batch keccak, or None.

    mode: "off"      None: the recursive CPU Hasher everywhere
          "batched"  level-batched hashing (trie/hasher.BatchedHasher),
                     one K2 batch per trie level and block-count bucket
          "planned"  the planned executor: a state commit's storage tries
                     and account trie in one device program (kernel K1);
                     the marker is still callable as a plain batch keccak
          "auto"     the same as "planned"
          "fused"    not ported (ROADMAP "Still to port", legacy executors)

    `device` follows device.resolve: None is CUDA. Unlike the reference,
    "auto" does not fall back to CPU-only hashing when the device is
    missing: without a Hopper CUDA device every mode but "off" raises, as
    every entry point of the port does."""
    if mode == "off":
        return None
    if mode == "fused":
        raise NotImplementedError(
            "device-hasher 'fused' is not ported (ROADMAP 'Still to port', "
            "item 7: legacy executors)")
    if mode == "batched":
        return BatchedModeKeccak(default_batched_keccak(device))
    if mode in ("planned", "auto"):
        from .keccak_planned import PlannedMode

        return PlannedMode(device=device)
    raise ValueError(f"unknown device-hasher mode {mode!r}")
