"""The yardstick for the port's kernels: the card's peaks and each
kernel's least time from its shapes.

Peaks of one NVIDIA H100 SXM at its full 700 W power limit:
  HBM3: 3.35 TB/s (NVIDIA's data sheet).
  32-bit integer ALU: 132 SMs x 64 INT32 lanes x 1.98 GHz boost =
    16.7 Tops/s. Derived from the SM's layout, not on the data sheet;
    K1 is integer work (Keccak's XOR, AND-NOT and rotates), so this is
    its compute roof.
A card set below 700 W runs slower under load; every result line carries
the card's power limit beside these numbers.
"""

from __future__ import annotations

# 32-bit integer operations per 136-byte block absorbed: 24 rounds of
# about 180 (with LOP3 folding three-input logic) plus the 34-word XOR of
# the block (the model in csrc/segment_keccak.cu's header)
K1_OPS_PER_BLOCK = 24 * 180 + 34
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
RATE = 136  # bytes a Keccak block absorbs


def k1_bound_s(lanes: int, blocks: int) -> float:
    """Least time of one K1 launch over [lanes, blocks, 34] words: the
    larger of its integer operations at the integer peak and its bytes
    (each input block read once, each 32-byte digest written once) at the
    HBM peak."""
    ops = lanes * blocks * K1_OPS_PER_BLOCK
    nbytes = lanes * blocks * RATE + lanes * 32
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


# the kernel names K1's two variants show in a device trace
K1_KERNELS = ("segment_keccak_kernel", "segment_keccak_coop_kernel")


class K1Shapes:
    """A segment-Keccak callable that records the shape of each call while
    `on`, then calls the one it wraps (the same kernel)."""

    def __init__(self, inner):
        self.inner = inner
        self.on = False
        self.shapes = []

    def __call__(self, words):
        if self.on:
            self.shapes.append((int(words.shape[0]), int(words.shape[1])))
        return self.inner(words)
