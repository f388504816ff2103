"""The plain Keccak-f[1600] of the port (ops/keccak_torch.keccak_f1600: the
stacked [25, N] form that kernels K1 and K2 are held against) over random
states, against the per-lane textbook permutation of ops/keccak_ref.py and
against hashlib's SHA3-256, which shares the permutation and differs from
Keccak-256 only in its padding byte. Bit-equal, tolerance zero."""

import hashlib

import numpy as np
import pytest
import torch

from coreth_tpu_torch.ops import keccak_ref
from coreth_tpu_torch.ops.keccak_torch import keccak_f1600

RATE = 136  # bytes absorbed per block by a 256-bit Keccak sponge


def _as_lanes(states: np.ndarray) -> list:
    """uint64[N, 25] -> 25 int64 tensors of shape [N]."""
    t = torch.from_numpy(states.view(np.int64).copy())
    return list(t.T.contiguous().unbind(0))


def _from_lanes(lanes) -> np.ndarray:
    return torch.stack(lanes, 1).numpy().view(np.uint64)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_stacked_form_equals_the_per_lane_permutation(n):
    rng = np.random.default_rng(100 + n)
    states = rng.integers(0, 2**64, size=(n, 25), dtype=np.uint64)
    got = _from_lanes(keccak_f1600(_as_lanes(states)))
    for i in range(n):
        want = keccak_ref.keccak_f1600([int(v) for v in states[i]])
        assert [int(v) for v in got[i]] == want, f"state {i}"


@pytest.mark.parametrize("length", [0, 3, 135, 136, 300])
def test_sponge_on_the_plain_permutation_equals_hashlib_sha3(length):
    """SHA3-256 (padding 0x06 ... 0x80) through a sponge on keccak_f1600."""
    msg = np.random.default_rng(length).bytes(length)
    padded = bytearray(msg + b"\x06" + b"\x00" * (-(length + 1) % RATE))
    padded[-1] |= 0x80
    state = np.zeros((1, 25), np.uint64)
    for off in range(0, len(padded), RATE):
        block = np.frombuffer(bytes(padded[off:off + RATE]), "<u8")
        state[0, :RATE // 8] ^= block
        state = _from_lanes(keccak_f1600(_as_lanes(state)))
    digest = state[0, :4].astype("<u8").tobytes()
    assert digest == hashlib.sha3_256(msg).digest()
