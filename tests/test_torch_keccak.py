"""Port Keccak (coreth_tpu_torch.ops) against the JAX package and the
pure-Python oracle, on identical words made by numpy from a seed. The
whole system is integer hashing, so every comparison is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coreth_tpu.ops.keccak_staged import _segment_keccak
from coreth_tpu_torch.device import hopper_available
from coreth_tpu_torch.ops import keccak_cuda
from coreth_tpu_torch.ops.keccak_ref import keccak256 as ref_keccak
from coreth_tpu_torch.ops.keccak_staged import segment_keccak_plain
from coreth_tpu_torch.ops.keccak_torch import RATE, digest_words_to_bytes, \
    int32_to_words, pack_messages, words_to_int32

KNOWN = {
    b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
    b"\x80": "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421",
    b"abc": "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
}


def _segment_words(p: int, blocks: int, seed: int):
    """uint32[p, blocks, 34]: the first lanes are real keccak-padded
    messages of exactly `blocks` blocks, the rest random words."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(p, blocks, 34), dtype=np.uint32)
    n_msgs = min(p, 6)
    lo, hi = (blocks - 1) * RATE, blocks * RATE - 1
    msgs = [rng.bytes(int(n)) for n in rng.integers(lo, hi + 1, n_msgs)]
    packed, nblocks = pack_messages(msgs)
    assert (nblocks == blocks).all()
    words[:n_msgs] = packed
    return words, msgs


def _plain(words: np.ndarray) -> np.ndarray:
    return int32_to_words(segment_keccak_plain(
        torch.from_numpy(words_to_int32(words))))


@pytest.mark.parametrize("blocks", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("p", [16, 1024, 1040])
def test_plain_segment_keccak_matches_jax_and_ref(p, blocks):
    words, msgs = _segment_words(p, blocks, seed=100 * p + blocks)
    got = _plain(words)
    want = np.asarray(_segment_keccak(jnp.asarray(words)))
    np.testing.assert_array_equal(got, want)
    digests = digest_words_to_bytes(got[:len(msgs)])
    assert digests == [ref_keccak(m) for m in msgs]


def test_known_vectors():
    words, _ = pack_messages(list(KNOWN))
    digests = digest_words_to_bytes(_plain(words))
    for (msg, want), got in zip(KNOWN.items(), digests):
        assert got.hex() == want, msg
        assert ref_keccak(msg).hex() == want


def test_native_host_keccak_matches_ref():
    from coreth_tpu_torch.native import keccak256, keccak256_batch

    rng = np.random.default_rng(5)
    msgs = [rng.bytes(int(n)) for n in (0, 1, 135, 136, 137, 300)]
    want = [ref_keccak(m) for m in msgs]
    assert [keccak256(m) for m in msgs] == want
    assert keccak256_batch(msgs) == want
    assert keccak256_batch(msgs, threads=3) == want


def test_wrapper_on_cpu_takes_plain_version():
    words, _ = _segment_words(40, 2, seed=3)
    x = torch.from_numpy(words_to_int32(words))
    before = keccak_cuda.launches
    got = keccak_cuda.segment_keccak(x)
    assert keccak_cuda.launches == before  # no kernel launched
    assert torch.equal(got, segment_keccak_plain(x))
    assert got.dtype == torch.int32 and got.shape == (40, 8)


@pytest.mark.parametrize("bad", [
    "int64", "uint8", "two_dims", "width_33", "zero_blocks", "strided",
    "numpy",
])
def test_wrapper_rejects_bad_input(bad):
    good = torch.zeros((8, 2, 34), dtype=torch.int32)
    x = {
        "int64": good.long(),
        "uint8": torch.zeros((8, 2, 34), dtype=torch.uint8),
        "two_dims": good.reshape(8, 68),
        "width_33": torch.zeros((8, 2, 33), dtype=torch.int32),
        "zero_blocks": torch.zeros((8, 0, 34), dtype=torch.int32),
        "strided": torch.zeros((8, 4, 34), dtype=torch.int32)[:, ::2],
        "numpy": np.zeros((8, 2, 34), np.int32),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        keccak_cuda.segment_keccak(x)


@pytest.mark.cuda
def test_k1_matches_plain_on_card():
    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    for p, blocks in ((1, 1), (31, 3), (1040, 9), (4097, 17)):
        words, msgs = _segment_words(p, blocks, seed=p + blocks)
        x = torch.from_numpy(words_to_int32(words)).cuda()
        before = keccak_cuda.launches
        got = keccak_cuda.segment_keccak(x)
        torch.cuda.synchronize()
        assert keccak_cuda.launches == before + 1
        assert torch.equal(got, segment_keccak_plain(x))
        digests = digest_words_to_bytes(int32_to_words(got)[:len(msgs)])
        assert digests == [ref_keccak(m) for m in msgs]
