"""Port Keccak (coreth_tpu_torch.ops) against the JAX package and the
pure-Python oracle, on identical words made by numpy from a seed. The
whole system is integer hashing, so every comparison is exact equality.

The JAX side of K2 runs as the JAX package's own tests run it on the CPU:
the XLA keccak256_blocks. Its batch shapes are the ones BatchedKeccak
pads a bucket to (128 lanes), so the compiles are shared."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coreth_tpu.ops import keccak_jax
from coreth_tpu.ops.keccak_staged import _segment_keccak
from coreth_tpu_torch.device import hopper_available
from coreth_tpu_torch.ops import keccak_cuda
from coreth_tpu_torch.ops.keccak_ref import keccak256 as ref_keccak
from coreth_tpu_torch.ops.keccak_staged import segment_keccak_plain
from coreth_tpu_torch.ops.keccak_torch import RATE, BatchedKeccak, \
    _pad_batch, digest_words_to_bytes, int32_to_words, \
    keccak256_blocks_plain, pack_messages, words_to_int32

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


# ---------------------------------------------------------------- K2


def _blocks_inputs(b: int, blocks: int, seed: int):
    """uint32[b, blocks, 34] + int32[b]: the first lanes are real padded
    messages of 1..blocks blocks, then edge lanes with nblocks 0, 1,
    blocks and blocks + 1 (and a negative count), the rest random words
    with random counts in [1, blocks]."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(b, blocks, 34), dtype=np.uint32)
    nblocks = rng.integers(1, blocks + 1, b).astype(np.int32)
    lengths = rng.integers(0, blocks * RATE, 6)
    msgs = [rng.bytes(int(n)) for n in lengths]
    packed, nb = pack_messages(msgs)
    words[:6, :packed.shape[1]] = packed
    words[:6, packed.shape[1]:] = 0
    nblocks[:6] = nb
    nblocks[6:11] = (0, 1, blocks, blocks + 1, -3)
    return words, nblocks, msgs


@pytest.mark.parametrize("b,blocks", [(128, 1), (128, 4), (128, 16)])
def test_blocks_plain_matches_jax_and_ref(b, blocks):
    words, nblocks, msgs = _blocks_inputs(b, blocks, seed=b + blocks)
    got = int32_to_words(keccak256_blocks_plain(
        torch.from_numpy(words_to_int32(words)), torch.from_numpy(nblocks)))
    want = np.asarray(keccak_jax.keccak256_blocks(jnp.asarray(words),
                                                  jnp.asarray(nblocks)))
    np.testing.assert_array_equal(got, want)
    assert digest_words_to_bytes(got[:6]) == [ref_keccak(m) for m in msgs]
    # nblocks 0, L + 1 and negative are never snapshotted: zero digests
    assert not got[[6, 9, 10]].any()
    assert got[[7, 8]].any(axis=1).all()


def test_batched_keccak_matches_jax_and_ref():
    rng = np.random.default_rng(11)
    msgs = [rng.bytes(n) for n in (0, 135, 136, 300, 1200, 1, 134, 271, 272)]
    port = BatchedKeccak(device="cpu")
    got = port.digests(msgs)
    assert got == keccak_jax.BatchedKeccak().digests(msgs)
    assert got == [ref_keccak(m) for m in msgs]
    # buckets of 1, 2, 4 and 16 blocks, each padded to 128 lanes
    assert (port.calls, port.launches, port.lanes) == (1, 4, len(msgs))
    assert port.padded_lanes == 4 * 128
    assert port.h2d_bytes == 128 * (1 + 2 + 4 + 16) * 136 + 4 * 128 * 4
    assert port.device_ms is None
    assert port.digests([]) == [] and port.calls == 1


@pytest.mark.parametrize("b,multiple", [(1, 128), (128, 128), (129, 128),
                                        (5, 1024), (1025, 1024), (0, 1)])
def test_pad_batch_matches_jax(b, multiple):
    rng = np.random.default_rng(b)
    words = rng.integers(0, 2**32, size=(b, 2, 34), dtype=np.uint32)
    nblocks = rng.integers(1, 3, b).astype(np.int32)
    got = _pad_batch(words, nblocks, multiple)
    want = keccak_jax._pad_batch(words, nblocks, multiple)
    assert got[2] == want[2] == b
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype


def test_blocks_wrapper_on_cpu_takes_plain_version():
    words, nblocks, _ = _blocks_inputs(40, 3, seed=4)
    x = torch.from_numpy(words_to_int32(words))
    nb = torch.from_numpy(nblocks)
    before = (keccak_cuda.blocks_launches, keccak_cuda.launches)
    got = keccak_cuda.keccak256_blocks(x, nb)
    assert (keccak_cuda.blocks_launches, keccak_cuda.launches) == before
    assert torch.equal(got, keccak256_blocks_plain(x, nb))
    assert got.dtype == torch.int32 and got.shape == (40, 8)


@pytest.mark.parametrize("bad", [
    "words_int64", "nblocks_int64", "two_dims", "width_33", "zero_blocks",
    "b_mismatch", "nblocks_2d", "strided_words", "strided_nblocks",
    "numpy_nblocks",
])
def test_blocks_wrapper_rejects_bad_input(bad):
    words = torch.zeros((8, 2, 34), dtype=torch.int32)
    nblocks = torch.ones(8, dtype=torch.int32)
    w, nb = {
        "words_int64": (words.long(), nblocks),
        "nblocks_int64": (words, nblocks.long()),
        "two_dims": (words.reshape(8, 68), nblocks),
        "width_33": (torch.zeros((8, 2, 33), dtype=torch.int32), nblocks),
        "zero_blocks": (torch.zeros((8, 0, 34), dtype=torch.int32), nblocks),
        "b_mismatch": (words, torch.ones(7, dtype=torch.int32)),
        "nblocks_2d": (words, nblocks.reshape(8, 1)),
        "strided_words": (torch.zeros((8, 4, 34), dtype=torch.int32)[:, ::2],
                          nblocks),
        "strided_nblocks": (words, torch.ones(16, dtype=torch.int32)[::2]),
        "numpy_nblocks": (words, np.ones(8, np.int32)),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        keccak_cuda.keccak256_blocks(w, nb)


@pytest.mark.cuda
def test_k2_matches_plain_on_card():
    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    for b, blocks in ((11, 1), (31, 3), (1040, 9), (4097, 17)):
        words, nblocks, msgs = _blocks_inputs(b, blocks, seed=b)
        x = torch.from_numpy(words_to_int32(words)).cuda()
        nb = torch.from_numpy(nblocks).cuda()
        before = keccak_cuda.blocks_launches
        got = keccak_cuda.keccak256_blocks(x, nb)
        torch.cuda.synchronize()
        assert keccak_cuda.blocks_launches == before + 1
        assert torch.equal(got, keccak256_blocks_plain(x, nb))
        digests = digest_words_to_bytes(int32_to_words(got)[:6])
        assert digests == [ref_keccak(m) for m in msgs]
    msgs = [b"", b"\x80", b"abc", bytes(135), bytes(136), bytes(1200)]
    assert BatchedKeccak(device="cuda").digests(msgs) == \
        [ref_keccak(m) for m in msgs]
