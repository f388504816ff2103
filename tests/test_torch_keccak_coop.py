"""The cooperative Keccak-f[1600] of coreth_tpu_torch/ops/csrc/keccak_f.cuh
(five threads of a warp per state), emulated in numpy thread by thread and
held bit for bit against the port's pure-Python permutation
(ops/keccak_ref.py) and the JAX package's (keccak_jax.keccak_f1600).

The emulation reads the rotation, pi and round-constant tables out of the
CUDA header by name, so a wrong entry there fails here on the CPU. It
follows the kernels' schedule: per-thread column registers, the group's
shuffles as lookups into the other threads' values, the group's
double-buffered shared tile as an array, the absorb split by column and
the digest written by threads 0-3. The CUDA cases (marker `cuda`) hold
each variant of K1 and K2 against the plain versions on the card."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coreth_tpu.ops import keccak_jax
from coreth_tpu_torch.device import hopper_available
from coreth_tpu_torch.ops import keccak_cuda
from coreth_tpu_torch.ops.keccak_ref import _ROTC, keccak256 as ref_keccak
from coreth_tpu_torch.ops.keccak_ref import _ROUND_CONSTANTS, keccak_f1600
from coreth_tpu_torch.ops.keccak_staged import segment_keccak_plain
from coreth_tpu_torch.ops.keccak_torch import RATE, digest_words_to_bytes, \
    int32_to_words, keccak256_blocks_plain, pack_messages, words_to_int32

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "coreth_tpu_torch", "ops", "csrc", "keccak_f.cuh")
M32 = np.uint64(0xFFFFFFFF)
GROUPS = 6  # kCoopGroupsPerWarp


def _table(name: str) -> list:
    """The integers of `__constant__ <type> name[...] = {...};`."""
    src = open(HEADER).read()
    m = re.search(r"__constant__\s+\w+\s+" + name + r"(?:\[\d+\])+\s*=\s*"
                  r"\{(.*?)\};", src, re.S)
    assert m, f"{name} not found in {HEADER}"
    return [int(v.rstrip("ULul"), 0) for v in re.findall(
        r"0x[0-9a-fA-F]+U*L*|\d+", m.group(1))]


def _constant(name: str) -> int:
    """The value of `constexpr int name = <int or expression>;`, with
    earlier constants of the header substituted."""
    src = open(HEADER).read()
    m = re.search(r"constexpr\s+int\s+" + name + r"\s*=\s*([^;]+);", src)
    assert m, f"{name} not found in {HEADER}"
    expr = re.sub(r"k[A-Z]\w*", lambda k: str(_constant(k.group(0))),
                  m.group(1))
    assert re.fullmatch(r"[\d\s+*()-]+", expr), expr
    return int(eval(expr))


RHO = np.array(_table("kCoopRho")).reshape(5, 5)  # [x][y]
PI = np.array(_table("kCoopPi")).reshape(5, 5)    # [x][y]
RC = _table("kRC")
ROW = _constant("kCoopRowLanes")    # B's lane (X, Y) at X + ROW * Y
BUF = _constant("kCoopBufLanes")    # the second buffer's offset
TILE = _constant("kCoopTileLanes")  # one group's tile


def test_tables_match_the_reference():
    for x in range(5):
        for y in range(5):
            assert RHO[x][y] == _ROTC[x + 5 * y]
            assert PI[x][y] == y + ROW * ((2 * x + 3 * y) % 5)
    assert sorted(PI.ravel()) == sorted(X + ROW * Y for X in range(5)
                                        for Y in range(5))
    assert max(PI.ravel()) < BUF and 2 * BUF <= TILE
    assert RC == list(_ROUND_CONSTANTS)


def _worst_conflict(word_of_thread) -> int:
    """The most threads of one half-warp that a warp-wide 64-bit shared
    access sends to one bank at different addresses; `word_of_thread(t)`
    is the first of the two words thread t touches."""
    worst = 1
    for half in (THREADS[:16], THREADS[16:]):
        banks = {}
        for t in half:
            word = word_of_thread(t)
            for bank in (word % 32, (word + 1) % 32):
                banks.setdefault(bank, set()).add(word)
        worst = max([worst] + [len(w) for w in banks.values()])
    return worst


def _layout_conflicts(group_lanes, row_lanes, pi, buf=0):
    """(chi's loads at columns x, x + 1, x + 2, pi's stores): the worst
    conflict over the rows, for tiles `group_lanes` apart with rows
    `row_lanes` apart and pi's destinations pi[x][y]."""
    def word(t, lane):
        return 2 * (t.group * group_lanes + buf + lane)

    def chi(col):
        return max(_worst_conflict(lambda t: word(t, col(t) + row_lanes * y))
                   for y in range(5))

    return (chi(lambda t: t.x), chi(lambda t: t.x1), chi(lambda t: t.x2),
            max(_worst_conflict(lambda t: word(t, pi[t.x][y]))
                for y in range(5)))


@pytest.mark.parametrize("buf", [0, 1])
def test_tile_layout_bounds_bank_conflicts(buf):
    """The bounds keccak_f.cuh states for its tile layout."""
    assert _layout_conflicts(TILE, ROW, PI, buf * BUF) == (1, 2, 2, 2)


def _funnelshift_l(lo, hi, n: int):
    """CUDA's __funnelshift_l: the top 32 bits of (hi:lo) << (n & 31)."""
    s = np.uint64(n & 31)
    return ((hi << s) | (lo >> (np.uint64(32) - s))) & M32


def _rotl_var(v, n: int):
    """keccak_f.cuh:rotl_var, in 32-bit halves."""
    lo, hi = v & M32, v >> np.uint64(32)
    t1, t2 = _funnelshift_l(lo, hi, n), _funnelshift_l(hi, lo, n)
    if n >= 32:
        t1, t2 = t2, t1
    return (t1 << np.uint64(32)) | t2


def test_rotl_var_is_a_64_bit_rotation():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 2**64, 16, dtype=np.uint64)
    for n in range(64):
        want = [((int(x) << n) | (int(x) >> (64 - n))) & (2**64 - 1)
                for x in v]
        assert [int(x) for x in _rotl_var(v, n)] == want, n


class _Thread:
    """keccak_f.cuh:CoopThread for warp lane 5 * group + x (the warp's two
    idle lanes, 30 and 31, leave at once)."""

    def __init__(self, group: int, x: int):
        base = 5 * group
        self.group, self.x = group, x
        self.prev, self.next = base + (x + 4) % 5, base + (x + 1) % 5
        self.x1, self.x2 = (x + 1) % 5, (x + 2) % 5
        self.rho, self.pi = list(RHO[x]), list(PI[x])


THREADS = [_Thread(g, x) for g in range(GROUPS) for x in range(5)]


def _permute(regs, tiles):
    """keccak_f1600_coop over every group of a batch of warps at once.

    regs[lane][y]: uint64[W], lane x + 5y of warp lane `lane`'s column;
    tiles[group]: uint64[TILE, W], the group's double-buffered tile."""
    for r in range(24):
        buf = (r & 1) * BUF
        c = [np.bitwise_xor.reduce(regs[i]) for i in range(len(THREADS))]
        for i, t in enumerate(THREADS):
            d = c[t.prev] ^ _rotl_var(c[t.next], 1)  # two __shfl_sync
            for y in range(5):
                tiles[t.group][buf + t.pi[y]] = _rotl_var(regs[i][y] ^ d,
                                                          t.rho[y])
        # __syncwarp(group mask)
        for i, t in enumerate(THREADS):
            b = tiles[t.group][buf:]
            for y in range(5):
                regs[i][y] = b[t.x + ROW * y] ^ (~b[t.x1 + ROW * y]
                                                 & b[t.x2 + ROW * y])
            if t.x == 0:
                regs[i][0] = regs[i][0] ^ np.uint64(RC[r])


def _emulate_states(states: np.ndarray) -> np.ndarray:
    """uint64[N, 25] -> uint64[N, 25] through the five-thread schedule,
    six states to an emulated warp."""
    n = states.shape[0]
    w = -(-n // GROUPS)
    full = np.zeros((w * GROUPS, 25), np.uint64)
    full[:n] = states
    per_warp = full.reshape(w, GROUPS, 25)
    regs = [[per_warp[:, t.group, t.x + 5 * y].copy() for y in range(5)]
            for t in THREADS]
    tiles = [np.zeros((TILE, w), np.uint64) for _ in range(GROUPS)]
    _permute(regs, tiles)
    out = np.zeros((w, GROUPS, 25), np.uint64)
    for i, t in enumerate(THREADS):
        for y in range(5):
            out[:, t.group, t.x + 5 * y] = regs[i][y]
    return out.reshape(-1, 25)[:n]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coop_permutation_matches_ref_and_jax(seed):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 2**64, size=(13, 25), dtype=np.uint64)
    got = _emulate_states(states)
    for s, g in zip(states, got):
        assert [int(v) for v in g] == keccak_f1600([int(v) for v in s])
    lo, hi = keccak_jax.keccak_f1600(
        [jnp.asarray((states[:, i] & M32).astype(np.uint32))
         for i in range(25)],
        [jnp.asarray((states[:, i] >> np.uint64(32)).astype(np.uint32))
         for i in range(25)])
    want = np.stack([np.asarray(lo[i]).astype(np.uint64)
                     | (np.asarray(hi[i]).astype(np.uint64) << np.uint64(32))
                     for i in range(25)], axis=1)
    np.testing.assert_array_equal(got, want)


def _emulate_kernel(words: np.ndarray, nblocks: np.ndarray) -> np.ndarray:
    """keccak_blocks_coop_kernel (and, with every count L,
    segment_keccak_coop_kernel): uint32[B, L, 34] + int32[B] ->
    uint32[B, 8]. Lane b is group b % 6 of emulated warp b // 6; a group
    runs its own lane's count of blocks, none for a count outside [1, L]
    (an all-zero digest)."""
    b, blocks, _ = words.shape
    w = -(-b // GROUPS)
    nb = np.zeros(w * GROUPS, np.int64)
    nb[:b] = nblocks
    nb = nb.reshape(w, GROUPS)
    count = np.where((nb >= 1) & (nb <= blocks), nb, 0)
    wd = np.zeros((w * GROUPS, blocks, 34), np.uint64)
    wd[:b] = words
    wd = wd.reshape(w, GROUPS, blocks, 34)
    regs = [[np.zeros(w, np.uint64) for _ in range(5)] for _ in THREADS]
    tiles = [np.zeros((TILE, w), np.uint64) for _ in range(GROUPS)]
    for j in range(int(count.max(initial=0))):
        new = [[v.copy() for v in r] for r in regs]
        for i, t in enumerate(THREADS):  # absorb_block_coop
            for y in range(4):
                k = t.x + 5 * y
                if k < 17:
                    new[i][y] ^= (wd[:, t.group, j, 2 * k]
                                  | (wd[:, t.group, j, 2 * k + 1]
                                     << np.uint64(32)))
        _permute(new, tiles)
        for i, t in enumerate(THREADS):  # groups past their count are gone
            live = j < count[:, t.group]
            for y in range(5):
                regs[i][y] = np.where(live, new[i][y], regs[i][y])
    out = np.zeros((w, GROUPS, 8), np.uint64)
    for i, t in enumerate(THREADS):  # store_digest_coop
        if t.x < 4:
            out[:, t.group, 2 * t.x] = regs[i][0] & M32
            out[:, t.group, 2 * t.x + 1] = regs[i][0] >> np.uint64(32)
    return out.reshape(-1, 8)[:b].astype(np.uint32)


@pytest.mark.parametrize("b,blocks", [(1, 1), (7, 3), (13, 4), (20, 2)])
def test_coop_blocks_schedule_matches_plain(b, blocks):
    rng = np.random.default_rng(b * 10 + blocks)
    words = rng.integers(0, 2**32, size=(b, blocks, 34), dtype=np.uint32)
    nblocks = rng.integers(1, blocks + 1, b).astype(np.int32)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, blocks * RATE,
                                                    min(b, 3))]
    packed, nb = pack_messages(msgs)
    words[:len(msgs)] = 0
    words[:len(msgs), :packed.shape[1]] = packed
    nblocks[:len(msgs)] = nb
    if b >= 7:
        nblocks[3:6] = (0, blocks + 1, -2)  # never snapshotted: zeros
    got = _emulate_kernel(words, nblocks)
    want = int32_to_words(keccak256_blocks_plain(
        torch.from_numpy(words_to_int32(words)), torch.from_numpy(nblocks)))
    np.testing.assert_array_equal(got, want)
    assert digest_words_to_bytes(got[:len(msgs)]) == \
        [ref_keccak(m) for m in msgs]
    if b >= 7:
        assert not got[3:6].any()


@pytest.mark.parametrize("p,blocks", [(5, 1), (11, 2)])
def test_coop_segment_schedule_matches_plain(p, blocks):
    rng = np.random.default_rng(p)
    words = rng.integers(0, 2**32, size=(p, blocks, 34), dtype=np.uint32)
    got = _emulate_kernel(words, np.full(p, blocks, np.int32))
    want = int32_to_words(segment_keccak_plain(
        torch.from_numpy(words_to_int32(words))))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ the wrappers' variant


def _k1(x, nb, variant):
    return keccak_cuda.segment_keccak(x, variant=variant)


def _k2(x, nb, variant):
    return keccak_cuda.keccak256_blocks(x, nb, variant=variant)


@pytest.mark.parametrize("variant", [0, 3, -1, "coop"])
@pytest.mark.parametrize("call", [_k1, _k2], ids=["K1", "K2"])
def test_wrappers_reject_a_bad_variant(call, variant):
    x = torch.zeros((8, 2, 34), dtype=torch.int32)
    nb = torch.ones(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        call(x, nb, variant)


@pytest.mark.parametrize("variant", [None, 1, 2])
@pytest.mark.parametrize("call,plain", [
    (_k1, lambda x, nb: segment_keccak_plain(x)),
    (_k2, keccak256_blocks_plain)], ids=["K1", "K2"])
def test_cpu_tensor_takes_plain_for_any_variant(call, plain, variant):
    rng = np.random.default_rng(9)
    words = rng.integers(0, 2**32, size=(9, 2, 34), dtype=np.uint32)
    x = torch.from_numpy(words_to_int32(words))
    nb = torch.from_numpy(rng.integers(0, 4, 9).astype(np.int32))
    before = (keccak_cuda.launches, keccak_cuda.launches_coop,
              keccak_cuda.blocks_launches, keccak_cuda.blocks_launches_coop)
    got = call(x, nb, variant)
    assert (keccak_cuda.launches, keccak_cuda.launches_coop,
            keccak_cuda.blocks_launches,
            keccak_cuda.blocks_launches_coop) == before
    assert torch.equal(got, plain(x, nb))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [None, 1, 2])
def test_each_variant_matches_plain_on_card(variant):
    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    rng = np.random.default_rng(4)
    for b, blocks in ((1, 1), (31, 3), (1040, 9), (9000, 2)):
        words = rng.integers(0, 2**32, size=(b, blocks, 34), dtype=np.uint32)
        nblocks = rng.integers(0, blocks + 2, b).astype(np.int32)
        x = torch.from_numpy(words_to_int32(words)).cuda()
        nb = torch.from_numpy(nblocks).cuda()
        for call, plain, kernel, coop in (
                (_k1, lambda x, nb: segment_keccak_plain(x), keccak_cuda.K1,
                 "launches_coop"),
                (_k2, keccak256_blocks_plain, keccak_cuda.K2,
                 "blocks_launches_coop")):
            before = getattr(keccak_cuda, coop)
            got = call(x, nb, variant)
            torch.cuda.synchronize()
            assert torch.equal(got, plain(x, nb)), (b, blocks, variant)
            want_coop = (variant == 2 or variant is None
                         and b <= kernel.coop_max_lanes)
            assert getattr(keccak_cuda, coop) - before == int(want_coop)
