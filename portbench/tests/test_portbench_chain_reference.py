"""The VM mix's plain reference (portbench/reference/chain.py) against the
published schedule by hand: the gas of a transfer and of one
store-and-log call, the base fee of the first blocks, and the roots of a
small block against the textbook trie (reference/simple_trie.py)."""

import json
import os

import pytest

from portbench.reference import chain, simple_trie
from portbench.reference.chain import (ChainReference, PlainTx,
                                       account_rlp, normalize_key, slot_rlp)
from portbench.reference.keccak import keccak256_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CODE = bytes.fromhex(json.load(open(os.path.join(
    ROOT, "portbench", "traffic", "blocks.json")))["contract_code"])
FUND = 10**21
FEE_CAP = 10**12


def world(n=6, slots=3):
    """Accounts 0..n-1: 0 a contract with `slots` slots of 0x01..., 1 and
    2 senders, the last the coinbase."""
    addrs = [bytes([0x10 + i]) * 20 for i in range(n)]
    storage = {0: {bytes([0x40 + s]) * 32: b"\x01" + bytes([0x70 + s]) * 31
                   for s in range(slots)}}
    return ChainReference(addrs, [5] * n, [FUND] * n, {0: CODE}, storage,
                          n - 1, 15_000_000, 10)


def call_data(writes):
    return b"".join(k + v for k, v in writes)


def test_transfer_gas_and_fees():
    ref = world()
    tx = PlainTx(1, 5, 3, 777, 21000, FEE_CAP, 0, b"", hash=b"t")
    assert ref.apply_block([tx]) == [(b"t", 1, 21000)]
    fee = 21000 * chain.INITIAL_BASE_FEE  # tip 0: the price is the base fee
    assert ref.balance[1] == FUND - 777 - fee
    assert ref.balance[3] == FUND + 777
    assert ref.balance[5] == FUND + fee
    assert ref.nonce[1] == 6


def test_store_and_log_call_gas():
    """One call writing two existing slots and two new ones, by hand:
    intrinsic 21,000 + 16 a non-zero calldata byte + 4 a zero one; then
    the code: PUSH1 (3); per pair the loop head JUMPDEST 1, DUP1 3,
    CALLDATASIZE 2, GT 3, ISZERO 3, PUSH1 3, JUMPI 10, the body DUP1,
    PUSH1, ADD, CALLDATALOAD, DUP2, CALLDATALOAD 3 each, SSTORE, PUSH1 3,
    ADD 3, PUSH1 3, JUMP 8 (60 a pair besides the SSTORE); the SSTORE cold
    (2,100) plus 2,900 on a slot that holds a value (5,000 - 2,100) or
    20,000 on an empty one (EIP-2929, EIP-2200); the last loop head 25;
    the tail JUMPDEST 1, CALLER 2, three PUSH1 9, CALLDATACOPY 3 + 3 x 2
    words + 6 of memory for 2 words (3 x 2 + 2^2 / 512), two PUSH1 6,
    LOG1 375 + 375 + 8 x 64."""
    ref = world()
    old = [bytes([0x40 + s]) * 32 for s in range(2)]
    new = [b"\x52" * 32, b"\x54" * 32]
    writes = [(k, b"\x04" + b"\x99" * 31) for k in old] + \
        [(k, b"\x05" + b"\x98" * 30 + b"\x00") for k in new]
    data = call_data(writes)
    zeros = 2
    assert data.count(0) == zeros
    intrinsic = 21000 + 16 * (len(data) - zeros) + 4 * zeros
    loop = 4 * 60 + 2 * (2100 + 2900) + 2 * (2100 + 20000)
    tail = 25 + 1 + 2 + 9 + (3 + 6 + 6) + 6 + (375 + 375 + 8 * 64)
    want = intrinsic + 3 + loop + tail
    assert want == 21000 + 16 * 254 + 8 + 3 + 240 + 10000 + 44200 + 1320
    tx = PlainTx(1, 5, 0, 0, 400_000, FEE_CAP, 0, data, hash=b"c")
    assert ref.apply_block([tx]) == [(b"c", 1, want)]
    st = ref.storage[0]
    assert all(st[normalize_key(k)] == v for k, v in writes)
    assert len(st) == 5


def test_rewrite_and_out_of_gas():
    """Writing a slot its own value costs the warm read after the cold
    access (2,100 + 100); a call short of gas fails, uses its whole gas
    limit and writes nothing."""
    ref = world()
    k = bytes([0x40]) * 32
    same = [(k, ref.storage[0][k])]
    data = call_data(same)
    intrinsic = chain.intrinsic_gas(data)
    tail = 25 + 1 + 2 + 9 + 15 + 6 + 1262
    ok = PlainTx(1, 5, 0, 0, 100_000, FEE_CAP, 0, data, hash=b"a")
    assert ref.apply_block([ok]) == [
        (b"a", 1, intrinsic + 3 + 60 + 2100 + 100 + tail)]
    new = [(b"\x66" * 32, b"\x07" * 32)]
    short = PlainTx(2, 5, 0, 0, 30_000, FEE_CAP, 0, call_data(new),
                    hash=b"b")
    assert ref.apply_block([short]) == [(b"b", 0, 30_000)]
    assert b"\x66" * 32 not in ref.storage[0]


def test_base_fee_first_blocks():
    """225 gwei at block 1; 10 s later the window has rolled out, so the
    fee falls by 1/36 a block, down to its 25 gwei floor."""
    ref = world()
    fees = []
    for i in range(3):
        ref.apply_block([PlainTx(1, 5 + i, 3, 1, 21000, FEE_CAP, 0, b"",
                                 hash=bytes([i]))])
        fees.append(ref.blocks[-1]["base_fee"])
    f1 = 225 * 10**9
    f2 = f1 - f1 // 36
    assert fees == [f1, f2, f2 - f2 // 36]
    ref.base_fee = 25 * 10**9 + 1
    assert ref.next_base_fee(ref.time + 10)[0] == 25 * 10**9


def test_base_fee_window_holds_recent_gas():
    """2 s after a parent that used 15M gas: the window keeps it, total =
    target, and the fee stays."""
    ref = world()
    ref.number, ref.time, ref.base_fee = 5, 100, 40 * 10**9
    ref.window = [0] * 10
    ref.gas_used = chain.TARGET_GAS
    fee, window = ref.next_base_fee(102)
    assert window[10 - 1 - 2] == chain.TARGET_GAS and sum(window) == \
        chain.TARGET_GAS
    assert fee == 40 * 10**9


def _simple_root(ref):
    """The state root from the reference's own state, by the textbook
    trie."""
    items = []
    for i, a in enumerate(ref.addrs):
        st = ref.storage.get(i, {})
        sroot = simple_trie.root([(keccak256_bytes(normalize_key(k)),
                                   slot_rlp(v)) for k, v in st.items()])
        code = ref.code.get(i)
        ch = keccak256_bytes(code) if code else chain.EMPTY_CODE_HASH
        items.append((keccak256_bytes(a), account_rlp(
            ref.nonce[i], ref.balance[i], sroot, ch)))
    return simple_trie.root(items)


@pytest.mark.parametrize("blocks", [1, 2])
def test_roots_equal_the_textbook_trie(blocks):
    ref = world(n=9, slots=4)
    want = [_simple_root(ref)]
    for b in range(blocks):
        data = call_data([(bytes([0x40 + b]) * 32, b"\x08" * 32),
                          (bytes([0x90 + b]) * 32, b"\x09" * 32)])
        ref.apply_block([
            PlainTx(1, 5 + b, 0, 0, 400_000, FEE_CAP, 0, data, hash=b"x"),
            PlainTx(2, 5 + b, 4 + b, 10**15, 21000, FEE_CAP, 0, b"",
                    hash=b"y")])
        want.append(_simple_root(ref))
    assert ref.roots() == want
    accounts, slots = ref.reads(blocks)
    assert {a for a, _ in accounts} == {ref.addrs[i] for i in
                                         (0, 2, 1, 4 + blocks - 1, 8)}
    assert [len(kv) for _, kv in slots] == [2]
