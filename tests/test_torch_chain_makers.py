"""The port's block generator against the JAX package's on the same signed
transactions, on the CPU: the shape of tests/test_chain_planned_hasher.py.

60 keyed senders over a TEST_CHAIN_CONFIG genesis. Block 1: every sender
deploys a contract whose init code writes storage slots and whose runtime
code stores each 64-byte (key, value) pair of its calldata and emits one
LOG1. Block 2: value transfers to fresh accounts. Block 3: every sender
calls its contract with pairs that overwrite half of its slots and add
as many new ones, so each call logs. The transactions are signed once,
with the reference's signer; each run decodes the bytes anew, so each
recovers its own senders.

The reference's `generate_chain` runs in "off" mode (its recursive CPU
Hasher) and the port's in "off", "batched" (K2's plain version) and
"planned" (K1's plain version) on device="cpu". Block hashes, header
roots, encoded receipts, blooms and gas used must be equal; the planned
run must go through PlannedGraphBuilder.run and the batched run through
the batch-keccak seam; every slot must read back through a fresh
TrieDatabase after the last root's commit. The port's serial
StateProcessor re-executes the blocks to the same receipts and roots. A
`cuda` case runs the planned and batched modes on the card against "off".
"""

import pytest

from coreth_tpu import params as jparams
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.state.statedb import StateDB as JStateDB
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.chain_makers import generate_chain
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Transaction, create_address
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.device import hopper_available
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.ops import keccak_cuda
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.statedb import StateDB
from coreth_tpu_torch.trie import hasher, planned
from coreth_tpu_torch.trie.triedb import TrieDatabase

N_SENDERS = 60
KEYS = [i.to_bytes(1, "big") * 32 for i in range(1, N_SENDERS + 1)]
ADDRS = [priv_to_address(k) for k in KEYS]
CONTRACTS = [create_address(a, 0) for a in ADDRS]
FUND = 10**21
CHAIN_ID = params.TEST_CHAIN_CONFIG.chain_id
SLOTS = 6

# runtime: for each 64-byte (key, value) pair of the calldata SSTORE value
# at key, then LOG1 of the first pair with the caller as topic
STORE_AND_LOG = bytes([
    0x60, 0x00,        # 00 PUSH1 0          i
    0x5B,              # 02 JUMPDEST         loop: [i]
    0x80,              # 03 DUP1
    0x36,              # 04 CALLDATASIZE
    0x11,              # 05 GT               size > i
    0x15,              # 06 ISZERO
    0x60, 0x18,        # 07 PUSH1 0x18
    0x57,              # 09 JUMPI            done -> 0x18
    0x80,              # 0a DUP1
    0x60, 0x20,        # 0b PUSH1 32
    0x01,              # 0d ADD
    0x35,              # 0e CALLDATALOAD     value = cd[i+32]
    0x81,              # 0f DUP2
    0x35,              # 10 CALLDATALOAD     key = cd[i]
    0x55,              # 11 SSTORE
    0x60, 0x40,        # 12 PUSH1 64
    0x01,              # 14 ADD              i += 64
    0x60, 0x02,        # 15 PUSH1 0x02
    0x56,              # 17 JUMP
    0x5B,              # 18 JUMPDEST         done: [i]
    0x33,              # 19 CALLER           topic
    0x60, 0x40,        # 1a PUSH1 64
    0x60, 0x00,        # 1c PUSH1 0
    0x60, 0x00,        # 1e PUSH1 0
    0x37,              # 20 CALLDATACOPY     mem[0:64] = cd[0:64]
    0x60, 0x40,        # 21 PUSH1 64
    0x60, 0x00,        # 23 PUSH1 0
    0xA1,              # 25 LOG1             (0, 64, caller)
    0x00,              # 26 STOP
])


def _slot(j, s):
    return (1000 * j + s).to_bytes(32, "big")


def _value(j, s, round_):
    return (7 * j + 13 * s + round_ + 1).to_bytes(32, "big")


def init_code(j):
    """SSTORE SLOTS slots, then return STORE_AND_LOG as the runtime."""
    code = bytearray()
    for s in range(SLOTS):
        code += b"\x7f" + _value(j, s, 0) + b"\x7f" + _slot(j, s) + b"\x55"
    prefix_len = len(code) + 13
    n = len(STORE_AND_LOG)
    code += bytes([0x60, n, 0x61, prefix_len >> 8, prefix_len & 0xFF,
                   0x60, 0x00, 0x39,               # CODECOPY(0, prefix, n)
                   0x60, n, 0x60, 0x00, 0xF3])     # RETURN(0, n)
    assert len(code) == prefix_len
    return bytes(code) + STORE_AND_LOG


def call_data(j):
    """Half the deployed slots overwritten, as many new ones written."""
    pairs = [(_slot(j, s), _value(j, s, 1)) for s in range(SLOTS // 2)]
    pairs += [(_slot(j, SLOTS + s), _value(j, SLOTS + s, 1))
              for s in range(SLOTS // 2)]
    return b"".join(k + v for k, v in pairs)


def _signed_blocks():
    """The three blocks' transactions, signed with the reference's signer,
    with a fee cap above every base fee of the three blocks."""
    signer = JSigner(CHAIN_ID)
    fee_cap = 10**12

    def tx(i, j, to, data, gas, value=0):
        t = JTransaction(type=2, chain_id=CHAIN_ID, nonce=i, max_fee=fee_cap,
                         max_priority_fee=0, gas=gas, to=to, value=value,
                         data=data)
        return signer.sign(t, KEYS[j]).encode()

    return [
        [tx(0, j, None, init_code(j), 900_000) for j in range(N_SENDERS)],
        [tx(1, j, (0x7000 + j).to_bytes(20, "big"), b"", 21_000, 1000 + j)
         for j in range(N_SENDERS)],
        [tx(2, j, CONTRACTS[j], call_data(j), 300_000)
         for j in range(N_SENDERS)],
    ]


SIGNED = _signed_blocks()


def _run(port, mode="off", device="cpu"):
    """generate_chain over the three blocks; returns (the chain's blocks and
    receipts, the state database, the disk store, the genesis)."""
    if port:
        disk = MemoryDB()
        marker = get_batch_keccak(mode, device)
        db = Database(TrieDatabase(disk, batch_keccak=marker))
        gen_block = Genesis(
            config=params.TEST_CHAIN_CONFIG,
            gas_limit=params.CORTINA_GAS_LIMIT,
            alloc={a: GenesisAccount(balance=FUND) for a in ADDRS},
        ).commit(disk, db)
        cfg, decode, engine, gen_chain = (
            params.TEST_CHAIN_CONFIG, Transaction.decode, new_dummy_engine(),
            generate_chain)
    else:
        disk = JMemoryDB()
        db = JDatabase(JTrieDatabase(disk))
        gen_block = JGenesis(
            config=jparams.TEST_CHAIN_CONFIG,
            gas_limit=jparams.CORTINA_GAS_LIMIT,
            alloc={a: JGenesisAccount(balance=FUND) for a in ADDRS},
        ).commit(disk, db)
        cfg, decode, engine, gen_chain = (
            jparams.TEST_CHAIN_CONFIG, JTransaction.decode,
            j_new_dummy_engine(), j_generate_chain)

    def gen(i, bg):
        for blob in SIGNED[i]:
            bg.add_tx(decode(blob))

    blocks, receipts = gen_chain(cfg, gen_block, engine, db, len(SIGNED),
                                 gen=gen)
    return blocks, receipts, db, disk, gen_block


def _summary(blocks, receipts):
    return [(b.hash(), b.header.root, b.header.receipt_hash, b.header.bloom,
             b.header.gas_used, b.header.tx_hash,
             [r.encode() for r in rs], [r.gas_used for r in rs],
             [r.contract_address for r in rs])
            for b, rs in zip(blocks, receipts)]


_REFERENCE = []


def _reference():
    if not _REFERENCE:
        blocks, receipts, db, _disk, gen_block = _run(port=False)
        _REFERENCE.append((_summary(blocks, receipts), db, gen_block))
    return _REFERENCE[0]


def _check_reads(blocks, disk, ref_db):
    """Persist the last root, then read every touched account and slot
    through a fresh TrieDatabase; equal to the reference's state."""
    root = blocks[-1].header.root
    back = StateDB(root, Database(TrieDatabase(disk)))
    want = JStateDB(root, ref_db)
    for j in range(N_SENDERS):
        for a in (ADDRS[j], CONTRACTS[j], (0x7000 + j).to_bytes(20, "big")):
            assert back.get_balance(a) == want.get_balance(a)
            assert back.get_nonce(a) == want.get_nonce(a)
            assert back.get_code(a) == want.get_code(a)
        for s in range(SLOTS + SLOTS // 2):
            got = back.get_state(CONTRACTS[j], _slot(j, s))
            assert got == want.get_state(CONTRACTS[j], _slot(j, s))
            untouched = SLOTS // 2 <= s < SLOTS
            round_ = 0 if untouched else 1
            assert int.from_bytes(got, "big") == int.from_bytes(
                _value(j, s, round_), "big")
    assert back.get_code(CONTRACTS[0]) == STORE_AND_LOG


@pytest.mark.parametrize("mode", ("off", "batched", "planned"))
def test_generate_chain_matches_reference(mode, monkeypatch):
    ref, ref_db, ref_gen = _reference()
    runs = []
    orig = planned.PlannedGraphBuilder.run

    def counted(self, *a, **kw):
        runs.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(planned.PlannedGraphBuilder, "run", counted)
    batches = hasher.keccak_batches
    blocks, receipts, db, disk, gen_block = _run(port=True, mode=mode)
    assert gen_block.hash() == ref_gen.hash()
    got = _summary(blocks, receipts)
    for b, (g, w) in enumerate(zip(got, ref)):
        assert g == w, f"block {b + 1} differs"
    assert len(got) == len(ref) == 3
    # every transaction succeeded and every call logged once
    assert all(r.status == 1 for rs in receipts for r in rs)
    assert [len(r.logs) for r in receipts[2]] == [1] * N_SENDERS
    assert blocks[2].header.bloom != b"\x00" * 256
    if mode == "planned":
        assert runs, "the planned path was never engaged"
    else:
        assert not runs
    if mode == "batched":
        assert hasher.keccak_batches > batches
    db.triedb.commit(blocks[-1].header.root)
    ref_db.triedb.commit(blocks[-1].header.root)
    _check_reads(blocks, disk, ref_db)


def test_state_processor_replays_the_chain():
    """The serial StateProcessor, the chain's entry, re-executes the
    generated blocks from genesis: the same receipts, gas and roots."""
    from coreth_tpu_torch.core.state_processor import StateProcessor

    ref, _ref_db, _ref_gen = _reference()
    blocks, receipts, db, _disk, gen_block = _run(port=True)
    proc = StateProcessor(params.TEST_CHAIN_CONFIG, None, new_dummy_engine())
    parent = gen_block
    for block, want in zip(blocks, receipts):
        sdb = StateDB(parent.header.root, db)
        got, logs, gas = proc.process(block, parent.header, sdb)
        assert [r.encode() for r in got] == [r.encode() for r in want]
        assert gas == block.header.gas_used
        assert len(logs) == sum(len(r.logs) for r in want)
        assert sdb.commit(True) == block.header.root
        parent = block
    assert blocks[-1].hash() == ref[-1][0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("batched", "planned"))
def test_generate_chain_on_card_equals_off(mode):
    """The planned (K1) and batched (K2) chains on the card give the CPU
    Hasher's blocks, and the mode's kernel launched."""
    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    want = _summary(*_run(port=True, mode="off")[:2])
    keccak_cuda.reset_counts()
    blocks, receipts, *_ = _run(port=True, mode=mode, device=None)
    assert _summary(blocks, receipts) == want
    launched = (keccak_cuda.launches if mode == "planned"
                else keccak_cuda.blocks_launches)
    assert launched > 0
