"""What the tests of the port's execution options share
(tests/test_torch_parallel_exec.py, tests/test_torch_exec_shards.py,
tests/test_torch_insert_pipeline.py): the corpora of the reference's own
tests (tests/test_parallel_exec.py, tests/test_exec_shards.py), built once
by the reference's generate_chain (its serial loop; transactions signed
once with the reference's signer) and decoded into the port, and a
reference chain and a port chain (device="cpu") over the same genesis.

`run` drives a chain through inserts (the pipeline drained), accepts and
the acceptor queue; `signature` reads back what the chain holds for each
block (hash, header root, gas used, receipts RLP, every log's fields) and
its head; `compare_stores` holds the port's store against the
reference's after stop(), as tests/test_torch_blockchain.py does (the
reference's dirty storage tries flushed with cap(0), the trie nodes its
snapshot generation deleted left out: ROADMAP Queue 3).
"""

from coreth_tpu import params as jparams
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core.blockchain import BlockChain as JBlockChain
from coreth_tpu.core.blockchain import CacheConfig as JCacheConfig
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.trie.triedb import TrieDatabase

CHAIN_ID = 43112
SIGNER = JSigner(CHAIN_ID)
KEYS = [bytes([i + 1]) * 32 for i in range(24)]
ADDRS = [priv_to_address(k) for k in KEYS]
FUND = 10**21

# sstore(calldata[0], calldata[32]); sstore(0, sload(0)+1); stop —
# every call bumps slot 0, so concurrent calls to the same contract
# conflict on it no matter which slot calldata targets
RUNTIME = bytes.fromhex("6000356020359055600054600101600055") + b"\x00"
# constructor returning RUNTIME
INIT = bytes.fromhex("6012600c60003960126000f3") + RUNTIME
# CALLER SELFDESTRUCT — first call kills the contract
SD_CODE = b"\x33\xff"
# COINBASE BALANCE POP STOP — reads the fee recipient
CB_CODE = bytes.fromhex("41315000")

COUNTER_ADDR = b"\xc0" * 19 + b"\x01"
SD_ADDR = b"\xdd" * 19 + b"\x01"
CB_ADDR = b"\xcb" * 19 + b"\x01"
EXTRA = {COUNTER_ADDR: (0, RUNTIME), SD_ADDR: (7, SD_CODE),
         CB_ADDR: (0, CB_CODE)}


def base_fee(bg):
    return bg.base_fee() or jparams.APRICOT_PHASE3_INITIAL_BASE_FEE


def transfer(bg, key, nonce, to, value=1, data=b"", gas=21000):
    tx = JTransaction(
        type=2, chain_id=CHAIN_ID, nonce=nonce, max_fee=base_fee(bg) * 2,
        max_priority_fee=0, gas=gas, to=to, value=value, data=data)
    bg.add_tx(SIGNER.sign(tx, key))


def create(bg, key, nonce, data, gas=200_000):
    tx = JTransaction(
        type=2, chain_id=CHAIN_ID, nonce=nonce, max_fee=base_fee(bg) * 2,
        max_priority_fee=0, gas=gas, to=None, value=0, data=data)
    bg.add_tx(SIGNER.sign(tx, key))


def _alloc(account):
    alloc = {a: account(balance=FUND) for a in ADDRS}
    for a, (bal, code) in EXTRA.items():
        alloc[a] = account(balance=bal, code=code)
    return alloc


def ref_chain(**knobs):
    """The reference's chain over the corpus genesis (the keyed senders
    and the three contracts), its CPU hasher."""
    disk = JMemoryDB()
    return JBlockChain(
        disk, JCacheConfig(pruning=True, **knobs), jparams.TEST_CHAIN_CONFIG,
        JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                 gas_limit=jparams.CORTINA_GAS_LIMIT,
                 alloc=_alloc(JGenesisAccount)),
        j_new_dummy_engine(), state_database=JDatabase(JTrieDatabase(disk)))


def port_chain(batch_keccak=None, **knobs):
    """The port's chain over the corpus genesis on the CPU (the CPU
    hasher, or `batch_keccak`'s device seam with the plain versions)."""
    disk = MemoryDB()
    return BlockChain(
        disk, CacheConfig(pruning=True, **knobs), params.TEST_CHAIN_CONFIG,
        Genesis(config=params.TEST_CHAIN_CONFIG,
                gas_limit=params.CORTINA_GAS_LIMIT,
                alloc=_alloc(GenesisAccount)),
        new_dummy_engine(),
        state_database=Database(TrieDatabase(disk,
                                             batch_keccak=batch_keccak)),
        device="cpu")


def make_blocks(n, gen):
    """n blocks of `gen` from the corpus genesis, built by the reference's
    generate_chain: the serial loop stamps the headers."""
    scratch = ref_chain()
    blocks, _ = j_generate_chain(
        scratch.config, scratch.genesis_block, scratch.engine,
        scratch.state_database, n, gen=gen)
    scratch.stop()
    return blocks


def is_port(chain) -> bool:
    return isinstance(chain, BlockChain)


def decoded(chain, blocks):
    return ([Block.decode(b.encode()) for b in blocks] if is_port(chain)
            else blocks)


def run(chain, blocks, accept=True):
    """Insert every block (the pipeline drained), then accept them all and
    drain the acceptor queue."""
    blocks = decoded(chain, blocks)
    for b in blocks:
        chain.insert_block(b)
    if getattr(chain, "pipeline", None) is not None:
        chain.pipeline.drain()
    if accept:
        for b in blocks:
            chain.accept(b)
        chain.drain_acceptor_queue()
        assert chain.acceptor_error is None, chain.acceptor_error
    return chain


_LOG_FIELDS = ("address", "topics", "data", "block_number", "block_hash",
               "tx_hash", "tx_index", "index")


def signature(chain, blocks):
    """Per block: number, hash, header root, gas used, receipts RLP and
    every log's fields; then the head's hash."""
    chain.join_tail()
    sig = []
    for b in blocks:
        h = b.hash()
        got = chain.get_block(h)
        assert got is not None, b.number
        receipts = chain.get_receipts(h)
        sig.append((got.number, h, got.header.root, got.header.gas_used,
                    [r.encode() for r in receipts],
                    [tuple(getattr(lg, f) for f in _LOG_FIELDS)
                     for r in receipts for lg in r.logs]))
    return sig, chain.current_block.hash()


def records(chain, blocks):
    return [chain.flight_recorder.find(b.hash()) for b in blocks]


def compare_stores(ref, port):
    """Both chains stopped: the port's store within the reference's."""
    ref.stop()
    port.stop()
    ref.state_database.triedb.cap(0)
    want = dict(ref.diskdb.iterate())
    got = dict(port.diskdb.iterate())
    assert got
    for k, v in got.items():
        if k not in want:
            # a trie node the reference's snapshot generation deleted
            assert len(k) == 32 and k[:1] in (b"a", b"o"), k
            assert keccak256(v) == k
        else:
            assert want[k] == v, k


# ------------------------------------------------------------- corpora


def _disjoint(i, bg):
    """Twelve conflict-free transfers a block."""
    for j, key in enumerate(KEYS[:12]):
        transfer(bg, key, i, (0x9000 + 12 * i + j).to_bytes(20, "big"))


def _conflict(i, bg):
    """tests/test_parallel_exec.py's conflict shapes: four senders hit the
    same contract slot (twice each), one selfdestructs a contract and
    another re-funds the corpse, one deploys fresh code, the rest
    transfer."""
    for j, key in enumerate(KEYS[:4]):
        data = (j % 2).to_bytes(32, "big") + (j + 100).to_bytes(32, "big")
        transfer(bg, key, i * 2, COUNTER_ADDR, 0, data, gas=100_000)
    for j, key in enumerate(KEYS[:4]):
        data = (j % 2).to_bytes(32, "big") + (j + 200).to_bytes(32, "big")
        transfer(bg, key, i * 2 + 1, COUNTER_ADDR, 0, data, gas=100_000)
    if i == 0:
        transfer(bg, KEYS[4], 0, SD_ADDR, 0, gas=60_000)
        transfer(bg, KEYS[5], 0, SD_ADDR, 12345)
        create(bg, KEYS[6], 0, INIT)
    for j, key in enumerate(KEYS[8:20]):
        transfer(bg, key, i, (0xA000 + 12 * i + j).to_bytes(20, "big"))


def _oog_conflict(i, bg):
    """tests/test_exec_shards.py's conflict corpus: shared-slot calls, one
    call out of gas mid-sstore (a status-0 receipt), disjoint transfers."""
    for j, key in enumerate(KEYS[:4]):
        data = (j % 2).to_bytes(32, "big") + (j + 100).to_bytes(32, "big")
        transfer(bg, key, i * 2, COUNTER_ADDR, 0, data, gas=100_000)
        transfer(bg, key, i * 2 + 1, COUNTER_ADDR, 0, data, gas=100_000)
    transfer(bg, KEYS[4], i, COUNTER_ADDR, 0, b"\x00" * 64, gas=24_000)
    for j, key in enumerate(KEYS[5:10]):
        transfer(bg, key, i, (0xA000 + 8 * i + j).to_bytes(20, "big"))


def _all_conflict(i, bg):
    """Eight sequential txs from ONE sender: every tx reads the previous
    one's nonce/balance write."""
    for j in range(8):
        transfer(bg, KEYS[0], j, (0xB000 + j).to_bytes(20, "big"))


def _coinbase_read(i, bg):
    """Transfers and one call that reads the fee recipient's balance."""
    for j, key in enumerate(KEYS[:6]):
        transfer(bg, key, i, (0xD000 + 6 * i + j).to_bytes(20, "big"))
    transfer(bg, KEYS[6], i, CB_ADDR, 0, gas=60_000)


def _fuzz(seed, n_senders=6, per_block=12):
    """Transfers whose recipients are drawn from the sender set: balance
    chains criss-cross tx indices (tests/test_parallel_exec.py)."""
    import random

    rng = random.Random(seed)
    nonces = {j: 0 for j in range(n_senders)}

    def gen(i, bg):
        for _ in range(per_block):
            s = rng.randrange(n_senders)
            t = rng.randrange(len(ADDRS))
            transfer(bg, KEYS[s], nonces[s], ADDRS[t],
                     value=rng.randrange(1, 1000))
            nonces[s] += 1

    return gen


def _cross_block(seed=None):
    """tests/test_insert_pipeline.py's conflict corpus: four senders whose
    nonce chains span every block, paying each other, so block k+1 reads
    what block k wrote; `seed` adds its fuzz (random tx counts, senders,
    recipients and values)."""
    import random

    rng = random.Random(seed) if seed is not None else None
    nonces = {s: 0 for s in range(4)}
    dest = [b"\xbb" * 20, b"\xcc" * 20]

    def gen(i, bg):
        if rng is None:
            for s in range(4):
                transfer(bg, KEYS[s], nonces[s], ADDRS[(s + i + 1) % 4],
                         value=1000 + i)
                nonces[s] += 1
            return
        for _ in range(rng.randrange(1, 7)):
            s = rng.randrange(4)
            transfer(bg, KEYS[s], nonces[s], rng.choice(ADDRS[:4] + dest),
                     value=rng.randrange(1, 10**6))
            nonces[s] += 1

    return gen


_CORPORA = {
    "disjoint": (2, lambda: _disjoint),
    "disjoint4": (4, lambda: _disjoint),
    "conflict": (2, lambda: _conflict),
    "oog": (2, lambda: _oog_conflict),
    "all_conflict": (1, lambda: _all_conflict),
    "coinbase": (1, lambda: _coinbase_read),
    "fuzz1": (3, lambda: _fuzz(1)),
    "fuzz7": (3, lambda: _fuzz(7)),
    "fuzz3": (2, lambda: _fuzz(3, n_senders=10, per_block=10)),
    "cross": (6, _cross_block),
    "cross1234": (5, lambda: _cross_block(1234)),
    "cross99": (5, lambda: _cross_block(99)),
}
_BUILT = {}


def corpus(name):
    """The named corpus's blocks, built once per process."""
    if name not in _BUILT:
        n, gen = _CORPORA[name]
        _BUILT[name] = make_blocks(n, gen())
    return _BUILT[name]
