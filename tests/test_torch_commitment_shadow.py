"""The port's dual-root shadow (coreth_tpu_torch/bintrie/shadow.py) against
the JAX package's, on the CPU.

(a) ShadowCommitment on the same update streams in both packages: the
same roots, statuses and quarantine reasons, including injected replay,
advance and rebuild divergences, and a bulk stream that takes the planned
commit (the port's on device="cpu", K1's plain version; the reference's
on its executor with the host Keccak-f, tests/torch_jax_planned.py).
(b) A BlockChain with state_backend "bintrie-shadow" in each package over
the same genesis and the same blocks (built once by the reference's
generate_chain, decoded into the port): the same MPT roots and the same
root_for of every block. (c) The knobs boot: parse_config and BlockChain
take them. (d) The port's device rule: an error of the shadow's planned
commit (KernelLaunchError, DeviceWedgedError at the ladder's watchdog)
reaches insert_block with the head unchanged and no quarantine, and the
retried insert lands with the reference's shadow root; after
take_over_host the shadow commits on the host with the same root.
Everything is compared exactly."""

import threading

import pytest

from coreth_tpu import params as jparams
from coreth_tpu.bintrie import shadow as jshadow
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
from coreth_tpu_torch import fault, params
from coreth_tpu_torch.bintrie import shadow
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.device import DeviceWedgedError, KernelLaunchError
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.metrics import default_registry
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.ops import device as pdevice
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.trie.triedb import TrieDatabase
from coreth_tpu_torch.vm.config import parse_config
from torch_jax_planned import patch_default

CHAIN_ID = 43112
N_SENDERS = 32
KEYS = [bytes([i]) * 32 for i in range(1, N_SENDERS + 1)]
ADDRS = [priv_to_address(k) for k in KEYS]
FUND = 10**21
EMPTY_CODE_HASH = keccak256(b"")
A, B, C, D = (bytes([c]) * 32 for c in b"\xaa\xbb\xcc\xdd")


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    patch_default(monkeypatch)
    yield
    fault.clear_all()
    pdevice.default_ladder().reset()


def _q():
    return default_registry.counter("chain/commit/bintrie/quarantines"
                                    ).count()


# ------------------------------------------------ (a) the same streams


def _acct(ah, nonce=1, balance=100):
    return ("account", ah, (nonce, balance, EMPTY_CODE_HASH, False))


AH = keccak256(b"acct-1")
SLOT = keccak256(b"slot")


def _bulk(n, round_):
    """n accounts with two slots each; later rounds rewrite, zero and
    destruct some (>= PLANNED_MIN_UPDATES updates: the planned commit)."""
    ups = []
    for i in range(n):
        ah = keccak256(b"bulk" + i.to_bytes(4, "big"))
        if round_ and i % 7 == 0:
            ups.append(("destruct", ah))
            continue
        ups.append(_acct(ah, nonce=round_ + 1, balance=i * 3 + round_))
        ups.append(("storage", ah, keccak256(b"s0"),
                    (round_ + 1).to_bytes(32, "big")))
        ups.append(("storage", ah, keccak256(b"s1"),
                    b"\x00" * 32 if round_ and i % 3 == 0
                    else (i + 1).to_bytes(32, "big")))
    return ups


# each scenario: a list of (parent, new, updates, block_hash) commits and
# the ShadowCommitment's keyword arguments; "corrupt" between commits
# injects a wrong content entry (the rebuild check's divergence)
SCENARIOS = {
    "tracking": ([(A, B, [_acct(AH)]), (B, C, [_acct(AH, nonce=2)])], {}),
    "replay": ([(A, B, [_acct(AH)]), (A, B, [_acct(AH)])], {}),
    "replay-divergence": ([(A, B, [_acct(AH, balance=100)]),
                           (A, B, [_acct(AH, balance=999)], b"\x11" * 32),
                           (B, C, [_acct(AH)])], {}),
    "advance-divergence": ([(A, B, [_acct(AH)]), (B, C, [_acct(AH)])], {}),
    "rebuild-divergence": ([(A, B, [_acct(AH)]), "corrupt",
                            (B, C, [_acct(AH, nonce=2)])],
                           {"check_interval": 2}),
    "unanchored": ([(A, B, [_acct(AH)]), (b"\xee" * 32, b"\xef" * 32,
                                          [_acct(AH)]),
                    (B, C, [_acct(AH, nonce=2)])], {}),
    "internal-error": ([(A, B, [("warp-drive", b"x")])], {}),
    "destruct": ([(A, B, [_acct(AH), ("storage", AH, SLOT, b"\x07" * 32)]),
                  (B, C, [("destruct", AH)])], {}),
    "storage-zero": ([(A, B, [_acct(AH), ("storage", AH, SLOT,
                                          b"\x01" + b"\x00" * 31)]),
                      (B, C, [("storage", AH, SLOT, b"\x00" * 32)])], {}),
    "rebuild-honest": ([(A, B, [_acct(AH, 1, 50)]),
                        (B, C, [_acct(AH, 2, 100)]),
                        (C, D, [_acct(AH, 3, 150)])], {"check_interval": 1}),
    "bulk-planned": ([(A, B, _bulk(24, 0)), (B, C, _bulk(24, 1)),
                      (C, D, _bulk(24, 2))], {"check_interval": 3}),
    "bulk-reorg": ([(A, B, _bulk(24, 0)), (B, C, _bulk(24, 1)),
                    (B, D, _bulk(24, 2))], {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_shadow_streams_match_reference(name):
    commits, kw = SCENARIOS[name]
    events = {"jax": [], "port": []}
    j = jshadow.ShadowCommitment(
        note_event=lambda k, **f: events["jax"].append((k, f)), **kw)
    p = shadow.ShadowCommitment(
        note_event=lambda k, **f: events["port"].append((k, f)),
        device="cpu", **kw)
    lanes = default_registry.counter("bintrie/planned/lanes").count()
    for c in commits:
        if c == "corrupt":
            for s in (j, p):
                s._content[b"\x42" * 32] = b"\x00" * 32
            continue
        parent, new, ups, *bh = c
        got = p.on_commit(parent, new, ups, *bh)
        assert got == j.on_commit(parent, new, ups, *bh)
        assert p.status() == j.status()
        assert p.roots == j.roots
    assert p.store.nodes == j.store.nodes
    assert events["port"] == events["jax"]
    planned = default_registry.counter("bintrie/planned/lanes").count()
    assert (planned > lanes) == name.startswith("bulk")
    if "divergence" in name:
        assert p.quarantined and name.split("-")[0] in p.quarantine_reason
    else:
        assert p.quarantined == (name == "internal-error")


# --------------------------------------------------- (b) the two chains


def _sign(nonce, key, to, value, base_fee):
    tx = JTransaction(type=2, chain_id=CHAIN_ID, nonce=nonce,
                      max_fee=base_fee * 2, max_priority_fee=0, gas=21000,
                      to=to, value=value)
    return JSigner(CHAIN_ID).sign(tx, key)


class Pair:
    """Blocks made once on a genesis state of their own (the reference's
    generate_chain); a reference and a port chain in shadow mode, both
    fed them."""

    def __init__(self, n_blocks=2, check_interval=2, port_knobs=None,
                 port_mode="planned"):
        alloc = {a: FUND for a in ADDRS}
        jdisk = JMemoryDB()
        maker = JDatabase(JTrieDatabase(jdisk))
        genesis = self._jgenesis(alloc).commit(jdisk, maker)

        def gen(i, bg):
            for s, key in enumerate(KEYS):
                bg.add_tx(_sign(i, key, bytes([0x80 + i, s]) * 10,
                                1000 + s, bg.base_fee() or 225 * 10**9))

        self.blocks, _ = j_generate_chain(
            jparams.TEST_CHAIN_CONFIG, genesis, j_new_dummy_engine(), maker,
            n_blocks, gap=10, gen=gen)
        rdisk = JMemoryDB()
        self.ref = JBlockChain(
            rdisk, JCacheConfig(pruning=True, state_backend="bintrie-shadow",
                                shadow_check_interval=check_interval),
            jparams.TEST_CHAIN_CONFIG, self._jgenesis(alloc),
            j_new_dummy_engine(),
            state_database=JDatabase(JTrieDatabase(rdisk)))
        pdisk = MemoryDB()
        self.port = BlockChain(
            pdisk, CacheConfig(pruning=True, state_backend="bintrie-shadow",
                               shadow_check_interval=check_interval,
                               **(port_knobs or {})),
            params.TEST_CHAIN_CONFIG,
            Genesis(config=params.TEST_CHAIN_CONFIG,
                    gas_limit=params.CORTINA_GAS_LIMIT,
                    alloc={a: GenesisAccount(balance=b)
                           for a, b in alloc.items()}),
            new_dummy_engine(), state_database=Database(TrieDatabase(
                pdisk, batch_keccak=get_batch_keccak(port_mode, "cpu"))),
            device="cpu")
        self.pshadow = self.port.state_database.shadow
        self.jshadow = self.ref.state_database.shadow
        assert self.port.genesis_block.hash() == genesis.hash()

    @staticmethod
    def _jgenesis(alloc):
        return JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                        gas_limit=jparams.CORTINA_GAS_LIMIT,
                        alloc={a: JGenesisAccount(balance=b)
                               for a, b in alloc.items()})

    def insert(self, i):
        b = self.blocks[i]
        self.ref.insert_block(b)
        self.port.insert_block(Block.decode(b.encode()))

    def same(self):
        for b in [self.ref.genesis_block] + self.blocks:
            assert self.pshadow.root_for(b.root) == \
                self.jshadow.root_for(b.root)
        assert self.pshadow.status() == self.jshadow.status()
        assert not self.pshadow.quarantined

    def stop(self):
        self.ref.stop()
        self.port.stop()


def test_shadow_chains_match_reference():
    q = _q()
    commits = default_registry.counter("bintrie/planned/commits").count()
    mpt = default_registry.timer("chain/commit/mpt").count()
    bint = default_registry.timer("chain/commit/bintrie").count()
    pair = Pair()
    for i in range(len(pair.blocks)):
        pair.insert(i)
        assert pair.port.current_block.root == pair.ref.current_block.root
        pair.same()
    for b in pair.blocks:
        assert pair.pshadow.root_for(b.root) is not None
    st = pair.pshadow.status()
    assert st["commits"] == 1 + len(pair.blocks) and not st["quarantined"]
    # the genesis (32 accounts) hashed on the host, every block (65
    # account updates) took the planned commit; both timers ran once a
    # commit
    assert default_registry.counter("bintrie/planned/commits").count() \
        == commits + len(pair.blocks)
    assert default_registry.timer("chain/commit/mpt").count() - mpt == \
        default_registry.timer("chain/commit/bintrie").count() - bint \
        == 1 + len(pair.blocks)
    assert _q() == q
    pair.stop()


# -------------------------------------------------------- (c) the knobs


def test_shadow_knobs_are_not_refused():
    cfg = parse_config(b'{"state-backend": "bintrie-shadow", '
                       b'"shadow-check-interval": 2}')
    assert (cfg.state_backend, cfg.shadow_check_interval) == \
        ("bintrie-shadow", 2)
    with pytest.raises(ValueError, match="state-backend"):
        parse_config(b'{"state-backend": "verkle"}')
    with pytest.raises(ValueError, match="unknown state-backend"):
        BlockChain(MemoryDB(), CacheConfig(state_backend="verkle"),
                   params.TEST_CHAIN_CONFIG,
                   Genesis(config=params.TEST_CHAIN_CONFIG),
                   new_dummy_engine(), device="cpu")


# --------------------------------------------- (d) the port's device rule


@pytest.mark.parametrize("fault_kind", ["launch", "wedge"])
def test_device_error_in_shadow_commit_reaches_insert_block(fault_kind):
    """The shadow's planned commit fails on block 1 (the port's chain
    hashes its MPT with the CPU Hasher, so the shadow's is the only
    laddered dispatch): the error reaches insert_block as it is, the head
    stays, the shadow neither quarantines nor moves; the retry lands with
    the reference's shadow root."""
    pair = Pair(n_blocks=2, port_mode="off")
    lad = pdevice.default_ladder()
    pair.insert(0)
    ex = pair.pshadow.executor
    real = ex.run
    release = threading.Event()

    def failing(*a, **kw):
        if fault_kind == "launch":
            raise KernelLaunchError("segment_keccak: launch failed")
        release.wait(10)
        return real(*a, **kw)

    if fault_kind == "wedge":
        lad.configure(call_timeout=0.3)
    ex.run = failing
    head = pair.port.current_block.hash()
    status = pair.pshadow.status()
    q = _q()
    b1 = Block.decode(pair.blocks[1].encode())
    want = KernelLaunchError if fault_kind == "launch" else DeviceWedgedError
    with pytest.raises(want):
        pair.port.insert_block(b1)
    assert pair.port.current_block.hash() == head
    assert pair.pshadow.status() == status and _q() == q
    assert pair.pshadow.root_for(b1.root) is None
    assert lad.healthy
    ex.run = real
    release.set()
    pair.ref.insert_block(pair.blocks[1])
    pair.port.insert_block(b1)
    assert pair.port.current_block.hash() == b1.hash()
    pair.same()
    pair.stop()


def test_take_over_host_commits_the_shadow_on_the_host():
    """A resident port chain whose caller takes the device over: the
    ladder is demoted, so the shadow's commits of 64 updates or more hash
    on the host (no planned run), with the reference's roots."""
    pair = Pair(n_blocks=2, port_knobs={"resident_account_trie": True})
    pair.insert(0)
    commits = default_registry.counter("bintrie/planned/commits").count()
    pair.port.take_over_host("test")
    assert not pdevice.default_ladder().healthy
    pair.insert(1)
    assert default_registry.counter("bintrie/planned/commits").count() == \
        commits
    pair.same()
    pair.stop()
