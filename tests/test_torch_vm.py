"""The port's snowman VM (coreth_tpu_torch/vm/) against the JAX package's
(coreth_tpu/vm/), on the CPU: the cases of tests/test_vm.py run on both
packages with the same genesis, keys, transactions and clock.

Transactions and atomic transactions are built and signed once with the
reference's classes and decoded into the port. A Twin boots one VM of each
package (the port's with device="cpu": its planned marker on the plain
versions) over its own MemoryDB and shared Memory, drives both through
the same snowman calls, and after each step requires equal block bytes and
hashes, statuses, heads and last-accepted blocks, state roots, atomic-trie
roots, shared-memory contents and mempool state. Left out: TestVMSyncServer
(the port has no sync server yet: ROADMAP "Still to port", item 10).
Added: each knob whose part is not ported raises at initialize, naming
its item, and the parts left out raise or stay None.
"""

import json
import threading
import time

import pytest

from coreth_tpu import params as jparams
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.vm import atomic_tx as jatx
from coreth_tpu.vm.mempool import Mempool as JMempool
from coreth_tpu.vm.mempool import MempoolError as JMempoolError
from coreth_tpu.vm.shared_memory import Element as JElement
from coreth_tpu.vm.shared_memory import Memory as JMemory
from coreth_tpu.vm.shared_memory import Requests as JRequests
from coreth_tpu.vm.vm import VM as JVM
from coreth_tpu.vm.vm import SnowContext as JSnowContext
from coreth_tpu.vm.vm import VMConfig as JVMConfig
from coreth_tpu.vm.vm import VMError as JVMError
from coreth_tpu_torch import fault, params
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Transaction
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.ops import device as pdevice
from coreth_tpu_torch.vm import atomic_tx as patx
from coreth_tpu_torch.vm.atomic_backend import AtomicBackendError, \
    AtomicTxRepository
from coreth_tpu_torch.vm.block import BlockStatus
from coreth_tpu_torch.vm.config import Config, parse_config
from coreth_tpu_torch.vm.mempool import Mempool, MempoolError
from coreth_tpu_torch.vm.shared_memory import Element, Memory, Requests
from coreth_tpu_torch.vm.vm import VM, SnowContext, VMConfig, VMError

KEY = b"\x11" * 32
ADDR = priv_to_address(KEY)
DEST = b"\xbb" * 20
X_CHAIN = b"\x58" * 32
C_CHAIN = b"\x02" * 32
AVAX = b"\x41" * 32
FUND = 10**24
PKGS = ("jax", "port")


@pytest.fixture(autouse=True)
def _port_isolation():
    """The port's ladder and failpoints are process-global."""
    yield
    fault.clear_all()
    pdevice.default_ladder().reset()


def signed_transfer(nonce, value=1, tip=10**9):
    """Signed once with the reference's signer: (reference tx, port tx)."""
    t = JTransaction(type=2, chain_id=43112, nonce=nonce, max_fee=10**12,
                     max_priority_fee=tip, gas=21000, to=DEST, value=value)
    jt = JSigner(43112).sign(t, KEY)
    return jt, Transaction.decode(jt.encode())


def make_utxo(amount=10**9, tx_id=b"\x01" * 32, index=0):
    return jatx.UTXO(tx_id=tx_id, output_index=index, asset_id=AVAX,
                     amount=amount, address=ADDR)


def atomic(unsigned, key=KEY):
    """A reference atomic tx signed once: (reference tx, port tx)."""
    tx = jatx.Tx(unsigned)
    tx.sign([key])
    return tx, patx.decode_tx(tx.encode())


def import_tx(utxo, out_amount=4 * 10**9, key=KEY):
    return atomic(jatx.ImportTx(
        network_id=1337, blockchain_id=C_CHAIN, source_chain=X_CHAIN,
        imported_inputs=[utxo],
        outs=[jatx.EVMOutput(address=DEST, amount=out_amount,
                             asset_id=AVAX)]), key)


def memory_contents(mem):
    return {k: {key: (e.value, list(e.traits)) for key, e in ns.items()}
            for k, ns in mem._spaces.items() if ns}


def mempool_state(pool):
    return (len(pool), sorted(pool.txs), sorted(pool.issued),
            sorted(pool.discarded), sorted(pool.utxo_spenders.items()),
            sorted(pool.prices.items()))


class Twin:
    """One VM of each package on the same genesis and clock."""

    def __init__(self, to_engine=False, config_bytes=b""):
        self.mem = {"jax": JMemory(), "port": Memory()}
        self.notes = {"jax": [], "port": []}
        self.vm = {}
        for pkg in PKGS:
            self.vm[pkg] = self._boot(pkg, to_engine, config_bytes)

    def _boot(self, pkg, to_engine, config_bytes):
        jax = pkg == "jax"
        vm = (JVM if jax else VM)()
        ctx = (JSnowContext if jax else SnowContext)(
            chain_id=C_CHAIN, x_chain_id=X_CHAIN, avax_asset_id=AVAX,
            shared_memory=self.mem[pkg])
        gen = (JGenesis if jax else Genesis)(
            config=(jparams if jax else params).TEST_CHAIN_CONFIG,
            gas_limit=params.CORTINA_GAS_LIMIT,
            alloc={ADDR: (JGenesisAccount if jax else GenesisAccount)(
                balance=FUND)})

        def tick():
            return vm.blockchain.current_block.time + 2

        notes = self.notes[pkg]
        kw = dict(to_engine=(lambda: notes.append(1)) if to_engine else None)
        if not jax:
            kw["device"] = "cpu"
        if config_bytes:
            vm.initialize(ctx, (JMemoryDB if jax else MemoryDB)(), gen,
                          config_bytes=config_bytes, **kw)
        else:
            vm.initialize(ctx, (JMemoryDB if jax else MemoryDB)(), gen,
                          (JVMConfig if jax else VMConfig)(clock=tick), **kw)
        return vm

    def do(self, fn):
        """fn(pkg, vm) on both; {pkg: result}."""
        return {pkg: fn(pkg, self.vm[pkg]) for pkg in PKGS}

    def same(self, fn):
        got = self.do(fn)
        assert got["port"] == got["jax"], got
        return got["port"]

    def put_utxo(self, utxo):
        """The X chain exports a UTXO to the C chain, in both memories."""
        for pkg in PKGS:
            mod = (JElement, JRequests) if pkg == "jax" else (Element,
                                                               Requests)
            self.mem[pkg].new_shared_memory(X_CHAIN).apply({C_CHAIN: mod[1](
                put_requests=[mod[0](key=utxo.utxo_id(),
                                     value=utxo.encode(),
                                     traits=[utxo.address])])})

    def issue_tx(self, pair):
        self.do(lambda pkg, vm: vm.issue_tx(pair[PKGS.index(pkg)]))

    def issue_atomic(self, pair):
        self.do(lambda pkg, vm: vm.issue_atomic_tx(pair[PKGS.index(pkg)]))

    def build(self):
        blks = self.do(lambda pkg, vm: vm.build_block())
        assert blks["port"].bytes() == blks["jax"].bytes()
        assert blks["port"].id() == blks["jax"].id()
        return blks

    def check(self):
        """Heads, last accepted, roots, atomic tries, shared memory and
        mempools equal."""
        self.same(lambda pkg, vm: (
            vm.blockchain.current_block.hash(),
            vm.blockchain.current_block.root,
            vm.last_accepted().id(), vm.preferred_block.id(),
            vm.atomic_trie.root_at(), vm.atomic_trie._open_trie.hash(),
            mempool_state(vm.mempool), vm.txpool.stats()))
        assert memory_contents(self.mem["port"]) == \
            memory_contents(self.mem["jax"])

    def lifecycle(self, blks, prefer=True, verify=True):
        for pkg in PKGS:
            b = blks[pkg]
            if verify:
                b.verify()
            if prefer:
                self.vm[pkg].set_preference(b.id())
            b.accept()
            self.vm[pkg].blockchain.drain_acceptor_queue()
        self.check()

    def balance(self, addr):
        return self.same(lambda pkg, vm: vm.blockchain.state().get_balance(
            addr))

    def shutdown(self):
        self.do(lambda pkg, vm: vm.shutdown())


# ------------------------------------------------------- snowman lifecycle


def test_issue_build_verify_accept():
    t = Twin()
    t.do(lambda pkg, vm: setattr(vm, "to_engine",
                                 lambda: t.notes[pkg].append(1)))
    t.issue_tx(signed_transfer(0))
    assert t.notes["port"] == t.notes["jax"] == [1]
    blks = t.build()
    for pkg in PKGS:
        blks[pkg].verify()
    assert blks["port"].status == BlockStatus.PROCESSING
    t.check()
    t.lifecycle(blks, verify=False)
    assert blks["port"].status == BlockStatus.ACCEPTED
    assert blks["jax"].status.name == "ACCEPTED"
    assert t.vm["port"].last_accepted().id() == blks["port"].id()
    assert t.balance(DEST) == 1
    t.shutdown()


def test_parse_block_round_trip():
    t = Twin()
    t.issue_tx(signed_transfer(0))
    blks = t.build()
    for src in PKGS:
        parsed = t.do(lambda pkg, vm: vm.parse_block(blks[src].bytes()))
        assert parsed["port"].id() == parsed["jax"].id() == blks[src].id()
        assert parsed["port"].height() == blks["jax"].height()
    t.shutdown()


def test_empty_build_fails():
    t = Twin()
    with pytest.raises(JVMError):
        t.vm["jax"].build_block()
    with pytest.raises(VMError):
        t.vm["port"].build_block()
    t.check()
    t.shutdown()


def test_reject_and_sibling_accepts():
    t = Twin()
    t.issue_tx(signed_transfer(0))
    blks = t.build()
    for pkg in PKGS:
        blks[pkg].verify()
    jvm = t.vm["jax"]
    sibling, _ = j_generate_chain(
        jvm.chain_config, jvm.blockchain.genesis_block, jvm.engine,
        jvm.state_database, 1, gap=30,
        gen=lambda i, bg: bg.add_tx(signed_transfer(0, value=5)[0]))
    sib = t.do(lambda pkg, vm: vm.parse_block(sibling[0].encode()))
    assert sib["port"].id() == sib["jax"].id() != blks["port"].id()
    for pkg in PKGS:
        sib[pkg].verify()
        sib[pkg].accept()
        blks[pkg].reject()
        t.vm[pkg].blockchain.drain_acceptor_queue()
    assert blks["port"].status == BlockStatus.REJECTED
    t.check()
    assert t.vm["port"].last_accepted().id() == sib["port"].id()
    assert t.balance(DEST) == 5
    t.shutdown()


# ---------------------------------------------------------- atomic txs


def test_import_tx_lifecycle():
    t = Twin()
    utxo = make_utxo(amount=5 * 10**9)
    t.put_utxo(utxo)
    t.issue_atomic(import_tx(utxo))
    assert t.same(lambda pkg, vm: len(vm.mempool)) == 1
    blks = t.build()
    t.lifecycle(blks, prefer=False)
    assert t.balance(DEST) == 4 * 10**9 * jatx.X2C_RATE
    with pytest.raises(KeyError):
        t.vm["port"].shared_memory.get(X_CHAIN, [utxo.utxo_id()])
    t.shutdown()


def test_export_tx_lifecycle():
    t = Twin()
    amt = 3 * 10**9
    out = jatx.UTXO(tx_id=b"\x00" * 32, output_index=0, asset_id=AVAX,
                    amount=amt, address=b"\x99" * 20)
    t.issue_atomic(atomic(jatx.ExportTx(
        network_id=1337, blockchain_id=C_CHAIN, destination_chain=X_CHAIN,
        ins=[jatx.EVMInput(address=ADDR, amount=amt + 10**9, asset_id=AVAX,
                           nonce=0)],
        exported_outputs=[out])))
    t.lifecycle(t.build(), prefer=False)
    assert t.balance(ADDR) == FUND - (amt + 10**9) * jatx.X2C_RATE
    assert t.same(lambda pkg, vm: vm.blockchain.state().get_nonce(ADDR)) == 1
    got = t.mem["port"].new_shared_memory(X_CHAIN).get(C_CHAIN,
                                                       [out.utxo_id()])
    assert patx.UTXO.decode(got[0]).amount == amt
    t.shutdown()


def test_import_missing_utxo_rejected():
    t = Twin()
    pair = import_tx(make_utxo(), out_amount=1)
    for pkg, tx in zip(PKGS, pair):
        with pytest.raises(Exception):
            t.vm[pkg].issue_atomic_tx(tx)
    t.check()
    t.shutdown()


def test_import_wrong_signer_rejected():
    t = Twin()
    utxo = make_utxo()
    t.put_utxo(utxo)
    pair = import_tx(utxo, out_amount=1, key=b"\x99" * 32)
    for pkg, tx in zip(PKGS, pair):
        with pytest.raises(Exception, match="invalid UTXO signature"):
            t.vm[pkg].issue_atomic_tx(tx)
    t.check()
    t.shutdown()


def test_atomic_codec_round_trip():
    jtx, ptx = import_tx(make_utxo(), out_amount=123)
    assert ptx.encode() == jtx.encode() and ptx.id() == jtx.id()
    assert ptx.unsigned_bytes() == jtx.unsigned_bytes()
    assert ptx.unsigned.outs[0].amount == 123
    assert ptx.credential_address(0) == jtx.credential_address(0) == ADDR
    assert jatx.decode_tx(ptx.encode()).id() == jtx.id()
    assert ptx.gas_used(True) == jtx.gas_used(True)
    assert (patx.calculate_dynamic_fee(12345, 25 * 10**9)
            == jatx.calculate_dynamic_fee(12345, 25 * 10**9))
    for batch in (True, False):
        assert (patx.encode_atomic_txs([ptx], batch)
                == jatx.encode_atomic_txs([jtx], batch))
        assert [x.id() for x in patx.extract_atomic_txs(
            jatx.encode_atomic_txs([jtx], batch), batch)] == [jtx.id()]


def test_mempool_conflict_detection():
    utxo = make_utxo()
    pools = {"jax": JMempool(fee_fn=lambda t: 10**9 - t.unsigned.outs[0].amount),
             "port": Mempool(fee_fn=lambda t: 10**9 - t.unsigned.outs[0].amount)}
    errs = {"jax": JMempoolError, "port": MempoolError}
    txs = {amt: import_tx(utxo, out_amount=amt) for amt in (100, 200, 50)}
    for i, pkg in enumerate(PKGS):
        pool = pools[pkg]
        pool.add(txs[100][i])
        with pytest.raises(errs[pkg]):
            pool.add(txs[200][i])
        pool.add(txs[50][i], force=False)
        assert len(pool) == 1
    assert mempool_state(pools["port"]) == mempool_state(pools["jax"])


def test_eth_and_atomic_in_one_block():
    t = Twin()
    utxo = make_utxo(amount=5 * 10**9)
    t.put_utxo(utxo)
    t.issue_atomic(import_tx(utxo))
    t.issue_tx(signed_transfer(0, value=77))
    blks = t.build()
    assert len(blks["port"].eth_block.transactions) == 1
    assert len(blks["port"].atomic_txs) == 1
    t.lifecycle(blks, prefer=False)
    assert t.balance(DEST) == 4 * 10**9 * jatx.X2C_RATE + 77
    t.shutdown()


# -------------------------------------------------------------- config


def test_json_config_round_trip():
    from coreth_tpu.vm.config import parse_config as j_parse_config

    blob = json.dumps({
        "pruning-enabled": False,
        "commit-interval": 8192,
        "state-sync-commit-interval": 16384,
        "device-hasher": "batched",
        "unknown-knob": 42,
    }).encode()
    jcfg, cfg = j_parse_config(blob), parse_config(blob)
    assert cfg.pruning_enabled is False
    assert cfg.commit_interval == 8192
    assert cfg.device_hasher == "batched"
    # the one default the port departs from: it retries no device
    # dispatch (ROADMAP Queue 3)
    assert (cfg.device_max_retries, jcfg.device_max_retries) == (0, 1)
    jcfg.device_max_retries = 0
    assert vars(cfg) == vars(jcfg)


def test_config_validation():
    from coreth_tpu.vm.config import Config as JConfig

    for cls in (JConfig, Config):
        with pytest.raises(ValueError):
            cls(state_sync_commit_interval=1000).validate()
        with pytest.raises(ValueError):
            cls(resident_mesh_devices=3).validate()
        with pytest.raises(ValueError):
            cls(device_promote_after=0).validate()
    with pytest.raises(ValueError, match="Queue 3"):
        Config(device_max_retries=1).validate()


def test_vm_boots_from_config_bytes():
    blob = json.dumps({"commit-interval": 2048,
                       "state-sync-commit-interval": 16384,
                       "insert-pipeline-depth": 2,
                       "device-call-timeout": 1.5,
                       "device-promote-after": 2}).encode()
    t = Twin(config_bytes=blob)
    assert t.same(lambda pkg, vm: (vm.config.commit_interval,
                                   vm.full_config.commit_interval)) == (
        2048, 2048)
    assert t.vm["port"].blockchain.pipeline is not None
    status = pdevice.default_ladder().status()
    assert status["call_timeout"] == 1.5 and status["promote_after"] == 2
    t.check()
    t.shutdown()


@pytest.mark.parametrize("knob,value,item", [
    ("keystore-directory", "/nonexistent/keystore", "item 10"),
    ("keystore-external-signer", "/nonexistent/clef.ipc", "item 10"),
    ("continuous-profiler-dir", "/nonexistent/profiles", "item 10"),
    ("profiler-hz", 100.0, "item 8"),
    ("metrics-http-enabled", True, "item 8"),
    ("lock-slow-hold-budget", 0.5, "item 10"),
    ("rpc-batch-limit", 10, "item 10"),
    ("eth-apis", ["eth", "debug"], "item 10"),
    ("rpc-max-workers", 2, "item 10"),
    ("regossip-frequency", 5.0, "item 10"),
    ("state-sync-enabled", True, "item 10"),
    ("keystore-insecure-unlock-allowed", True, "item 10"),
    ("metrics-http-port", 9100, "item 8"),
    ("accepted-cache-size", 64, "item 10"),
    ("trie-clean-cache", 1024, "item 10"),
])
def test_not_ported_knob_raises(knob, value, item):
    """A knob that no module of the port reads (its part is not ported,
    or neither package reads it) refuses the boot, naming its ROADMAP
    item; nothing is started."""
    before = set(threading.enumerate())
    blob = json.dumps({knob: value}).encode()
    with pytest.raises(NotImplementedError, match=item):
        parse_config(blob)
    gen = Genesis(config=params.TEST_CHAIN_CONFIG,
                  alloc={ADDR: GenesisAccount(balance=FUND)})
    with pytest.raises(NotImplementedError, match=item):
        VM().initialize(SnowContext(shared_memory=Memory()), MemoryDB(), gen,
                        config_bytes=blob, device="cpu")
    assert set(threading.enumerate()) <= before


@pytest.mark.parametrize("knobs", [
    {"resident-account-trie": True, "resident-mesh-devices": 4},
    {"device-hasher": "fused"},
], ids=["mesh", "fused"])
def test_mesh_and_fused_knobs_boot(knobs):
    """The knobs of items 6 and 7, which refused the boot before they
    were ported: the port's VM runs with them (the mesh on four
    positions of its CPU device; the fused marker as the state's seam)
    and builds, verifies and accepts the reference's block."""
    from coreth_tpu_torch.ops.device import FusedModeKeccak

    t = Twin(config_bytes=json.dumps(knobs).encode())
    chain = t.vm["port"].blockchain
    assert t.same(lambda pkg, vm: (vm.full_config.resident_mesh_devices,
                                   vm.full_config.device_hasher)) == (
        knobs.get("resident-mesh-devices", 0),
        knobs.get("device-hasher", "auto"))
    if "resident-mesh-devices" in knobs:
        assert chain.mirror.shards == 4
    else:
        assert isinstance(chain.state_database.triedb.batch_keccak,
                          FusedModeKeccak)
    t.issue_tx(signed_transfer(0))
    t.lifecycle(t.build())
    assert t.balance(DEST) == 1
    t.shutdown()


def test_left_out_parts_raise_or_stay_none():
    t = Twin()
    vm = t.vm["port"]
    assert vm.sync_handler is None and vm.keystore is None
    with pytest.raises(NotImplementedError, match="item 10"):
        vm.handle_cross_chain_request(b"")
    with pytest.raises(NotImplementedError, match="item 10"):
        vm.cross_chain_eth_call(None, X_CHAIN, {})
    t.shutdown()


# ------------------------------------------------------ atomic backend


def test_pending_ancestor_conflict_rejected():
    """Two blocks in one unaccepted chain must not consume the same UTXO:
    the child's insert fails against the pending parent, in both."""
    from coreth_tpu.vm.atomic_backend import \
        AtomicBackendError as JAtomicBackendError

    t = Twin()
    utxo = make_utxo(amount=5 * 10**9)
    t.put_utxo(utxo)
    t.issue_atomic(import_tx(utxo))
    blks = t.build()
    for pkg in PKGS:
        blks[pkg].verify()
    dup = import_tx(utxo)
    states = t.do(lambda pkg, vm: vm.atomic_backend.pending_for(
        blks[pkg].id()))
    assert len(states["port"].consumed) == len(states["jax"].consumed) == 1

    class FakeChild:
        def __init__(self, tx, parent):
            self.atomic_txs = [tx]
            self.eth_block = type("E", (), {"parent_hash": parent.id()})()
            self.parent = parent

        def id(self):
            return b"\xfe" * 32

        def height(self):
            return self.parent.height() + 1

    for pkg, err in (("jax", JAtomicBackendError),
                     ("port", AtomicBackendError)):
        with pytest.raises(err, match="conflicting"):
            t.vm[pkg].atomic_backend.insert_block(
                FakeChild(dup[PKGS.index(pkg)], blks[pkg]))
    for pkg in PKGS:
        blks[pkg].accept()
        t.vm[pkg].blockchain.drain_acceptor_queue()
    t.check()
    rows = t.same(lambda pkg, vm: (
        vm.atomic_backend.pending_for(blks[pkg].id()),
        vm.atomic_backend.repo.tx_ids_at_height(blks[pkg].height()),
        vm.atomic_backend.repo.get_by_id(dup[0].id())))
    assert rows[0] is None and len(rows[1]) == 1
    assert rows[2][0] == blks["port"].height()
    t.shutdown()


def test_reject_releases_pending_utxos():
    t = Twin()
    utxo = make_utxo(amount=5 * 10**9)
    t.put_utxo(utxo)
    t.issue_atomic(import_tx(utxo))
    blks = t.build()
    for pkg in PKGS:
        blks[pkg].verify()
        assert t.vm[pkg].atomic_backend.pending_for(blks[pkg].id())
        blks[pkg].reject()
        assert t.vm[pkg].atomic_backend.pending_for(blks[pkg].id()) is None
    t.check()  # the import went back into both mempools
    t.shutdown()


def test_bonus_block_repair():
    from coreth_tpu.vm.atomic_backend import \
        AtomicTxRepository as JAtomicTxRepository

    pair = import_tx(make_utxo(), out_amount=9 * 10**8)
    repos = {"jax": JAtomicTxRepository(JMemoryDB()),
             "port": AtomicTxRepository(MemoryDB())}
    for i, pkg in enumerate(PKGS):
        repo = repos[pkg]
        b = repo.diskdb.new_batch()
        repo.write(b, 10, [pair[i]])   # canonical
        repo.write(b, 55, [pair[i]])   # bonus duplicate
        b.write()
        assert repo.get_by_id(pair[i].id())[0] == 55
        assert repo.repair_bonus_blocks({55}) == 1
        assert repo.tx_ids_at_height(55) == []
        assert repo.tx_ids_at_height(10) == [pair[i].id()]
        assert repo.get_by_id(pair[i].id())[0] == 10
        assert repo.repair_bonus_blocks({55}) == 0
    assert dict(repos["port"].diskdb.iterate()) == \
        dict(repos["jax"].diskdb.iterate())


# ---------------------------------------------------- builder throttling


def test_single_notification_until_build():
    t = Twin(to_engine=True)
    for n in range(3):
        t.issue_tx(signed_transfer(n))
    assert t.notes["port"] == t.notes["jax"] == [1]
    t.lifecycle(t.build(), prefer=False)
    t.issue_tx(signed_transfer(3))
    assert len(t.notes["port"]) == len(t.notes["jax"]) == 2
    t.shutdown()


def test_retry_timer_renotifies_leftover_work():
    t = Twin(to_engine=True)
    t.do(lambda pkg, vm: setattr(vm.block_builder, "retry_delay", 0.05))
    t.issue_tx(signed_transfer(0))
    t.issue_tx(signed_transfer(1))
    assert len(t.notes["port"]) == len(t.notes["jax"]) == 1
    t.lifecycle(t.build(), prefer=False)
    t.issue_tx(signed_transfer(2))
    deadline = time.time() + 5
    while (min(len(n) for n in t.notes.values()) < 2
           and time.time() < deadline):
        time.sleep(0.02)
    assert len(t.notes["port"]) >= 2 and len(t.notes["jax"]) >= 2
    t.shutdown()


def test_failed_build_reopens_gate():
    t = Twin(to_engine=True)
    for pkg, err in (("jax", JVMError), ("port", VMError)):
        with pytest.raises(err):
            t.vm[pkg].build_block()
    t.issue_tx(signed_transfer(0))
    assert t.notes["port"] == t.notes["jax"] == [1]
    t.shutdown()


def test_shutdown_leaves_no_thread():
    """The threads a VM starts (the build-retry timer, the gas-price
    timers, the chain's acceptor and insert tail, a ladder probe) all end
    with shutdown()."""
    Twin().shutdown()  # process-wide pools start once
    before = set(threading.enumerate())
    t = Twin(to_engine=True)
    t.issue_tx(signed_transfer(0))
    t.lifecycle(t.build(), prefer=False)
    lad = pdevice.default_ladder()
    lad.configure(probe_interval=0.01, promote_after=1)
    lad.demote("drill")  # a probe thread, re-promoting at once
    deadline = time.time() + 5
    while not lad.healthy and time.time() < deadline:
        time.sleep(0.01)
    t.shutdown()
    deadline = time.time() + 5
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.02)
    left = set(threading.enumerate()) - before
    assert not left, sorted(th.name for th in left)
