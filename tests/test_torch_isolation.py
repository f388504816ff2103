"""The port stands alone: it imports neither jax/jaxlib nor anything of
coreth_tpu, nor the cryptography package (which the machine with the card
does not have), and without CUDA its entry points raise instead of
drifting to the CPU."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from coreth_tpu_torch import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "coreth_tpu", "cryptography")

_CHILD = r'''
import sys

FORBIDDEN = ("jax", "jaxlib", "coreth_tpu", "cryptography")


def refused(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(f"the port must not import {name}")
        return None


loaded = [m for m in sys.modules if refused(m)]
assert not loaded, f"already imported before the port: {loaded}"
sys.meta_path.insert(0, Refuse())

import random

import coreth_tpu_torch
from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, PlannedMode
from coreth_tpu_torch.state.account import Account
from coreth_tpu_torch.state.statedb import planned_intermediate_root
from coreth_tpu_torch.trie.hasher import Hasher
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.secure import StateTrie
from coreth_tpu_torch.trie.trie import trie_from_items
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch import rlp

rng = random.Random(3)
commit = PlannedCommit(device="cpu")
mode = PlannedMode(commit)
acct_trie = StateTrie(batch_keccak=mode)
changed, oracle = {}, []
for i in range(150):
    addr = rng.randbytes(20)
    st, root = None, EMPTY_ROOT
    if i < 3:
        st = StateTrie(batch_keccak=mode)
        slots = [(rng.randbytes(32), rlp.encode(rng.randbytes(20)))
                 for _ in range(30)]
        for k, v in slots:
            st.update(k, v)
        t = trie_from_items((keccak256(k), v) for k, v in slots)
        root = bytes(Hasher().hash(t.root, True)[0])
    a = Account(nonce=i, balance=10**18 + i)
    changed[addr] = (a, st)
    oracle.append((keccak256(addr),
                   Account(nonce=i, balance=10**18 + i, root=root).encode()))
got = planned_intermediate_root(acct_trie, changed, planned=commit)
want = bytes(Hasher().hash(trie_from_items(oracle).root, True)[0])
assert got == want, (got.hex(), want.hex())
assert commit.last_dispatches == 1

# the same state through the level-batched ("batched") mode
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.state.statedb import intermediate_root
from coreth_tpu_torch.trie import hasher

bmode = get_batch_keccak("batched", device="cpu")
rng = random.Random(3)
acct_trie = StateTrie(batch_keccak=bmode)
changed = {}
for i in range(150):
    addr = rng.randbytes(20)
    st = None
    if i < 3:
        st = StateTrie(batch_keccak=bmode)
        for k, v in [(rng.randbytes(32), rlp.encode(rng.randbytes(20)))
                     for _ in range(30)]:
            st.update(k, v)
    changed[addr] = (Account(nonce=i, balance=10**18 + i), st)
before = hasher.keccak_batches
got = intermediate_root(acct_trie, changed, batch_keccak=bmode, device="cpu")
assert got == want, (got.hex(), want.hex())
assert hasher.keccak_batches > before and bmode.batched.launches > 0

# the native incremental trie: one resident commit and one commit_device
from coreth_tpu_torch.native.mpt import IncrementalTrie, plan_from_items
from coreth_tpu_torch.ops.keccak_resident import ResidentExecutor

items = [(rng.randbytes(32), rng.randbytes(rng.randint(1, 90)))
         for _ in range(300)]
want = plan_from_items(items).execute_cpu()
res = IncrementalTrie(items)
res.set_lean(True)
ex = ResidentExecutor(device="cpu")
assert ex.root_bytes(res.commit_resident(ex)) == want
host = IncrementalTrie(items)
assert host.commit_device(device="cpu") == want == host.commit_cpu()

# the state layer: a genesis and one block through StateDB on each marker,
# persisted, then read back through a fresh TrieDatabase
from coreth_tpu_torch import params
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.statedb import StateDB
from coreth_tpu_torch.trie.triedb import TrieDatabase

alloc = {rng.randbytes(20): GenesisAccount(
    balance=10**18 + i, nonce=i, code=b"\x60\x00" if i < 3 else b"",
    storage={rng.randbytes(32): rng.randbytes(32) for _ in range(4 * (i < 3))})
    for i in range(120)}
roots = set()
for mode in ("off", "batched", "planned"):
    disk = MemoryDB()
    tdb = TrieDatabase(disk, batch_keccak=get_batch_keccak(mode, device="cpu"))
    block = Genesis(config=params.TEST_CHAIN_CONFIG, alloc=alloc).commit(
        disk, Database(tdb))
    sdb = StateDB(block.root, Database(tdb))
    for i, addr in enumerate(alloc):
        sdb.add_balance(addr, i + 1)
        sdb.set_state(addr, b"\x02" * 32, b"\x03" * 32)
    root = sdb.commit(True)
    tdb.commit(root)
    back = StateDB(root, Database(TrieDatabase(disk)))
    for i, (addr, acct) in enumerate(alloc.items()):
        assert back.get_balance(addr) == acct.balance + i + 1
        assert back.get_state(addr, b"\x02" * 32) == b"\x03" * 32
        for k, v in acct.storage.items():
            assert back.get_state(addr, k) == v
    roots.add((block.hash(), root))
assert len(roots) == 1, roots

# the resident mirror inside StateDB: booted from the persisted genesis by
# one leaf scan, one block committed on it and accepted through its trie
# writer (interval export), then read back through a fresh TrieDatabase
from coreth_tpu_torch.core import rawdb
from coreth_tpu_torch.core.state_manager import ResidentTrieWriter
from coreth_tpu_torch.trie.iterator import iterate_leaves
from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror

disk = MemoryDB()
tdb = TrieDatabase(disk)
block = Genesis(config=params.TEST_CHAIN_CONFIG, alloc=alloc).commit(
    disk, Database(tdb))
mirror = ResidentAccountMirror(
    list(iterate_leaves(tdb.open_trie(block.root))), device="cpu",
    pipeline_depth=2)
db = Database(tdb)
db.mirror = mirror
sdb = StateDB(block.root, db)
assert sdb.trie.resident
for i, addr in enumerate(alloc):
    sdb.add_balance(addr, i + 1)
    sdb.set_state(addr, b"\x02" * 32, b"\x03" * 32)
root = sdb.commit(True, block_hash=b"\x01" * 32,
                  parent_block_hash=block.hash())
assert roots == {(block.hash(), root)}, roots


class Blk:
    number = 1
    root = root

    def hash(self):
        return b"\x01" * 32


writer = ResidentTrieWriter(tdb, mirror, commit_interval=1)
writer.insert_trie(Blk())
writer.accept_trie(Blk())
writer.shutdown()
assert mirror.spot_check() and not mirror.host_mode
back = StateDB(root, Database(TrieDatabase(disk)))
for i, (addr, acct) in enumerate(alloc.items()):
    assert back.get_balance(addr) == acct.balance + i + 1
    assert back.get_state(addr, b"\x02" * 32) == b"\x03" * 32
assert rawdb.inspect_database(disk)["trieNodes"]["count"] > 0

# signed transactions through the EVM and the block generator: two blocks
# (transfers, then transfers and one contract call that stores and logs)
# in planned mode, the header roots hashed by the planned program
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.chain_makers import generate_chain
from coreth_tpu_torch.core.types import Signer, Transaction
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.trie import planned

keys = [bytes([i + 1]) * 32 for i in range(60)]
senders = [priv_to_address(k) for k in keys]
contract = b"\xcc" * 20
# PUSH1 0 CALLDATALOAD PUSH1 0 SSTORE PUSH1 0 PUSH1 0 LOG0 STOP
code = bytes.fromhex("60003560005560006000a000")
cfg = params.TEST_CHAIN_CONFIG
chain_alloc = {a: GenesisAccount(balance=10**21) for a in senders}
chain_alloc[contract] = GenesisAccount(code=code, storage={
    (i + 1).to_bytes(32, "big"): b"\x01" for i in range(40)})
disk = MemoryDB()
tdb = TrieDatabase(disk, batch_keccak=get_batch_keccak("planned", "cpu"))
gen_block = Genesis(config=cfg, alloc=chain_alloc).commit(disk, Database(tdb))
signer = Signer(cfg.chain_id)


def gen(i, bg):
    for j, k in enumerate(keys):
        to = contract if (i, j) == (1, 0) else (0x7000 + j).to_bytes(20, "big")
        bg.add_tx(signer.sign(Transaction(
            type=2, chain_id=cfg.chain_id, nonce=i, max_fee=10**12, gas=90000,
            to=to, value=5, data=b"\x2a" * 32 if to == contract else b""), k))


runs = planned.PlannedGraphBuilder.run
planned_runs = []


def counted(self, *a, **kw):
    planned_runs.append(1)
    return runs(self, *a, **kw)


planned.PlannedGraphBuilder.run = counted
blocks, receipts = generate_chain(cfg, gen_block, new_dummy_engine(),
                                  Database(tdb), 2, gen=gen)
planned.PlannedGraphBuilder.run = runs
assert planned_runs
assert all(r.status == 1 for rs in receipts for r in rs)
assert len(receipts[1][0].logs) == 1
tdb.commit(blocks[-1].root)
back = StateDB(blocks[-1].root, Database(TrieDatabase(disk)))
assert back.get_state(contract, b"\x00" * 32) == b"\x2a" * 32
assert back.get_nonce(senders[0]) == 2
assert back.get_balance((0x7001).to_bytes(20, "big")) == 10

# a full BlockChain life on the same genesis: construction (the resident
# mirror booted, the snapshot generated), the two blocks inserted, a
# sibling of the second inserted and rejected, the blocks accepted, stop
# (the shutdown export), then the tip read back through a fresh
# TrieDatabase
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig

sibling, _ = generate_chain(cfg, blocks[0], new_dummy_engine(), Database(tdb),
                            1, gap=13, gen=lambda i, bg: bg.add_tx(
                                signer.sign(Transaction(
                                    type=2, chain_id=cfg.chain_id, nonce=1,
                                    max_fee=10**12, gas=21000, to=contract,
                                    value=9), keys[5])))
disk = MemoryDB()
chain = BlockChain(disk, CacheConfig(resident_account_trie=True), cfg,
                   Genesis(config=cfg, alloc=chain_alloc), new_dummy_engine(),
                   device="cpu")
assert chain.mirror is not None and chain.snaps is not None
assert chain.genesis_block.hash() == gen_block.hash()
for b in blocks + sibling:
    chain.insert_block(b)
assert chain.current_block.hash() == blocks[-1].hash()
chain.reject(sibling[0])
for b in blocks:
    chain.accept(b)
chain.drain_acceptor_queue()
assert chain.acceptor_error is None and not chain.bad_blocks
assert chain.snaps.disk_layer.root == blocks[-1].root
chain.stop()
back = StateDB(blocks[-1].root, Database(TrieDatabase(disk)))
assert back.get_state(contract, b"\x00" * 32) == b"\x2a" * 32
assert back.get_nonce(senders[0]) == 2

# the VM: booted from JSON config bytes on the CPU, an atomic import and a
# transfer built, verified and accepted; then a block of 60 transfers to
# fresh accounts whose planned dispatch fails (the error reaches
# build_block, the head stays), then built again after the caller demotes
# the degradation ladder, landing on the host
import json
from coreth_tpu_torch import fault
from coreth_tpu_torch.ops.device import default_ladder
from coreth_tpu_torch.vm import atomic_tx
from coreth_tpu_torch.vm.shared_memory import Element, Memory, Requests
from coreth_tpu_torch.vm.vm import VM, SnowContext

mem = Memory()
vm = VM()
vm.initialize(SnowContext(shared_memory=mem), MemoryDB(),
              Genesis(config=cfg, alloc=chain_alloc),
              config_bytes=json.dumps({"device-probe-interval": 0,
                                       "insert-pipeline-depth": 1}).encode(),
              device="cpu")
assert vm.sync_handler is not None and vm.blockchain.pipeline is not None
# a block every 10 s of chain time (tip 0 pays no block gas cost then)
vm.miner.clock = lambda: vm.blockchain.current_block.time + 10
ctx = vm.ctx
utxo = atomic_tx.UTXO(tx_id=b"\x07" * 32, output_index=0,
                      asset_id=ctx.avax_asset_id, amount=5 * 10**9,
                      address=senders[0])
mem.new_shared_memory(ctx.x_chain_id).apply({ctx.chain_id: Requests(
    put_requests=[Element(utxo.utxo_id(), utxo.encode(), [senders[0]])])})
imp = atomic_tx.Tx(atomic_tx.ImportTx(
    network_id=ctx.network_id, blockchain_id=ctx.chain_id,
    source_chain=ctx.x_chain_id, imported_inputs=[utxo],
    outs=[atomic_tx.EVMOutput(b"\xdd" * 20, 4 * 10**9, ctx.avax_asset_id)]))
imp.sign([keys[0]])
vm.issue_atomic_tx(imp)
vm.issue_tx(signer.sign(Transaction(
    type=2, chain_id=cfg.chain_id, nonce=0, max_fee=10**12, gas=21000,
    to=b"\xde" * 20, value=7), keys[1]))
blk = vm.build_block()
blk.verify()
vm.set_preference(blk.id())
blk.accept()
vm.blockchain.drain_acceptor_queue()
assert vm.last_accepted().id() == blk.id() and len(blk.atomic_txs) == 1
st = vm.blockchain.state()
assert st.get_balance(b"\xdd" * 20) == 4 * 10**18
assert st.get_balance(b"\xde" * 20) == 7
assert not mem.new_shared_memory(ctx.chain_id).indexed(
    ctx.x_chain_id, [senders[0]])[0]
for j, k in enumerate(keys):
    vm.issue_tx(signer.sign(Transaction(
        type=2, chain_id=cfg.chain_id, nonce=int(j == 1), max_fee=10**12,
        gas=21000, to=(0x9000 + j).to_bytes(20, "big"), value=j + 1), k))
head = vm.last_accepted().id()
fault.set_failpoint("ops/device/dispatch", "raise")
try:
    vm.build_block()
    raise AssertionError("the failed dispatch did not reach build_block")
except fault.FailpointError:
    pass
fault.clear_all()
assert default_ladder().healthy and vm.blockchain.current_block.hash() == head
default_ladder().demote("the caller took the host")
blk = vm.build_block()
blk.verify()
blk.accept()
vm.blockchain.drain_acceptor_queue()
assert len(blk.eth_block.transactions) == 60
assert not default_ladder().healthy
assert [e["event"] for e in vm.blockchain.flight_recorder.events()
        ].count("device/demote") == 1
st = vm.blockchain.state()
assert st.get_balance((0x9000 + 59).to_bytes(20, "big")) == 60
vm.shutdown()
default_ladder().reset()

# the commitment shadow and the batch keccak precompile: a bintrie planned
# commit and a witness; a shadow chain on a genesis that enables the
# precompile, whose block calls it with 64 messages through the device
# seam; an MPT proof through the commitment seam and a range proof
import dataclasses
from coreth_tpu_torch.bintrie import (BinaryTrie, NodeStore, prove as wprove,
                                      reference_root, verify_witness)
from coreth_tpu_torch.bintrie.planned import commit_planned
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.ops.keccak_torch import default_batched_keccak
from coreth_tpu_torch.precompile import (TPU_KECCAK_ADDR, TpuKeccakConfig,
                                         function_selector)
from coreth_tpu_torch.trie import prove, verify_range_proof
from coreth_tpu_torch.trie.trie import Trie

bt = BinaryTrie(NodeStore())
content = {rng.randbytes(32): rng.randbytes(9) for _ in range(200)}
for k, v in content.items():
    bt.update(k, v)
broot = commit_planned(bt, device="cpu")
assert broot == reference_root(content)
k0 = next(iter(content))
assert verify_witness(broot, k0, wprove(bt.store, broot, k0)) == \
    (True, content[k0])

pcfg = dataclasses.replace(cfg, precompile_upgrades=(
    TpuKeccakConfig(timestamp=0),))
msgs = [rng.randbytes(40) for _ in range(64)]
heads, tail = b"", b""
for m in msgs:
    heads += (32 * 64 + len(tail)).to_bytes(32, "big")
    tail += len(m).to_bytes(32, "big") + m + b"\x00" * (-len(m) % 32)
calldata = (function_selector("keccak256Batch(bytes[])")
            + (32).to_bytes(32, "big") + (64).to_bytes(32, "big") + heads
            + tail)
disk = MemoryDB()
tdb = TrieDatabase(disk, batch_keccak=get_batch_keccak("planned", "cpu"))
pgen = Genesis(config=pcfg, alloc=chain_alloc).commit(disk, Database(tdb))
pblocks, preceipts = generate_chain(
    pcfg, pgen, new_dummy_engine(), Database(tdb), 1,
    gen=lambda i, bg: bg.add_tx(signer.sign(Transaction(
        type=2, chain_id=cfg.chain_id, nonce=0, max_fee=10**12,
        gas=300_000, to=TPU_KECCAK_ADDR, data=calldata), keys[0])))
assert preceipts[0][0].status == 1
calls = default_batched_keccak("cpu").calls
chain = BlockChain(MemoryDB(), CacheConfig(state_backend="bintrie-shadow"),
                   pcfg, Genesis(config=pcfg, alloc=chain_alloc),
                   new_dummy_engine(), device="cpu")
chain.insert_block(pblocks[0])
assert default_batched_keccak("cpu").calls == calls + 1
shadow = chain.state_database.shadow
assert shadow.root_for(pblocks[0].root) is not None and not shadow.quarantined
backend = chain.state_database.backend
key = keccak256(senders[0])
assert backend.verify(pblocks[0].root, key,
                      backend.prove(pblocks[0].root, key))[0]
chain.stop()
t = Trie()
leaves = sorted((rng.randbytes(32), rng.randbytes(5)) for _ in range(50))
for k, v in leaves:
    t.update(k, v)
edge = {keccak256(b): b for k in (leaves[3][0], leaves[20][0])
        for b in prove(t, k)}
assert verify_range_proof(t.hash(), leaves[3][0], leaves[20][0],
                          [k for k, _ in leaves[3:21]],
                          [v for _, v in leaves[3:21]], edge) is True

# the mesh and the legacy executors: ShardedKeccak and commit_step on a
# virtual 4-position CPU mesh, the fused, staged and mesh-planned commits
# of one plan, a 4-shard resident mirror walked down its ladder, and a
# trie in device-hasher "fused"
from coreth_tpu_torch.native.mpt import plan_from_items
from coreth_tpu_torch.ops.keccak_torch import pack_messages
from coreth_tpu_torch.parallel import (ShardedKeccak, commit_step, make_mesh,
                                       planned_commit_over_mesh)
from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror

mesh = make_mesh(4, device="cpu")
mmsgs = [rng.randbytes(rng.randint(0, 300)) for _ in range(40)]
assert ShardedKeccak(mesh).digests(mmsgs) == [keccak256(m) for m in mmsgs]
mwords, mnb = pack_messages(mmsgs[:32])
mout, msum = commit_step(mesh)(mwords, mnb)
assert int(msum) == int(mout.long().sum()) % 2**32
mitems = sorted({rng.randbytes(32): rng.randbytes(rng.randint(1, 90))
                 for _ in range(300)}.items())
mplan = plan_from_items(mitems)
mroot = mplan.execute_cpu()
assert mplan.execute_device(device="cpu")[0] == mroot
assert mplan.execute_staged(device="cpu")[0] == mroot
assert mplan.execute_planned(planned_commit_over_mesh(mesh)) == mroot
mm = ResidentAccountMirror(mitems, mesh_devices=4, device="cpu")
assert mm.root_of(mm.GENESIS) == mroot and mm.shards == 4
assert mm.take_over_host() == "device" and mm.take_over_host() == "host"
ft = Trie(batch_keccak=get_batch_keccak("fused", "cpu"))
for k, v in mitems:
    ft.update(k, v)
assert ft.hash() == mroot

# the wallet: a light-scrypt keyfile round trip through the port's own
# AES-128-CTR, and one WebSocket subscribe and push
import tempfile

from coreth_tpu_torch.accounts.keystore import KeyStore, decrypt_key, \
    encrypt_key
from coreth_tpu_torch.ethclient import ws_connect
from coreth_tpu_torch.rpc.server import RPCServer
from coreth_tpu_torch.rpc.websocket import WSServer

priv = rng.randbytes(32)
kj = encrypt_key(priv, "pw", light=True)
assert decrypt_key(kj, "pw") == priv and kj["crypto"]["kdf"] == "scrypt"
with tempfile.TemporaryDirectory() as d:
    ks = KeyStore(d)
    addr = ks.import_key(priv, "pw").address
    ks.unlock(addr, "pw", timeout=60)
    assert len(ks.sign_hash(addr, b"\x01" * 32)) == 65
    ks.close()
srv = RPCServer()
feeds = []
srv.register_subscription("eth", "newHeads",
                          lambda notify, *p: feeds.append(notify))
ws = WSServer(srv, notify_queue_size=4)
client = ws_connect("127.0.0.1", ws.serve())
heads = client.subscribe_new_heads()
feeds[0]({"number": "0x1"})
assert heads.next(timeout=10) == {"number": "0x1"}
client.close()
ws.stop()

# the operations surface and state sync: a short chaos run, the metrics
# check, a faulting SQLite store, and an account trie synced over TCP from
# a leafs handler with a faulty second peer, into a SQLite store
import os

from coreth_tpu_torch.ethdb.faultdb import FaultInjectingDB
from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB
from coreth_tpu_torch.fault.chaos import run_chaos
from coreth_tpu_torch.metrics.__main__ import main as metrics_main
from coreth_tpu_torch.peer.network import Network
from coreth_tpu_torch.peer.testing import FaultyTransport
from coreth_tpu_torch.peer.transport import TransportServer, dial
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.statedb import StateDB
from coreth_tpu_torch.sync.client import SyncClient
from coreth_tpu_torch.sync.handlers import SyncHandler
from coreth_tpu_torch.sync.statesync import StateSyncer
from coreth_tpu_torch.trie.triedb import TrieDatabase
from coreth_tpu_torch.utils.racecheck import LockOrderWitness

fault.clear_all()
assert metrics_main(["--check"]) == 0
with tempfile.TemporaryDirectory() as d:
    fdb = FaultInjectingDB(SQLiteDB(os.path.join(d, "f.db")))
    fault.set_failpoint("ethdb/torn_batch", "raise*1")
    try:
        fdb.write_batch([(b"a", b"1"), (b"b", b"2")])
    except Exception:
        pass
    fault.clear_all()
    assert list(fdb.iterate()) == [(b"a", b"1")]
    fdb.close()
    stdb = TrieDatabase(MemoryDB())
    sst = StateDB(EMPTY_ROOT, Database(stdb))
    for i in range(1, 301):
        sst.add_balance(i.to_bytes(20, "big"), 10**15 + i)
    sroot = sst.commit()
    stdb.commit(sroot)
    handler = SyncHandler(None, stdb, stdb.diskdb, snaps=None)
    tcp = TransportServer(handler.handle)
    tport = tcp.serve()
    good, other = dial("127.0.0.1", tport), dial("127.0.0.1", tport)
    net = Network()
    net.connect(b"good", good)
    net.connect(b"faulty", FaultyTransport(other, ["corrupt", "drop"]))
    sdb = SQLiteDB(os.path.join(d, "sync.db"), sync=False)
    with StateSyncer(SyncClient(net, backoff_base=0.001, backoff_cap=0.002),
                     sdb, sroot) as syncer:
        syncer.sync()
    assert sdb.get(sroot) is not None
    sdb.close()
    for c in (good, other):
        c.close()
    net.close()
    assert tcp.stop() == []
assert isinstance(LockOrderWitness().violations, list)

# the VM's network and process boundary and the offline pruner: a VM
# served over a unix socket to a RemoteVM, a Gossiper's inbound path, the
# cross-chain eth_call to itself, the plumbing, a prune of a small store
import socket
import threading
from coreth_tpu_torch.core.pruner import Pruner, ShutdownTracker
from coreth_tpu_torch.core.types import Signer, Transaction
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.plugin import RemoteVM, VMServer, protocol
from coreth_tpu_torch.vm.gossiper import Gossiper, encode_tx_gossip
from coreth_tpu_torch.vm.plumbing import StaticService, factory_new
from coreth_tpu_torch.vm.shared_memory import Memory
from coreth_tpu_torch.vm.vm import VM, SnowContext

key = b"\x11" * 32
gvm = VM()
gvm.initialize(SnowContext(shared_memory=Memory()), MemoryDB(),
               Genesis(config=params.TEST_CHAIN_CONFIG,
                       gas_limit=params.CORTINA_GAS_LIMIT,
                       alloc={priv_to_address(key):
                              GenesisAccount(balance=10**24)}),
               config_bytes=b'{"device-hasher": "off"}', device="cpu")
gnet = Network()
Gossiper(gvm, gnet)
gtx = Signer(43112).sign(Transaction(
    type=2, chain_id=43112, nonce=0, max_fee=10**12, max_priority_fee=10**9,
    gas=21000, to=b"\xbb" * 20, value=1), key)
gnet.app_request(b"peer", b"\xff" + encode_tx_gossip([gtx]))
assert gvm.txpool.has(gtx.hash())
gnet.register_cross_chain_handler(gvm.chain_id_bytes,
                                  gvm.handle_cross_chain_request)
assert gvm.cross_chain_eth_call(gnet, gvm.chain_id_bytes, {
    "to": "0x" + "bb" * 20}) == b""
with tempfile.TemporaryDirectory() as d:
    srv = VMServer(gvm, os.path.join(d, "vm.sock"))
    st = threading.Thread(target=srv.serve_forever)
    st.start()
    remote = RemoteVM(os.path.join(d, "vm.sock"))
    assert remote.health() and remote.last_accepted().height == 0
    remote.shutdown()
    st.join(10)
    assert not st.is_alive() and srv.threads_left == []
gnet.close()
gvm.shutdown()
a, b = socket.socketpair()
protocol.send_msg(a, {"id": 1})
assert protocol.recv_msg(b) == {"id": 1}
a.close()
b.close()
assert StaticService().buildGenesis({})["encoding"] == "hex"
assert factory_new().initialized is False
assert ShutdownTracker(MemoryDB()).mark_start() is False
assert Pruner(stdb.diskdb, stdb).prune(sroot) == 0
out = run_chaos(seed=5, steps=6, kill_drill=False, device="cpu")
assert out["violations"] == [] and out["final"]["height"] > 0
leaked = [m for m in sys.modules if refused(m)]
assert not leaked, leaked
print("ISOLATED-OK")
'''


def test_port_runs_the_slice_without_jax_or_coreth_tpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "coreth_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_source_imports_jax_or_coreth_tpu():
    bad = []
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {n}")
    assert len(_sources()) > 10
    names = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("log.py", "metrics/__init__.py", "metrics/spans.py",
                "metrics/tracectx.py", "fault/__init__.py",
                "trie/iterator.py", "trie/resident_mirror.py",
                "state/resident_trie.py", "core/state_manager.py",
                "vmerrs.py", "utils/__init__.py", "utils/deadline.py",
                "native/secp.py", "crypto/__init__.py",
                "crypto/secp256k1.py", "trie/stacktrie.py", "core/types.py",
                "evm/opcodes.py", "evm/gas.py", "evm/bn256.py",
                "evm/precompiles.py", "evm/interpreter.py", "evm/evm.py",
                "core/state_transition.py", "core/state_processor.py",
                "consensus/dummy.py", "core/chain_makers.py",
                "metrics/flight.py", "state/snapshot.py",
                "state/trie_prefetcher.py", "core/sender_cacher.py",
                "core/bloom_index.py", "core/blockchain.py",
                "core/mvcc.py", "core/parallel_exec.py",
                "core/exec_shards.py", "core/shard_worker.py",
                "core/insert_pipeline.py", "metrics/shardstats.py",
                "ops/device.py", "core/txpool.py", "miner/worker.py",
                "vm/shared_memory.py", "vm/atomic_tx.py", "vm/mempool.py",
                "vm/atomic_trie.py", "vm/atomic_backend.py",
                "vm/block_verification.py", "vm/block.py",
                "vm/block_builder.py", "vm/plumbing.py", "vm/config.py",
                "vm/vm.py", "precompile/__init__.py",
                "precompile/tpu_keccak.py", "bintrie/__init__.py",
                "bintrie/tree.py", "bintrie/planned.py", "bintrie/witness.py",
                "bintrie/backend.py", "bintrie/shadow.py", "trie/proof.py",
                "trie/proof_range.py", "state/commitment.py",
                "parallel/__init__.py", "ops/keccak_fused.py",
                "ops/keccak_staged.py", "ops/keccak_resident.py",
                "trie/hasher.py", "rpc/admission.py", "rpc/server.py",
                "eth/cache.py", "eth/gasprice.py", "eth/filters.py",
                "eth/api.py", "eth/backend.py", "state/dump.py",
                "eth/tracer_dsl.py", "eth/tracers.py",
                "metrics/profiler.py", "metrics/http.py",
                "utils/racecheck.py", "vm/api.py", "ethclient/__init__.py",
                "accounts/__init__.py", "accounts/abi.py",
                "accounts/keystore.py", "accounts/manager.py",
                "accounts/external.py", "accounts/bind.py",
                "signer/__init__.py", "interfaces.py", "rpc/websocket.py",
                "ethclient/ws.py", "vm/tx_builder.py", "ethdb/faultdb.py",
                "ethdb/sqlitedb.py", "fault/chaos.py", "metrics/__main__.py",
                "sync/__init__.py", "sync/messages.py", "sync/client.py",
                "sync/handlers.py", "sync/statesync.py", "peer/__init__.py",
                "peer/network.py", "peer/transport.py", "peer/testing.py",
                "vm/syncervm.py", "vm/gossiper.py", "plugin/__init__.py",
                "plugin/protocol.py", "plugin/server.py", "plugin/client.py",
                "core/pruner.py", "analysis/__init__.py",
                "analysis/__main__.py", "analysis/engine.py",
                "analysis/rules.py", "analysis/callgraph.py",
                "analysis/cache.py", "graft_entry.py"):
        assert os.path.join("coreth_tpu_torch", mod) in names, mod
    assert not bad, bad


def test_chaos_kill_child_source_imports_only_the_port():
    """fault/chaos.py's _KILL_CHILD is source text that the AST scan of
    the package's modules cannot see: its own imports are checked here."""
    from coreth_tpu_torch.fault.chaos import _KILL_CHILD

    roots = set()
    for node in ast.walk(ast.parse(_KILL_CHILD)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "coreth_tpu_torch" in roots
    assert not roots & set(FORBIDDEN), roots


def _imports(tree) -> set:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def _engine_child() -> str:
    """chip_smoke.py's _ENGINE_CHILD source, read from its AST (importing
    chip_smoke would import torch and the whole port)."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "_ENGINE_CHILD"):
            return node.value.value
    raise AssertionError("chip_smoke.py has no _ENGINE_CHILD")


def test_engine_child_imports_only_the_plugin_client():
    """chip_smoke.py's engine child (phase 7d) is source text the AST scan
    of the port cannot see: it imports the plugin client alone, and its
    own guard refuses torch beside the forbidden packages."""
    child = _engine_child()
    assert _imports(ast.parse(child)) == {"json", "sys", "time",
                                          "coreth_tpu_torch"}
    assert "from coreth_tpu_torch.plugin.client import" in child
    assert '"torch")' in child


def test_engine_child_runs_under_its_guard(tmp_path):
    """The engine child against a port VM served here: its handshake is
    the VM's last accepted block, and after `shutdown` it exits 0 having
    loaded no torch, jax, jaxlib, coreth_tpu or cryptography module; the
    server's threads are joined."""
    import threading

    from coreth_tpu_torch import params
    from coreth_tpu_torch.core.genesis import Genesis
    from coreth_tpu_torch.ethdb import MemoryDB
    from coreth_tpu_torch.plugin import VMServer
    from coreth_tpu_torch.vm.shared_memory import Memory
    from coreth_tpu_torch.vm.vm import VM, SnowContext

    vm = VM()
    vm.initialize(SnowContext(shared_memory=Memory()), MemoryDB(),
                  Genesis(config=params.TEST_CHAIN_CONFIG, alloc={}),
                  config_bytes=b'{"device-hasher": "off"}', device="cpu")
    sock_dir = __import__("tempfile").mkdtemp(prefix="eng")
    sock = os.path.join(sock_dir, "vm.sock")
    srv = VMServer(vm, sock)
    t = threading.Thread(target=srv.serve_forever)
    t.start()
    try:
        r = subprocess.run(
            [sys.executable, "-c", _engine_child(), sock, REPO],
            input="shutdown\n", capture_output=True, text=True,
            timeout=120, cwd=str(tmp_path))
    finally:
        t.join(10)
        vm.shutdown()
        os.rmdir(sock_dir)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in r.stdout.splitlines())
    assert json.loads(lines["READY"])["last"] == \
        vm.last_accepted().id().hex()
    assert json.loads(lines["DONE"])["leaked"] == []
    assert not t.is_alive() and srv.threads_left == []


def test_plugin_test_child_imports_only_the_port():
    """tests/test_torch_plugin.py runs as the VM's child process: its
    module-level imports and its _child function reach neither jax,
    jaxlib, coreth_tpu nor cryptography (the twins' reference imports
    live inside the parent's fixtures and cases)."""
    path = os.path.join(REPO, "tests", "test_torch_plugin.py")
    tree = ast.parse(open(path).read(), path)
    top = ast.Module(body=[n for n in tree.body
                           if isinstance(n, (ast.Import, ast.ImportFrom))],
                     type_ignores=[])
    child, = [n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_child"]
    roots = _imports(top) | _imports(child)
    assert not roots & set(FORBIDDEN), roots
    main = tree.body[-1]
    assert isinstance(main, ast.If) and "_child" in ast.unparse(main)


def test_relative_imports_resolve_inside_the_port():
    """Every relative import of a port module names a module the port
    has."""
    root = os.path.join(REPO, "coreth_tpu_torch")

    def exists(base, dotted):
        path = os.path.join(base, *dotted.split("."))
        return (os.path.isfile(path + ".py")
                or os.path.isfile(os.path.join(path, "__init__.py")))

    missing = []
    for path in _sources():
        if not path.startswith(root + os.sep):
            continue
        base = os.path.dirname(path)
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if not isinstance(node, ast.ImportFrom) or node.level == 0:
                continue
            pkg = base
            for _ in range(node.level - 1):
                pkg = os.path.dirname(pkg)
            where = f"{os.path.relpath(path, REPO)}:{node.lineno}"
            if node.module:
                if not exists(pkg, node.module):
                    missing.append(f"{where} {node.module}")
                continue
            init = open(os.path.join(pkg, "__init__.py")).read()
            for a in node.names:  # a submodule or a name of __init__
                if not exists(pkg, a.name) and a.name not in init:
                    missing.append(f"{where} {a.name}")
    assert not missing, missing


_RPC_CHILD = r'''
import json
import sys

FORBIDDEN = ("jax", "jaxlib", "coreth_tpu", "cryptography")


def refused(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(f"the port must not import {name}")
        return None


sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[2])

import torch_rpc_twin as tw

spec = json.load(open(sys.argv[1]))
node = tw.Node("coreth_tpu_torch", spec["config"])
ids = []
for raw in spec["txs"]:
    node.submit([bytes.fromhex(raw)])
    ids.append(node.build_and_accept().id())
t1, t2 = (bytes.fromhex(h) for h in spec["hashes"])
answers = node.answer(tw.read_requests(t1, t2, *ids))
node.shutdown()
leaked = [m for m in sys.modules if refused(m)]
assert not leaked, leaked
print("ANSWERS " + json.dumps(answers))
print("ISOLATED-OK")
'''


@pytest.mark.parametrize("config", [{}, {"resident-account-trie": True}],
                         ids=["default", "resident"])
def test_rpc_twin_port_half_runs_without_jax_or_coreth_tpu(tmp_path, config):
    """The port's half of tests/test_torch_rpc.py's twin (its VM, its
    create_handlers server, the read requests) in a process whose
    sys.meta_path refuses jax, jaxlib and coreth_tpu; its answers equal
    the reference's half run here."""
    from coreth_tpu.core.types import Signer, Transaction

    import torch_rpc_twin as tw

    sign = Signer(tw.CHAIN_ID).sign
    txs = [sign(Transaction(type=2, chain_id=tw.CHAIN_ID, nonce=i,
                            max_fee=10**12, max_priority_fee=10**9,
                            gas=gas, to=to, value=value), tw.KEY)
           for i, (to, gas, value) in enumerate(
               [(tw.DEST, 21000, 12345), (tw.EMITTER_ADDR, 100_000, 0)])]
    ref = tw.Node("coreth_tpu", config)
    ids = []
    for t in txs:
        ref.submit([t.encode()])
        ids.append(ref.build_and_accept().id())
    want = ref.answer(tw.read_requests(txs[0].hash(), txs[1].hash(), *ids))
    ref.shutdown()
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "config": config, "txs": [t.encode().hex() for t in txs],
        "hashes": [t.hash().hex() for t in txs]}))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-c", _RPC_CHILD, str(spec),
         os.path.join(REPO, "tests")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout
    line = next(x for x in r.stdout.splitlines() if x.startswith("ANSWERS "))
    assert json.loads(line[len("ANSWERS "):]) == json.loads(json.dumps(want))


def test_resolve_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve(None)
    with pytest.raises(RuntimeError):
        device.resolve("cuda")
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")
    assert device.hopper_available() is False


def test_entry_points_without_cuda_raise(monkeypatch):
    from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, PlannedMode

    from coreth_tpu_torch.ops.device import get_batch_keccak
    from coreth_tpu_torch.ops.keccak_torch import BatchedKeccak, \
        keccak256_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PlannedCommit()
    with pytest.raises(RuntimeError):
        PlannedMode()
    with pytest.raises(RuntimeError):
        BatchedKeccak()
    with pytest.raises(RuntimeError):
        keccak256_batch([b"abc"])
    for mode in ("batched", "planned", "auto", "fused"):
        with pytest.raises(RuntimeError):
            get_batch_keccak(mode)
    assert get_batch_keccak("off") is None
    from coreth_tpu_torch.ops.keccak_fused import fused_commit
    from coreth_tpu_torch.ops.keccak_staged import StagedCommit

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StagedCommit()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_commit((), b"", [], [], [], [])


def test_resident_entry_points_without_cuda_raise(monkeypatch):
    """The resident executor, commit_device and the resident mirror that
    carries the resident block commit default to CUDA and raise without
    it; none falls to the CPU."""
    from coreth_tpu_torch.native.mpt import IncrementalTrie
    from coreth_tpu_torch.ops.keccak_resident import ResidentExecutor
    from coreth_tpu_torch.state.account import Account
    from coreth_tpu_torch.trie.secure import StateTrie
    from coreth_tpu_torch.state.statedb import batch_storage_roots
    from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidentExecutor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidentExecutor(pipeline_depth=2)
    t = IncrementalTrie([(b"\x01" * 32, b"v" * 40), (b"\x02" * 32, b"w")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t.commit_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidentAccountMirror([(b"\x01" * 32, b"v" * 40)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidentAccountMirror([])
    # nothing was hashed on the way: the trie is still dirty and unpinned
    assert t.commit_cpu() == IncrementalTrie(
        [(b"\x01" * 32, b"v" * 40), (b"\x02" * 32, b"w")]).commit_cpu()
    st = StateTrie()
    for i in range(120):
        st.update(bytes([i]) * 32, b"\x01" * 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_storage_roots({b"\x03" * 20: (Account(), st)})
    assert st.trie.unhashed == 120  # left to the trie's own hash()


@pytest.mark.parametrize("how", ["parallel_workers", "exec_shards_n",
                                 "CORETH_TPU_EVM_PARALLEL",
                                 "CORETH_TPU_EVM_EXEC_SHARDS"])
def test_speculative_mode_is_reached(how, monkeypatch):
    """The thread-parallel and sharded execution modes, asked for by the
    processor's knob or by its env override (read per block), run the
    block in that mode: the processor reports it, and the block lands the
    root the reference's serial loop stamped."""
    from coreth_tpu_torch.core.state_processor import StateProcessor
    from coreth_tpu_torch.core.types import Block
    from torch_exec_twin import corpus, port_chain

    mode = "parallel" if "PARALLEL" in how.upper() else "shards"
    monkeypatch.delenv("CORETH_TPU_EVM_PARALLEL", raising=False)
    monkeypatch.delenv("CORETH_TPU_EVM_EXEC_SHARDS", raising=False)
    chain = port_chain()
    if how.startswith("CORETH"):
        monkeypatch.setenv(how, "2")
    else:
        chain.processor = StateProcessor(chain.config, chain, chain.engine,
                                         **{how: 2})
    block = corpus("disjoint")[0]
    chain.insert_block(Block.decode(block.encode()))
    assert chain.processor.last_parallel["mode"] == mode
    assert chain.processor.last_parallel["workers"] == 2
    assert chain.current_block.root == block.header.root
    chain.stop()


def test_failed_secp_build_raises(monkeypatch, tmp_path):
    """A native secp256k1 that does not build raises; sender recovery does
    not drift to pure Python."""
    from coreth_tpu_torch.core.types import Signer, Transaction
    from coreth_tpu_torch.native import secp

    monkeypatch.setattr(secp, "_lib", None)
    monkeypatch.setattr(secp, "_SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(secp, "build_and_load", lambda *a, **kw: (
        _ for _ in ()).throw(RuntimeError("build of libsecp256k1.so failed")))
    tx = Transaction(type=2, chain_id=1, gas=21000, to=b"\x01" * 20, v=0,
                     r=5, s=7)
    with pytest.raises(RuntimeError, match="build of libsecp256k1.so"):
        Signer(1).sender(tx)
    with pytest.raises(RuntimeError, match="build of libsecp256k1.so"):
        Signer(1).sender_batch([tx])


def test_shard_worker_imports_stdlib_fault_and_shardstats_only():
    """core/shard_worker.py's module-level imports: the stdlib, the fault
    package and metrics/shardstats (whose own are the stdlib alone); the
    EVM machinery only inside functions. A hostile import fails the same
    check."""
    def module_imports(src):
        names = []
        for node in ast.parse(src).body:
            if isinstance(node, ast.Import):
                names += [(0, a.name) for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names += [(node.level, (node.module or "") + "." + a.name)
                          for a in node.names]
        return names

    def stray(names):
        allowed = {(2, ".fault"), (2, "metrics.shardstats.ShardStats")}
        return [n for n in names if not (
            (n[0] == 0 and n[1].split(".")[0] in sys.stdlib_module_names)
            or n in allowed or n == (0, "__future__.annotations"))]

    path = os.path.join(REPO, "coreth_tpu_torch", "core", "shard_worker.py")
    names = module_imports(open(path).read())
    assert (2, ".fault") in names and not stray(names), stray(names)
    stats = os.path.join(REPO, "coreth_tpu_torch", "metrics", "shardstats.py")
    assert not stray(module_imports(open(stats).read()))
    for hostile in ("from .. import metrics\n", "import torch\n",
                    "from .mvcc import VersionedStateView\n"):
        assert stray(module_imports(hostile)), hostile


_ANALYSIS_CHILD = r'''
import sys

FORBIDDEN = ("jax", "jaxlib", "coreth_tpu", "cryptography")


def refused(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(f"the port must not import {name}")
        return None


sys.meta_path.insert(0, Refuse())

from coreth_tpu_torch.analysis.__main__ import main

assert main(["--strict-baseline"]) == 0
from coreth_tpu_torch.graft_entry import entry

fn, args = entry(device="cpu")
words, dig = fn(*args)
assert int(dig.abs().sum()) > 0
leaked = [m for m in sys.modules if refused(m)]
assert not leaked, leaked
print("ISOLATED-OK")
'''


def test_analysis_cli_and_graft_entry_run_without_jax_or_coreth_tpu(
        tmp_path_factory):
    """The port's analysis gate (its CLI) and its graft entry (entry() on
    the CPU) under the import guard that refuses jax, jaxlib, coreth_tpu
    and cryptography. The analysis cache is the test run's temporary one
    that tests/test_torch_analysis.py uses too."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["CORETH_TPU_TORCH_ANALYSIS_CACHE"] = str(
        tmp_path_factory.getbasetemp() / "coreth-tpu-torch-analysis.pkl")
    r = subprocess.run([sys.executable, "-c", _ANALYSIS_CHILD], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout
    assert "0 finding(s)" in r.stderr


_SHARDED_CHILD = r'''
import sys

FORBIDDEN = ("jax", "jaxlib", "coreth_tpu", "cryptography")


def refused(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(f"the port must not import {name}")
        return None


sys.meta_path.insert(0, Refuse())

from coreth_tpu_torch import params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.ethdb import MemoryDB

lines = open(sys.argv[1]).read().split()
alloc = {bytes.fromhex(a): GenesisAccount(balance=int(v),
                                          code=bytes.fromhex(c))
         for a, v, c in (l.split(":") for l in lines[1:])}
block = Block.decode(bytes.fromhex(lines[0]))
chain = BlockChain(MemoryDB(), CacheConfig(evm_exec_shards=2),
                   params.TEST_CHAIN_CONFIG,
                   Genesis(config=params.TEST_CHAIN_CONFIG,
                           gas_limit=params.CORTINA_GAS_LIMIT, alloc=alloc),
                   new_dummy_engine(), device="cpu")
chain.insert_block(block)
assert chain.processor.last_parallel["mode"] == "shards"
assert chain.current_block.root == block.header.root
for pong in chain.processor.shard_pool().ping():
    print("PONG", pong[3], pong[4], ",".join(pong[5]) or "-")
chain.stop()
leaked = [m for m in sys.modules if refused(m)]
assert not leaked, leaked
print("ISOLATED-OK")
'''


def test_sharded_block_runs_without_jax_or_coreth_tpu(tmp_path):
    """One sharded block in a process whose sys.meta_path refuses jax,
    jaxlib and coreth_tpu. The workers start from a forkserver, which the
    guard does not reach, so their own pongs report what they loaded:
    no refused module, no CUDA context, no inherited thread."""
    from torch_exec_twin import ADDRS, EXTRA, FUND, corpus

    block = corpus("disjoint")[0]
    spec = tmp_path / "block.txt"
    spec.write_text("\n".join(
        [block.encode().hex()] + [f"{a.hex()}:{FUND}:" for a in ADDRS]
        + [f"{a.hex()}:{bal}:{code.hex()}"
           for a, (bal, code) in EXTRA.items()]))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _SHARDED_CHILD, str(spec)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout
    pongs = [line.split()[1:] for line in r.stdout.splitlines()
             if line.startswith("PONG")]
    assert pongs == [["0", "False", "-"]] * 2, r.stdout
