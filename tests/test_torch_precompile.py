"""The port's stateful precompiles (coreth_tpu_torch/precompile) against the
JAX package's (coreth_tpu/precompile), on the CPU.

(a) Selectors, fork transitions, and the batch keccak's ABI scan with its
edge cases (truncated input, a count over MAX_BATCH_MESSAGES, overlapping
offsets, lengths past the end, too little gas): the same return data, gas
and errors. (b) check_configure at genesis and at a later timestamp: the
same state roots on the same blocks. (c) A call of 64 messages or more
through both EVMs: the same return data, gas left and root, with the
port's device seam (its StateDB's batch keccak: K2's plain version)
called once; below 64 messages it is not called. (d) The port's device
rule: an error of the seam surfaces from insert_block with the head
unchanged, never as a failed transaction. (e) Blocks of precompile calls
under the execution shards and under Block-STM land the serial receipts
and root; every shard worker's pong says CUDA was never initialised, and
Block-STM's threads reach the seam one dispatch at a time.

Blocks are built once by the reference's generate_chain (transactions
signed once with its signer) and decoded into the port; the calls go
through a forwarder contract that STATICCALLs the precompile with its
calldata and stores keccak256 of the return data in a slot of its own per
call, so every digest reaches the state root. Everything is compared
exactly."""

import dataclasses
import threading
import time
import types

import pytest

from coreth_tpu import params as jparams
from coreth_tpu import precompile as jprecompile
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.evm import evm as jevm
from coreth_tpu.precompile import tpu_keccak as jtk
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.state.statedb import StateDB as JStateDB
from coreth_tpu.trie.node import EMPTY_ROOT as J_EMPTY
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import fault, params, precompile
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.device import KernelLaunchError
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.evm import evm as pevm
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.ops import device as pdevice
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.ops.keccak_torch import default_batched_keccak
from coreth_tpu_torch.precompile import tpu_keccak as ptk
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.statedb import StateDB
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.triedb import TrieDatabase

CHAIN_ID = 43112
KEYS = [bytes([0x30 + i]) * 32 for i in range(6)]
ADDRS = [priv_to_address(k) for k in KEYS]
FUND = 10**21
# one forwarder per sender, so calls of one block do not conflict
FWD_ADDRS = [b"\xfd" * 19 + bytes([i + 1]) for i in range(len(KEYS))]
FWD_ADDR = FWD_ADDRS[0]


def forwarder_code(target: bytes) -> bytes:
    """STATICCALL `target` with the calldata; revert if it fails; else
    n = sload(0) + 1, sstore(0, n), sstore(n, keccak256(returndata))."""
    return bytes.fromhex(
        "366000600037"                  # calldatacopy(0, 0, calldatasize)
        "60006000366000"                # retSize retOff argsSize argsOff
        "73") + target + bytes.fromhex(
        "5afa"                          # gas staticcall
        "15603e57"                      # iszero -> jump 62 (revert)
        "3d600060003e"                  # returndatacopy(0, 0, rds)
        "3d600020"                      # keccak256(0, rds)
        "600054600101"                  # sload(0) + 1
        "8060005555"                    # sstore(0, n); sstore(n, h)
        "00"                            # stop
        "5b60006000fd")                 # 62: revert(0, 0)


FWD = forwarder_code(ptk.TPU_KECCAK_ADDR)


def encode_bytes_array(msgs) -> bytes:
    """ABI `bytes[]` (keccak256Batch's argument, selector not included)."""
    heads, tail = [], b""
    pos = 32 * len(msgs)
    for m in msgs:
        heads.append(pos.to_bytes(32, "big"))
        chunk = len(m).to_bytes(32, "big") + m + b"\x00" * (-len(m) % 32)
        tail += chunk
        pos += len(chunk)
    return ((32).to_bytes(32, "big") + len(msgs).to_bytes(32, "big")
            + b"".join(heads) + tail)


def batch_call(msgs) -> bytes:
    return precompile.function_selector("keccak256Batch(bytes[])") + \
        encode_bytes_array(msgs)


def messages(seed, n, size=40):
    return [keccak256(bytes([seed]) + i.to_bytes(4, "big")) * (size // 32)
            + bytes([i % 251]) * (size % 32) for i in range(n)]


@pytest.fixture(autouse=True)
def _isolation():
    yield
    fault.clear_all()
    pdevice.default_ladder().reset()


# ------------------------------------------------------ (a) the surface


def test_selectors_and_fork_transitions():
    for sig in ("keccak256Batch(bytes[])", "transfer(address,uint256)"):
        assert precompile.function_selector(sig) == \
            jprecompile.function_selector(sig)
    for bad in ("nope", "f(", "f)"):
        with pytest.raises(ValueError):
            precompile.function_selector(bad)
        with pytest.raises(ValueError):
            jprecompile.function_selector(bad)
    for fork in (None, 0, 5, 10, 11):
        for parent in (None, 0, 5, 10):
            for cur in (0, 5, 10, 20):
                assert precompile.is_fork_transition(fork, parent, cur) == \
                    jprecompile.is_fork_transition(fork, parent, cur)
    assert ptk.TPU_KECCAK_ADDR == jtk.TPU_KECCAK_ADDR
    assert (ptk.BATCH_BASE_GAS, ptk.MAX_BATCH_MESSAGES,
            ptk.DEVICE_THRESHOLD) == (jtk.BATCH_BASE_GAS,
                                      jtk.MAX_BATCH_MESSAGES,
                                      jtk.DEVICE_THRESHOLD)
    msgs = messages(1, 5)
    assert ptk.batch_gas(msgs) == jtk.batch_gas(msgs)
    assert ptk.encode_bytes32_array(msgs[:2]) == \
        jtk.encode_bytes32_array(msgs[:2])
    assert ptk.decode_bytes_array(encode_bytes_array(msgs)) == msgs


def _w(x):
    return x.to_bytes(32, "big")


_GOOD = batch_call(messages(2, 5, 70))
_ARGS = encode_bytes_array([b"abc", b"defg"])
_SEL = _GOOD[:4]
ABI_CASES = {
    "good": (_GOOD, 10**6),
    "empty-batch": (_SEL + encode_bytes_array([]), 10**6),
    "no-input": (b"", 10**6),
    "short-selector": (_SEL[:3], 10**6),
    "unknown-selector": (b"\x00\x00\x00\x00" + _ARGS, 10**6),
    "truncated": (_GOOD[:-10], 10**6),
    "truncated-head": (_SEL + b"\x00" * 20, 10**6),
    "count-over-max": (_SEL + _w(32) + _w(ptk.MAX_BATCH_MESSAGES + 1),
                       10**6),
    "count-past-end": (_SEL + _w(32) + _w(3) + _w(96), 10**6),
    "overlapping-offsets": (_SEL + _w(32) + _w(3) + _w(96) * 3 + _w(4)
                            + b"wxyz" + b"\x00" * 28, 10**6),
    "length-past-end": (_SEL + _w(32) + _w(1) + _w(32) + _w(10**9), 10**6),
    "head-past-end": (_SEL + _w(10**12), 10**6),
    "out-of-gas": (_GOOD, 2500),
    "exact-gas": (_GOOD, jtk.batch_gas(messages(2, 5, 70))),
}


def _outcome(contract, inp, gas):
    evm = types.SimpleNamespace(statedb=None)
    try:
        ret, left = contract.run(evm, b"\x01" * 20, ptk.TPU_KECCAK_ADDR, inp,
                                 gas, True)
        return ("ok", ret, left)
    except Exception as e:  # noqa: BLE001 — compared below
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("case", sorted(ABI_CASES))
def test_abi_scan_gas_and_errors_match_reference(case):
    inp, gas = ABI_CASES[case]
    want = _outcome(jtk.TpuKeccakConfig(timestamp=0).contract(), inp, gas)
    got = _outcome(ptk.TpuKeccakConfig(timestamp=0).contract(), inp, gas)
    assert got == want
    if case == "good":
        assert got[1] == ptk.encode_bytes32_array(
            [keccak256(m) for m in messages(2, 5, 70)])
    if case in ("exact-gas", "overlapping-offsets", "empty-batch"):
        assert got[0] == "ok"


# ------------------------------------------ (b) activation through blocks


def _configs(ts):
    return (dataclasses.replace(
        jparams.TEST_CHAIN_CONFIG,
        precompile_upgrades=(jtk.TpuKeccakConfig(timestamp=ts),)),
        dataclasses.replace(
            params.TEST_CHAIN_CONFIG,
            precompile_upgrades=(ptk.TpuKeccakConfig(timestamp=ts),)))


def _sign(nonce, key, to, data, bg, gas=400_000):
    tx = JTransaction(type=2, chain_id=CHAIN_ID, nonce=nonce,
                      max_fee=(bg.base_fee() or 225 * 10**9) * 2,
                      max_priority_fee=0, gas=gas, to=to, value=0, data=data)
    return JSigner(CHAIN_ID).sign(tx, key)


def _alloc(account):
    alloc = {a: account(balance=FUND) for a in ADDRS}
    for a in FWD_ADDRS:
        alloc[a] = account(balance=0, code=FWD)
    return alloc


def make_blocks(jcfg, n, calls_per_block, n_msgs=64):
    """n blocks from the corpus genesis, each with `calls_per_block` calls
    of n_msgs messages through the forwarder (one sender each)."""
    jdisk = JMemoryDB()
    maker = JDatabase(JTrieDatabase(jdisk))
    genesis = JGenesis(config=jcfg, gas_limit=jparams.CORTINA_GAS_LIMIT,
                       alloc=_alloc(JGenesisAccount)).commit(jdisk, maker)

    def gen(i, bg):
        for s in range(calls_per_block):
            bg.add_tx(_sign(i, KEYS[s], FWD_ADDRS[s],
                            batch_call(messages(16 * i + s, n_msgs)), bg))

    blocks, _ = j_generate_chain(jcfg, genesis, j_new_dummy_engine(), maker,
                                 n, gap=10, gen=gen)
    return genesis, blocks


def port_chain(pcfg, mode="batched", **knobs):
    disk = MemoryDB()
    return BlockChain(
        disk, CacheConfig(pruning=True, **knobs), pcfg,
        Genesis(config=pcfg, gas_limit=params.CORTINA_GAS_LIMIT,
                alloc=_alloc(GenesisAccount)),
        new_dummy_engine(), state_database=Database(TrieDatabase(
            disk, batch_keccak=get_batch_keccak(mode, "cpu"))),
        device="cpu")


def insert_all(chain, blocks):
    for b in blocks:
        chain.insert_block(Block.decode(b.encode()))
    if chain.pipeline is not None:
        chain.pipeline.drain()


def _receipts(chain, blocks):
    chain.join_tail()
    return [[r.encode() for r in chain.get_receipts(b.hash())]
            for b in blocks]


@pytest.mark.parametrize("ts", [0, 20])
def test_activation_gives_the_reference_roots(ts):
    """Activation at genesis, or at the second block (t = 20): the port's
    chain takes the reference's blocks (their header roots validate on
    insert) and holds the precompile's nonce and code from then on; a
    call before activation reaches an empty account (status 1, no digest
    stored)."""
    jcfg, pcfg = _configs(ts)
    genesis, blocks = make_blocks(jcfg, 3, 2)
    chain = port_chain(pcfg)
    assert chain.genesis_block.hash() == genesis.hash()
    insert_all(chain, blocks)
    assert chain.current_block.hash() == blocks[-1].hash()
    for i, b in enumerate([genesis] + blocks):
        st = chain.state_at(b.root)
        active = b.time >= ts
        assert st.get_nonce(ptk.TPU_KECCAK_ADDR) == (1 if active else 0)
        assert st.get_code(ptk.TPU_KECCAK_ADDR) == \
            (b"\x01" if active else b"")
        for s in range(2 if i else 0):
            ret = ptk.encode_bytes32_array([
                keccak256(m) for m in messages(16 * (i - 1) + s, 64)]) \
                if active else b""
            assert st.get_state(FWD_ADDRS[s], i.to_bytes(32, "big")) == \
                keccak256(ret)
    assert all(r.status == 1 for b in blocks
               for r in chain.get_receipts(b.hash()))
    chain.stop()


# ------------------------------------------------- (c) through both EVMs


def _evm_pair(n_msgs, mode):
    jcfg, pcfg = _configs(0)
    hdr = types.SimpleNamespace(time=0)
    jsdb = JStateDB(J_EMPTY, JDatabase(JTrieDatabase(JMemoryDB())))
    psdb = StateDB(EMPTY_ROOT, Database(TrieDatabase(
        MemoryDB(), batch_keccak=get_batch_keccak(mode, "cpu"))))
    for sdb, cfg in ((jsdb, jcfg), (psdb, pcfg)):
        cfg.check_configure_precompiles(None, hdr, sdb)
        sdb.set_code(FWD_ADDR, FWD)
        sdb.add_balance(ADDRS[0], FUND)
    j = jevm.EVM(jevm.BlockContext(block_number=1, time=10), jevm.TxContext(),
                 jsdb, jcfg)
    p = pevm.EVM(pevm.BlockContext(block_number=1, time=10), pevm.TxContext(),
                 psdb, pcfg)
    return j, p


@pytest.mark.parametrize("mode,n_msgs", [("batched", 64), ("planned", 100),
                                         ("batched", 63), ("off", 64)])
def test_evm_call_matches_reference_and_uses_the_seam(mode, n_msgs):
    j, p = _evm_pair(n_msgs, mode)
    bk = default_batched_keccak("cpu")
    calls = bk.calls
    inp = batch_call(messages(9, n_msgs, 200))
    for to in (ptk.TPU_KECCAK_ADDR, FWD_ADDR):
        jr = j.call(ADDRS[0], to, inp, 3_000_000, 0)
        pr = p.call(ADDRS[0], to, inp, 3_000_000, 0)
        assert pr[:2] == jr[:2] and pr[2] is None and jr[2] is None
    assert pr[0] == b"" and jr[0] == b""
    want = ptk.encode_bytes32_array([keccak256(m) for m in
                                     messages(9, n_msgs, 200)])
    assert p.call(ADDRS[0], ptk.TPU_KECCAK_ADDR, inp, 3_000_000, 0)[0] \
        == want
    assert p.statedb.intermediate_root(True) == \
        j.statedb.intermediate_root(True)
    used = 3 if mode != "off" and n_msgs >= ptk.DEVICE_THRESHOLD else 0
    assert bk.calls - calls == used


# --------------------------------------------- (d) the port's device rule


@pytest.mark.parametrize("kind", ["launch", "wedge"])
def test_device_error_surfaces_from_insert_block(kind, monkeypatch):
    """The seam fails during the precompile call of block 2 (K2 raises
    KernelLaunchError, or the dispatch hangs past the ladder's watchdog):
    insert_block raises that error itself (no ProcessorError, no receipt
    with status 0, no bad block, no host re-hash, no demotion) and the
    head stays; the retried insert lands the reference's block."""
    from coreth_tpu_torch.device import DeviceWedgedError

    jcfg, pcfg = _configs(0)
    _genesis, blocks = make_blocks(jcfg, 2, 1)
    chain = port_chain(pcfg)
    chain.insert_block(Block.decode(blocks[0].encode()))
    head = chain.current_block.hash()
    lad = pdevice.default_ladder()
    if kind == "launch":
        bk = default_batched_keccak("cpu")

        def boom(*a):
            raise KernelLaunchError("keccak_blocks: launch failed")
        monkeypatch.setattr(bk, "impl", boom)
        want = KernelLaunchError
    else:
        lad.configure(call_timeout=0.2)
        fault.set_failpoint("ops/device/dispatch", "hang")
        want = DeviceWedgedError
    b2 = Block.decode(blocks[1].encode())
    with pytest.raises(want):
        chain.insert_block(b2)
    assert chain.current_block.hash() == head
    assert not chain.bad_blocks and lad.healthy
    monkeypatch.undo()
    fault.clear_all()
    chain.insert_block(b2)
    assert chain.current_block.hash() == blocks[1].hash()
    assert [r.status for r in chain.get_receipts(b2.hash())] == [1]
    chain.stop()


# ------------------------------------- (e) shards and Block-STM threads


def test_shards_and_block_stm_land_the_serial_block(monkeypatch):
    jcfg, pcfg = _configs(0)
    _genesis, blocks = make_blocks(jcfg, 2, 6, n_msgs=64)
    serial = port_chain(pcfg)
    insert_all(serial, blocks)
    want = _receipts(serial, blocks)
    serial.stop()

    shards = port_chain(pcfg, evm_exec_shards=2)
    insert_all(shards, blocks)
    assert shards.processor.last_parallel["mode"] == "shards"
    assert _receipts(shards, blocks) == want
    pongs = shards.processor.shard_pool().ping()
    assert len(pongs) == 2
    for pong in pongs:
        assert pong[0] == "pong" and pong[4] is False and pong[5] == []
    shards.stop()

    # Block-STM: the threads' seam calls go through one dispatch at a time
    bk = default_batched_keccak("cpu")
    real = bk.digests
    state = {"now": 0, "max": 0, "calls": 0}
    mu = threading.Lock()

    def digests(msgs):
        with mu:
            state["now"] += 1
            state["calls"] += 1
            state["max"] = max(state["max"], state["now"])
        time.sleep(0.01)
        try:
            return real(msgs)
        finally:
            with mu:
                state["now"] -= 1

    monkeypatch.setattr(bk, "digests", digests)
    stm = port_chain(pcfg, evm_parallel_workers=4)
    insert_all(stm, blocks)
    assert stm.processor.last_parallel["mode"] == "parallel"
    assert _receipts(stm, blocks) == want
    assert state["calls"] >= 12 and state["max"] == 1
    stm.stop()


# ------------------------- (f) the VM with the shadow and the precompile


def test_vm_with_shadow_and_precompile_matches_reference(monkeypatch):
    """VM.initialize from the JSON config with the bintrie shadow, on a
    genesis whose config enables the precompile, in both packages: the
    same block through issue, build, verify and accept, the same shadow
    roots. Then the port's seam fails in build_block: the error itself
    reaches the caller, the head stays, and the next build lands the
    transaction."""
    import json

    from coreth_tpu.vm.shared_memory import Memory as JMemory
    from coreth_tpu.vm.vm import VM as JVM
    from coreth_tpu.vm.vm import SnowContext as JSnowContext
    from coreth_tpu_torch.core.types import Transaction
    from coreth_tpu_torch.vm.shared_memory import Memory
    from coreth_tpu_torch.vm.vm import VM, SnowContext

    jcfg, pcfg = _configs(0)
    blob = json.dumps({"state-backend": "bintrie-shadow",
                       "shadow-check-interval": 2}).encode()
    jvm, pvm = JVM(), VM()
    jvm.initialize(JSnowContext(shared_memory=JMemory()), JMemoryDB(),
                   JGenesis(config=jcfg, gas_limit=jparams.CORTINA_GAS_LIMIT,
                            alloc=_alloc(JGenesisAccount)),
                   config_bytes=blob)
    pvm.initialize(SnowContext(shared_memory=Memory()), MemoryDB(),
                   Genesis(config=pcfg, gas_limit=params.CORTINA_GAS_LIMIT,
                           alloc=_alloc(GenesisAccount)),
                   config_bytes=blob, device="cpu")
    vms = (jvm, pvm)
    for vm in vms:
        vm.miner.clock = (lambda vm=vm: vm.blockchain.current_block.time
                          + 10)

    def tx(nonce):
        t = JTransaction(type=2, chain_id=CHAIN_ID, nonce=nonce,
                         max_fee=10**12, max_priority_fee=10**9,
                         gas=400_000, to=FWD_ADDR, value=0,
                         data=batch_call(messages(40 + nonce, 80)))
        jt = JSigner(CHAIN_ID).sign(t, KEYS[0])
        return jt, Transaction.decode(jt.encode())

    def block(pair):
        for vm, t in zip(vms, pair):
            vm.issue_tx(t)
        blks = [vm.build_block() for vm in vms]
        assert blks[1].bytes() == blks[0].bytes()
        for vm, b in zip(vms, blks):
            b.verify()
            vm.set_preference(b.id())
            b.accept()
            vm.blockchain.drain_acceptor_queue()
        return blks[1]

    block(tx(0))
    jsh, psh = (vm.blockchain.state_database.shadow for vm in vms)
    head = pvm.blockchain.current_block
    assert psh.root_for(head.root) == jsh.root_for(head.root) is not None
    assert psh.status() == jsh.status() and not psh.quarantined

    second = tx(1)
    pvm.issue_tx(second[1])
    bk = default_batched_keccak("cpu")

    def boom(*a):
        raise KernelLaunchError("keccak_blocks: launch failed")
    monkeypatch.setattr(bk, "impl", boom)
    with pytest.raises(KernelLaunchError):
        pvm.build_block()
    assert pvm.blockchain.current_block.hash() == head.hash()
    assert pvm.last_accepted().id() == head.hash()
    monkeypatch.undo()
    jvm.issue_tx(second[0])
    blks = [vm.build_block() for vm in vms]
    assert blks[1].bytes() == blks[0].bytes()
    for vm in vms:
        vm.shutdown()
