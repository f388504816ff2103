"""The port's VM block phases and the flight record's run key, on the
CPU: the vm/phase/* registry timers (vm/vm.py, vm/block.py) cover a VM
block's issue, build, verify and accept calls; a built block leaves one
flight record for each of its three runs (build, the check insert,
verify), in that order; pipelined and failed inserts carry the key."""

import time

import pytest

from coreth_tpu_torch import fault, metrics, params
from coreth_tpu_torch.core.blockchain import ChainError
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block, Signer, Transaction
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.ops import device as pdevice
from coreth_tpu_torch.vm.shared_memory import Memory
from coreth_tpu_torch.vm.vm import VM, SnowContext, VMConfig
from tests.torch_exec_twin import _disjoint, decoded, make_blocks, \
    port_chain

KEY = b"\x21" * 32
DEST = b"\xcd" * 20
PHASES = ("issue", "build", "verify", "accept")


@pytest.fixture(autouse=True)
def _port_isolation():
    """The port's ladder and failpoints are process-global."""
    yield
    fault.clear_all()
    pdevice.default_ladder().reset()


@pytest.fixture
def vm():
    v = VM()
    gen = Genesis(config=params.TEST_CHAIN_CONFIG,
                  gas_limit=params.CORTINA_GAS_LIMIT,
                  alloc={priv_to_address(KEY): GenesisAccount(
                      balance=10**24)})
    v.initialize(SnowContext(shared_memory=Memory()), MemoryDB(), gen,
                 VMConfig(clock=lambda: v.blockchain.current_block.time + 10),
                 device="cpu")
    yield v
    v.shutdown()


def transfers(n):
    signer = Signer(params.TEST_CHAIN_CONFIG.chain_id)
    return [Transaction.decode(signer.sign(Transaction(
        type=2, nonce=i, max_fee=10**12, max_priority_fee=0, gas=21000,
        to=DEST, value=i + 1), KEY).encode()) for i in range(n)]


def totals():
    return {p: metrics.default_registry.timer("vm/phase/" + p).total()
            for p in PHASES}


def test_vm_phases_cover_a_block(vm):
    """Each phase's time in a block is the call's wall time, but for the
    call itself: the phases tile the block's four steps."""
    txs = transfers(8)
    before = totals()
    t0 = time.perf_counter()
    for tx in txs:
        vm.issue_tx(tx)
    t1 = time.perf_counter()
    blk = vm.build_block()
    t2 = time.perf_counter()
    blk.verify()
    t3 = time.perf_counter()
    vm.set_preference(blk.id())
    t4 = time.perf_counter()
    blk.accept()
    t5 = time.perf_counter()
    vm.blockchain.drain_acceptor_queue()
    wall = dict(issue=t1 - t0, build=t2 - t1, verify=t3 - t2,
                accept=t5 - t4)
    after = totals()
    for p in PHASES:
        got = after[p] - before[p]
        assert 0 < got <= wall[p], (p, got, wall[p])
        # the phase leaves out only the call and the loop around it: a
        # few microseconds a call (the accept lasts tens of them here),
        # more when a busy host preempts the test
        assert wall[p] - got <= max(0.2 * wall[p], 0.005), \
            (p, got, wall[p])
    assert len(blk.eth_block.transactions) == len(txs)


def test_flight_records_name_a_built_blocks_runs(vm):
    """A block the VM builds runs its transactions three times: the
    miner's build, the check insert (writes=False) and the verify insert,
    each a record under the block's hash, in that order; find() gives the
    verify run's, which accept marks."""
    for tx in transfers(3):
        vm.issue_tx(tx)
    blk = vm.build_block()
    blk.verify()
    vm.set_preference(blk.id())
    blk.accept()
    vm.blockchain.drain_acceptor_queue()
    rec = vm.blockchain.flight_recorder
    runs = [r for r in rec.last() if r["hash"] == blk.id()]
    assert [r["run"] for r in runs] == ["build", "insert", "verify"]
    assert [r["writes"] for r in runs] == [False, False, True]
    assert sorted(runs[0]["phases"]) == ["commit", "execute", "finalize"]
    assert {"execute", "validate"} <= set(runs[1]["phases"])
    assert {"execute", "validate", "commit"} <= set(runs[2]["phases"])
    assert all(r["txs"] == 3 and r["gas_used"] == 3 * 21000 for r in runs)
    assert rec.find(blk.id()) is runs[2]
    assert [r["accepted"] for r in runs] == [False, False, True]
    assert rec.last(accepted_only=True)[-1] is runs[2]


def test_flight_run_key_on_pipelined_inserts():
    blocks = make_blocks(3, _disjoint)
    chain = port_chain(insert_pipeline_depth=2)
    try:
        blocks = decoded(chain, blocks)
        for b in blocks:
            chain.insert_block(b)
        chain.pipeline.drain()
        recs = [chain.flight_recorder.find(b.hash()) for b in blocks]
        assert [r["run"] for r in recs] == ["verify"] * 3
        assert all(r["pipeline"]["depth"] == 2 for r in recs)
    finally:
        chain.stop()


@pytest.mark.parametrize("writes", [True, False])
def test_flight_run_key_on_failed_inserts(writes):
    """A block whose header root is not its state's fails to insert; its
    record, kept with the bad block, says which run failed."""
    good = make_blocks(1, _disjoint)
    chain = port_chain()
    try:
        b = decoded(chain, good)[0]
        header = b.header.copy()
        header.root = b"\x13" * 32
        bad = Block(header, b.transactions, b.uncles, b.version, b.ext_data)
        with pytest.raises(ChainError, match="root"):
            chain.insert_block_manual(bad, writes)
        block, _why, rec = chain.bad_blocks[-1]
        assert block.hash() == bad.hash()
        assert rec["run"] == ("verify" if writes else "insert")
        assert chain.flight_recorder.find(bad.hash()) is None
    finally:
        chain.stop()
