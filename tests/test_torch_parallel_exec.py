"""The port's thread-parallel Block-STM executor (core/parallel_exec.py,
core/mvcc.py, StateDB.fold_tx_writes) against the JAX package's, on the
CPU: the cases of tests/test_parallel_exec.py.

Every corpus is built once by the reference's generate_chain (its serial
loop stamps the headers; tests/torch_exec_twin.py). A reference chain
runs its serial loop; the port's chain runs the mode, so its inserts
validate the folded write-sets against the serial headers (gas, bloom,
receipt root, intermediate_root) and its commits against them (commit
root). Then both must hold the same blocks, receipts (RLP), logs, gas and
head, and the port's store must sit within the reference's. Where the
outcome of the mode is deterministic (one worker, conflict-free blocks,
the fallbacks) the reference also runs the mode and the flight records'
`parallel` fields must be equal.
"""

import random

import pytest

from coreth_tpu.core import parallel_exec as jparallel_exec
from coreth_tpu.core.mvcc import _VersionedTable as JVersionedTable
from coreth_tpu.core.mvcc import _WriteSet as JWriteSet
from coreth_tpu.metrics import default_registry as j_registry
from coreth_tpu.state.log import Log as JLog
from coreth_tpu_torch.core import parallel_exec
from coreth_tpu_torch.core.mvcc import _VersionedTable, _WriteSet
from coreth_tpu_torch.metrics import default_registry
from coreth_tpu_torch.state.log import Log

from torch_exec_twin import (
    ADDRS, COUNTER_ADDR, SD_ADDR, compare_stores, corpus, port_chain,
    records, ref_chain, run, signature)


def _counts(name):
    return (j_registry.counter(name).count(),
            default_registry.counter(name).count())


def _twin(name, **knobs):
    """The reference's serial chain and the port's chain in `knobs`'s
    mode over corpus `name`; their blocks, receipts, logs and head are
    equal."""
    blocks = corpus(name)
    ref = run(ref_chain(), blocks)
    port = run(port_chain(**knobs), blocks)
    assert signature(port, blocks) == signature(ref, blocks)
    return ref, port, blocks


@pytest.mark.parametrize("workers", [0, 1, 2, 4])
def test_disjoint_transfers_bit_exact(workers):
    """Conflict-free transfer blocks: the parallel commit lands the serial
    headers at every worker count, with zero conflicts and re-executions,
    and the same flight record as the reference's mode."""
    ref, port, blocks = _twin("disjoint", evm_parallel_workers=workers)
    jmode = run(ref_chain(evm_parallel_workers=workers), blocks)
    got = [r["parallel"] for r in records(port, blocks)]
    assert got == [r["parallel"] for r in records(jmode, blocks)]
    if workers == 0:
        assert got == [{"mode": "serial"}] * len(blocks)
    else:
        for stats in got:
            assert stats["mode"] == "parallel"
            assert stats["conflicts"] == stats["reexecs"] == 0
            assert stats["workers"] == min(workers, 12)
    jmode.stop()
    compare_stores(ref, port)


@pytest.mark.parametrize("workers", [1, 2, 4, 8])
def test_conflicting_block_bit_exact(workers):
    """Shared-slot contract calls, a selfdestruct and a re-fund of the
    corpse, a deployment and transfers: whatever the interleaving, the
    fold lands the serial roots; the port's serial state reads back the
    same slots and accounts as the reference's."""
    ref, port, blocks = _twin("conflict", evm_parallel_workers=workers)
    stats = port.processor.last_parallel
    if workers == 1:
        # one worker executes in ascending tx order: no aborts, and the
        # reference's mode gives the very same record
        assert stats["mode"] == "parallel" and stats["conflicts"] == 0
        jmode = run(ref_chain(evm_parallel_workers=1), blocks)
        assert [r["parallel"] for r in records(port, blocks)] == \
            [r["parallel"] for r in records(jmode, blocks)]
        jmode.stop()
    else:
        # an unlucky interleaving may cascade re-execs past the budget:
        # the fallback is the designed response
        assert stats["fallback"] is (stats["mode"] == "serial")
    sp, sr = port.state(), ref.state()
    for a in (COUNTER_ADDR, SD_ADDR) + tuple(ADDRS[:8]):
        assert sp.get_balance(a) == sr.get_balance(a)
        assert sp.get_nonce(a) == sr.get_nonce(a)
        assert sp.get_code(a) == sr.get_code(a)
    for slot in range(2):
        k = slot.to_bytes(32, "big")
        assert sp.get_state(COUNTER_ADDR, k) == sr.get_state(COUNTER_ADDR, k)
    compare_stores(ref, port)


@pytest.mark.parametrize("name,counter", [
    ("all_conflict", "exec/parallel/fallbacks"),
    ("coinbase", "exec/parallel/fallbacks"),
])
def test_serial_shaped_blocks_fall_back(name, counter):
    """Eight txs of one sender (every tx depends on the one before), and a
    call that reads the fee recipient (its balance exists only as
    per-tx deltas): both packages detect the serial shape, count one
    fallback each and commit through the serial loop."""
    before = _counts(counter)
    ref, port, blocks = _twin(name, evm_parallel_workers=4)
    jmode = run(ref_chain(evm_parallel_workers=4), blocks)
    after = _counts(counter)
    assert after[1] == before[1] + len(blocks)
    assert after[0] == before[0] + len(blocks)
    # which trigger fires first (the re-execution budget or the conflict
    # rate) depends on the interleaving; the verdict does not
    keys = ("mode", "workers", "fallback")
    got = [{k: r["parallel"][k] for k in keys} for r in records(port, blocks)]
    assert got == [{k: r["parallel"][k] for k in keys}
                   for r in records(jmode, blocks)]
    assert got == [{"mode": "serial", "workers": 4, "fallback": True}] * \
        len(blocks)
    jmode.stop()
    compare_stores(ref, port)


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("workers", [2, 8])
def test_fuzz_shared_account_transfers(workers, seed):
    """Randomized transfers among the senders: validation and
    re-execution fire nondeterministically, the fold stays bit-exact."""
    ref, port, blocks = _twin(f"fuzz{seed}", evm_parallel_workers=workers)
    assert port.current_block.number == len(blocks)
    compare_stores(ref, port)


def test_effective_workers_precedence(monkeypatch):
    """CORETH_TPU_EVM_PARALLEL over the knob, junk falling through, values
    clamped: the port's effective_workers equals the reference's on every
    row."""
    rows = [(None, 0), (None, None), (None, 5), (None, 1000), ("3", 0),
            ("0", 8), ("notanint", 2), ("999", 0), ("-2", 4)]
    for env, cfg in rows:
        if env is None:
            monkeypatch.delenv(parallel_exec.PARALLEL_ENV, raising=False)
        else:
            monkeypatch.setenv(parallel_exec.PARALLEL_ENV, env)
        got = parallel_exec.effective_workers(cfg)
        assert got == jparallel_exec.effective_workers(cfg), (env, cfg)
    assert parallel_exec.MAX_WORKERS == jparallel_exec.MAX_WORKERS
    assert parallel_exec.MIN_PARALLEL_TXS == jparallel_exec.MIN_PARALLEL_TXS


def test_env_knob_reaches_processor(monkeypatch):
    """The env override flips a CacheConfig(0) chain into parallel mode
    block by block, without a restart."""
    monkeypatch.setenv(parallel_exec.PARALLEL_ENV, "2")
    ref, port, blocks = _twin("disjoint")
    assert [r["parallel"]["mode"] for r in records(port, blocks)] == \
        ["parallel"] * len(blocks)
    compare_stores(ref, port)


def _plain(resolutions):
    """(value, version) pairs with each package's miss sentinel named."""
    return [("miss" if type(v) is object else v, ver)
            for v, ver in resolutions]


def test_versioned_table_matches_reference():
    """core/mvcc.py's multi-version table: a seeded sequence of publishes
    (write-sets with accounts, slots, deletions and barriers, stale
    incarnations, failed ones) gives the reference's read resolutions and
    validation verdicts at every step."""
    rng = random.Random(5)
    addrs = [bytes([a]) * 20 for a in range(4)]
    keys = [bytes([k]) * 32 for k in range(3)]
    port, ref = _VersionedTable(), JVersionedTable()
    reads = []
    for step in range(300):
        i, inc = rng.randrange(8), rng.randrange(3)
        if rng.random() < 0.15:
            parts = None
        else:
            accts = {a: (rng.randrange(3), rng.randrange(5), b"\x01" * 32,
                         None, False, False, False) if rng.random() < 0.8
                     else None for a in rng.sample(addrs, 2)}
            slots = {(rng.choice(addrs), rng.choice(keys)):
                     bytes([rng.randrange(256)]) * 32 for _ in range(2)}
            barriers = [a for a in addrs if rng.random() < 0.1]
            parts = (accts, slots, barriers, [], {}, 0)
        for table, ws_type in ((port, _WriteSet), (ref, JWriteSet)):
            table.publish(i, inc, None if parts is None else ws_type(*parts))
        j = rng.randrange(9)
        a, k = rng.choice(addrs), rng.choice(keys)
        got = (port.read_account(j, a), port.read_slot(j, a, k))
        want = (ref.read_account(j, a), ref.read_slot(j, a, k))
        assert _plain(got) == _plain(want), step
        reads.append((j, {("a", a): got[0][1], ("s", a, k): got[1][1]}))
        j, rs = rng.choice(reads)
        assert port.validate(j, rs) == ref.validate(j, rs), step


def test_fold_tx_writes_matches_reference():
    """StateDB.fold_tx_writes over the corpus genesis in both packages: a
    deletion of a live contract, a (re)created account with code and
    storage, a plain update, slot writes, a coinbase fee and two logs
    give the same logs, intermediate_root and commit root."""
    ref, port = ref_chain(), port_chain()
    coinbase = b"\x01" + b"\x00" * 19
    fresh = b"\xfe" * 20
    code = b"\x60\x01\x00"
    from coreth_tpu_torch.native import keccak256

    accounts = {
        SD_ADDR: None,
        fresh: (1, 10**9, keccak256(code), code, True, False, True),
        ADDRS[0]: (3, 12345, keccak256(b""), None, False, False, False),
        COUNTER_ADDR: (0, 0, keccak256(b"\x00"), None, False, False, False),
    }
    storage = {(fresh, b"\x00" * 31 + b"\x01"): b"\x00" * 31 + b"\x07",
               (COUNTER_ADDR, b"\x00" * 32): b"\x00" * 31 + b"\x09"}
    roots = []
    for chain, log_type in ((ref, JLog), (port, Log)):
        sdb = chain.state()
        sdb.finalise(True)
        accts = dict(accounts)
        accts[COUNTER_ADDR] = (0, 0, sdb.get_code_hash(COUNTER_ADDR), None,
                               False, False, False)
        logs = [log_type(fresh, [b"\x02" * 32], b"hi"),
                log_type(COUNTER_ADDR, [], b"")]
        sdb.fold_tx_writes(b"\xaa" * 32, 3, accts, storage, logs,
                           {b"\x05" * 32: b"pre"}, coinbase, 777)
        got = [(lg.address, lg.topics, lg.data, lg.tx_hash, lg.tx_index,
                lg.index) for lg in sdb.get_logs(b"\xaa" * 32, 1, b"\x0b" * 32)]
        roots.append((got, sdb.intermediate_root(True), sdb.commit(True),
                      sdb.preimages))
    assert roots[0] == roots[1]
    ref.stop()
    port.stop()


@pytest.mark.parametrize("mode", ["parallel", "shards"])
def test_device_fault_in_a_speculative_mode_reaches_the_caller(
        mode, monkeypatch):
    """A device fault inside a speculative mode is not a failed
    speculation: insert_block raises it with the head unchanged, no
    fallback and no bad block counted, and the block is not re-run
    serially. Once the fault is gone the block lands the serial root."""
    from coreth_tpu_torch.core import exec_shards
    from coreth_tpu_torch.core.types import Block
    from coreth_tpu_torch.device import DeviceWedgedError

    module, name, knob, counter = {
        "parallel": (parallel_exec, "execute_block", "evm_parallel_workers",
                     "exec/parallel/fallbacks"),
        "shards": (exec_shards, "execute_block_sharded", "evm_exec_shards",
                   "exec/shard/fallbacks"),
    }[mode]

    def wedged(*a, **kw):
        raise DeviceWedgedError("the device stopped answering")

    from coreth_tpu_torch.core import state_processor

    block = corpus("disjoint")[0]
    port = port_chain(**{knob: 2})
    serial = []
    apply = state_processor.apply_transaction

    def counted(*a, **kw):
        serial.append(1)
        return apply(*a, **kw)

    monkeypatch.setattr(module, name, wedged)
    monkeypatch.setattr(state_processor, "apply_transaction", counted)
    before = default_registry.counter(counter).count()
    pb = Block.decode(block.encode())
    with pytest.raises(DeviceWedgedError):
        port.insert_block(pb)
    assert port.current_block.number == 0
    assert not port.bad_blocks and not serial
    assert default_registry.counter(counter).count() == before
    monkeypatch.undo()
    port.insert_block(pb)
    assert port.processor.last_parallel["mode"] == mode
    assert port.current_block.root == block.header.root
    port.stop()


@pytest.mark.parametrize("mode", ["parallel", "shards"])
def test_device_fault_in_a_base_read_reaches_the_caller(mode, monkeypatch):
    """A base read that reaches the device and fails (the port's mirror
    commits on a snapshot miss), on a worker thread of the thread mode
    or on the parent thread serving a shard worker's read: insert_block
    raises it with the head unchanged, no fallback, speculative error,
    shard crash or bad block is counted, and no tx runs serially. A shard
    worker left waiting for the read's answer is respawned; the retried
    insert runs the mode (the thread mode on one worker, so that no
    interleaving makes it fall back) and lands the serial root."""
    from coreth_tpu_torch.core import mvcc, state_processor
    from coreth_tpu_torch.core.types import Block
    from coreth_tpu_torch.device import DeviceWedgedError

    knobs = {"parallel": {"evm_parallel_workers": 4},
             "shards": {"evm_exec_shards": 2}}[mode]
    names = ("exec/parallel/fallbacks", "exec/parallel/speculative_errors",
             "exec/shard/fallbacks", "exec/shard/crashes",
             "exec/shard/demotions")
    block = corpus("conflict")[0]
    port = port_chain(**knobs)
    serial = []
    apply = state_processor.apply_transaction

    def counted(*a, **kw):
        serial.append(1)
        return apply(*a, **kw)

    def wedged(self, addr):
        raise DeviceWedgedError("the device stopped answering")

    monkeypatch.setattr(mvcc._BaseReader, "code", wedged)
    monkeypatch.setattr(state_processor, "apply_transaction", counted)
    before = {n: default_registry.counter(n).count() for n in names}
    respawns = default_registry.counter("exec/shard/respawns").count()
    pb = Block.decode(block.encode())
    with pytest.raises(DeviceWedgedError):
        port.insert_block(pb)
    assert port.current_block.number == 0
    assert not port.bad_blocks and not serial
    assert {n: default_registry.counter(n).count() for n in names} == before
    if mode == "shards":
        assert default_registry.counter("exec/shard/respawns").count() \
            > respawns
    monkeypatch.undo()
    if mode == "parallel":
        # one worker runs the txs in order: four may cascade re-execs on
        # this corpus past the budget and fall back, as the interleaving
        # falls (test_conflicting_block_bit_exact)
        monkeypatch.setenv("CORETH_TPU_EVM_PARALLEL", "1")
    port.insert_block(pb)
    assert port.processor.last_parallel["mode"] == mode
    assert port.current_block.root == block.header.root
    port.stop()
