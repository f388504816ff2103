"""The port's staged insert pipeline (core/insert_pipeline.py and its
wiring in core/blockchain.py) against the JAX package's, on the CPU: the
cases of tests/test_insert_pipeline.py.

The corpora are built once by the reference's generate_chain (its serial
loop stamps the headers; tests/torch_exec_twin.py). A reference chain
runs its serial insert path; the port's chain inserts through the
pipeline at depth 1, 2 and 3, so every committed block validated against
the serial header; both must then hold the same blocks, receipts (RLP),
logs, gas and head, and the port's store must sit within the
reference's. The reference's own pipeline runs where its records are
compared (mode, depth, the `parallel` stamp).

Beside the reference's drills (submit- and commit-stage failpoints, the
in-flight records, drains at accept and reject, the sender cacher's
per-batch waits, the knobs, a SIGKILLed child whose tail FIFO carries two
pipelined blocks — over a test-local store that appends every write to a
file, the port having no SQLite store): the port's device-fault rule (a
DeviceWedgedError in the commit stage's validate surfaces at the next
drain with the head unchanged, is never re-run serially and never counts
as a speculation fallback; one in a speculative base read raises from
insert_block and never counts as a speculation abort) and the resident
mirror committing pipelined
blocks to the reference mirror chain's roots.
"""

import os
import subprocess
import sys
import threading
import time

import pytest

from coreth_tpu.metrics import default_registry as j_registry
from coreth_tpu_torch import fault, params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core import rawdb
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.insert_pipeline import InsertPipeline
from coreth_tpu_torch.core.sender_cacher import TxSenderCacher
from coreth_tpu_torch.core.types import Signer, Transaction
from coreth_tpu_torch.device import DeviceWedgedError
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.fault import FailpointError
from coreth_tpu_torch.metrics import default_registry

from torch_exec_twin import (
    ADDRS, CHAIN_ID, EXTRA, FUND, compare_stores, corpus, decoded,
    port_chain, records, ref_chain, run, signature)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.clear_all()


def _counter(name):
    return default_registry.counter(name).count()


def _pipelined(name, depth, **knobs):
    """The reference's serial chain and the port's pipelined one over
    corpus `name`, compared."""
    blocks = corpus(name)
    ref = run(ref_chain(), blocks)
    port = run(port_chain(insert_pipeline_depth=depth, **knobs), blocks)
    assert signature(port, blocks) == signature(ref, blocks)
    return ref, port, blocks


# ------------------------------------------------- determinism sweep

@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_sweep_conflict_corpus(depth):
    """Bit-exact blocks, receipts, logs and head at every depth against
    the serial chain, with the pipeline speculating (not silently falling
    back): at most the first block commits serially."""
    ref, port, blocks = _pipelined("cross", depth)
    modes = [r["pipeline"]["mode"] for r in records(port, blocks)]
    assert modes.count("spec") >= len(blocks) - 1, modes
    compare_stores(ref, port)


@pytest.mark.parametrize("seed", [1234, 99])
def test_seeded_fuzz_parity(seed):
    for depth in (1, 2, 3):
        ref, port, _ = _pipelined(f"cross{seed}", depth)
        compare_stores(ref, port)


def test_flight_records_match_reference_pipeline():
    """Depth 2 in both packages: every record carries the pipeline stamp
    and the same keys, phases, `parallel` stamp, depth and mode as the
    reference's."""
    ref, port, blocks = _pipelined("cross", 2)
    jpipe = run(ref_chain(insert_pipeline_depth=2), blocks)
    for got, want in zip(records(port, blocks), records(jpipe, blocks)):
        assert sorted(got) == sorted(want)
        assert sorted(got["phases"]) == sorted(want["phases"])
        assert got["parallel"] == want["parallel"]
        pipe = got["pipeline"]
        assert (pipe["depth"], pipe["mode"]) == \
            (want["pipeline"]["depth"], want["pipeline"]["mode"])
        assert pipe["mode"] in ("spec", "serial-fallback")
        assert 0.0 <= pipe["overlap_fraction"] <= 1.0
    jpipe.stop()
    compare_stores(ref, port)


def test_coinbase_read_aborts_speculation():
    """A block with a call reading the fee recipient: the submit stage's
    speculation aborts and the commit stage runs the serial loop, in both
    packages ("serial-fallback", one spec abort each)."""
    before = (j_registry.counter("chain/pipeline/spec_aborts").count(),
              _counter("chain/pipeline/spec_aborts"))
    ref, port, blocks = _pipelined("coinbase", 2)
    jpipe = run(ref_chain(insert_pipeline_depth=2), blocks)
    assert records(port, blocks)[0]["pipeline"]["mode"] == \
        records(jpipe, blocks)[0]["pipeline"]["mode"] == "serial-fallback"
    assert j_registry.counter("chain/pipeline/spec_aborts").count() == \
        before[0] + 1
    assert _counter("chain/pipeline/spec_aborts") == before[1] + 1
    jpipe.stop()
    compare_stores(ref, port)


# ------------------------------------------------- failpoint drills

def _parity_after(blocks, chain):
    ref = run(ref_chain(), blocks, accept=False)
    assert signature(chain, blocks) == signature(ref, blocks)
    ref.stop()
    chain.stop()


@pytest.mark.parametrize("fp", ["insert/before_recover",
                                "insert/before_execute"])
def test_submit_stage_failure_surfaces_on_insert(fp):
    """Submit-stage failpoints fire on the caller thread, so the failure
    surfaces from insert_block itself; disarm and reinsert is bit-exact."""
    blocks = corpus("cross")[:3]
    chain = port_chain(insert_pipeline_depth=2)
    pb = decoded(chain, blocks)
    chain.insert_block(pb[0])
    fault.set_failpoint(fp, "raise*1")
    with pytest.raises(FailpointError):
        chain.insert_block(pb[1])
    fault.clear_all()
    chain.insert_block(pb[1])
    chain.insert_block(pb[2])
    chain.pipeline.drain()
    _parity_after(blocks, chain)


@pytest.mark.parametrize("fp", ["insert/before_commit",
                                "insert/before_write"])
def test_commit_stage_failure_surfaces_at_drain(fp):
    """Commit-stage failpoints fire in the worker: the error surfaces at
    the next drain point, the speculated successors are discarded, and
    reinsertion converges to the serial result."""
    blocks = corpus("cross")[:3]
    chain = port_chain(insert_pipeline_depth=2)
    pb = decoded(chain, blocks)
    fault.set_failpoint(fp, "raise*1")
    with pytest.raises(FailpointError):
        # the next submit or drain point, whichever the worker reaches
        for b in pb:
            chain.insert_block(b)
        chain.pipeline.drain()
    fault.clear_all()
    for b in pb:
        if not chain.has_block_and_state(b.hash(), b.number):
            chain.insert_block(b)
    chain.pipeline.drain()
    _parity_after(blocks, chain)


def test_poison_outlives_the_error_raised_at_submit():
    """Block 1's commit fails while block 2 is still queued behind it and
    the error surfaces at block 3's submit: block 2 is discarded under the
    poison before the error is raised, never committed over the parent
    that did not land (the reference commits it: "unknown ancestor", a
    bad block; ROADMAP Queue 3). Reinsertion converges to the serial
    result."""
    blocks = corpus("cross")[:3]
    chain = port_chain(insert_pipeline_depth=2)
    pb = decoded(chain, blocks)
    release = threading.Event()
    note = chain._note_bad_block

    def parked(block, e):
        note(block, e)
        if block.number == 1:
            release.wait(30)  # the worker has not taken block 2 yet

    chain._note_bad_block = parked
    fault.set_failpoint("insert/before_write", "raise*1")
    chain.insert_block(pb[0])
    chain.insert_block(pb[1])
    deadline = time.monotonic() + 30
    while chain.pipeline._error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    timer = threading.Timer(0.3, release.set)
    timer.start()
    with pytest.raises(FailpointError):
        chain.insert_block(pb[2])
    timer.join()
    chain.pipeline.drain()  # nothing left: block 2 was discarded
    assert [b.number for b, _, _ in chain.bad_blocks] == [1]
    fault.clear_all()
    for b in pb:
        chain.insert_block(b)
    chain.pipeline.drain()
    _parity_after(blocks, chain)


def test_serial_depth0_fires_the_same_failpoints():
    blocks = corpus("cross")[:1]
    chain = port_chain()
    pb = decoded(chain, blocks)
    fault.set_failpoint("insert/before_commit", "raise*1")
    with pytest.raises(FailpointError):
        chain.insert_block(pb[0])
    fault.clear_all()
    chain.insert_block(pb[0])
    chain.join_tail()
    assert chain.current_block.hash() == blocks[0].hash()
    chain.stop()


# ------------------------------------------------- the device-fault rule

def test_device_fault_in_commit_stage_is_not_a_spec_fallback():
    """A DeviceWedgedError raised in the commit stage's validate (inside
    _fold_speculation, where every other exception means "re-execute
    serially") passes through: it surfaces at the next drain, the head
    stays at the parent, the block is not re-run serially, no fallback
    and no bad block is counted, and the successor is discarded. The
    retried inserts then land the serial result."""
    blocks = corpus("cross")[:3]
    chain = port_chain(insert_pipeline_depth=2)
    pb = decoded(chain, blocks)
    validate = chain.validator.validate_state
    process = chain.processor.process
    serial_runs = []

    def wedged(block, *a, **kw):
        if block.number == 2:
            raise DeviceWedgedError("the device stopped answering")
        return validate(block, *a, **kw)

    def counted(block, *a, **kw):
        serial_runs.append(block.number)
        return process(block, *a, **kw)

    chain.validator.validate_state = wedged
    chain.processor.process = counted
    fallbacks = _counter("chain/pipeline/serial_fallbacks")
    discards = _counter("chain/pipeline/discards")
    # the commit worker parks before block 1's commit until all three are
    # submitted, so the error surfaces at the drain below
    fault.set_failpoint("insert/before_commit", "hang")
    for b in pb:
        chain.insert_block(b)
    fault.clear_all()
    with pytest.raises(DeviceWedgedError):
        chain.pipeline.drain()
    assert chain.current_block.hash() == blocks[0].hash()
    assert serial_runs == []
    assert _counter("chain/pipeline/serial_fallbacks") == fallbacks
    assert _counter("chain/pipeline/discards") == discards + 1
    assert not chain.bad_blocks
    chain.pipeline.drain()  # raised once; nothing pending
    chain.validator.validate_state = validate
    for b in pb[1:]:
        chain.insert_block(b)
    chain.pipeline.drain()
    assert serial_runs == []
    _parity_after(blocks, chain)


@pytest.mark.parametrize("shards", [0, 2])
def test_device_fault_in_a_speculative_read_is_not_a_spec_abort(
        shards, monkeypatch):
    """The submit stage speculates over a _BaseReader of the committed
    parent (in process, or through the shard pool, whose parent serves
    the workers' reads); a base read that reaches the device and fails
    raises from insert_block with the head unchanged: no speculation
    abort, serial fallback, shard crash or bad block is counted and the
    block is not executed serially. Retried, it lands in spec mode."""
    from coreth_tpu_torch.core import mvcc

    blocks = corpus("conflict")[:1]
    chain = port_chain(insert_pipeline_depth=2, evm_exec_shards=shards)
    pb = decoded(chain, blocks)
    process = chain.processor.process
    serial_runs = []

    def counted(block, *a, **kw):
        serial_runs.append(block.number)
        return process(block, *a, **kw)

    def wedged(self, addr):
        raise DeviceWedgedError("the device stopped answering")

    chain.processor.process = counted
    names = ("chain/pipeline/spec_aborts", "chain/pipeline/serial_fallbacks",
             "exec/shard/crashes", "exec/shard/fallbacks")
    before = {n: _counter(n) for n in names}
    monkeypatch.setattr(mvcc._BaseReader, "code", wedged)
    with pytest.raises(DeviceWedgedError):
        chain.insert_block(pb[0])
    chain.pipeline.drain()  # nothing was queued
    assert chain.current_block.number == 0
    assert not chain.bad_blocks and serial_runs == []
    assert {n: _counter(n) for n in names} == before
    monkeypatch.undo()
    chain.insert_block(pb[0])
    chain.pipeline.drain()
    assert serial_runs == []
    rec = chain.flight_recorder.find(pb[0].hash())
    assert rec["pipeline"]["mode"] == "spec"
    assert rec["parallel"].get("shards", 0) == shards
    _parity_after(blocks, chain)


# ------------------------------------------------- the resident mirror

def test_resident_mirror_commits_pipelined_blocks():
    """The port's resident chain (device="cpu": the mirror's executor on
    K1's plain version) inserting through the depth-2 pipeline against
    the reference's resident chain inserting serially: the mirror holds
    the reference mirror's root for every block, the records say "spec",
    and the accepted state and store agree."""
    blocks = corpus("cross")
    ref = run(ref_chain(resident_account_trie=True,
                        resident_prefer_host=True), blocks)
    port = run(port_chain(resident_account_trie=True,
                          insert_pipeline_depth=2), blocks)
    assert port.mirror is not None and not port.mirror.host_mode
    assert signature(port, blocks) == signature(ref, blocks)
    for b in blocks:
        assert port.mirror.root_of(b.hash()) == \
            ref.mirror.root_of(b.hash()) == b.header.root
    modes = [r["pipeline"]["mode"] for r in records(port, blocks)]
    assert modes.count("spec") >= len(blocks) - 1, modes
    sp, sr = port.state(), ref.state()
    for a in ADDRS[:4]:
        assert sp.get_balance(a) == sr.get_balance(a)
    compare_stores(ref, port)


# ------------------------------------------------- in-flight records

def test_insert_recs_keyed_by_hash():
    """Two overlapped inserts keep two distinct in-progress flight
    records."""
    blocks = corpus("cross")[:2]
    chain = port_chain(insert_pipeline_depth=2)
    pb = decoded(chain, blocks)
    fault.set_failpoint("insert/before_commit", "hang")
    for b in pb:
        chain.insert_block(b)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with chain._insert_recs_mu:
            if len(chain._insert_recs) == 2:
                break
        time.sleep(0.01)
    with chain._insert_recs_mu:
        recs = dict(chain._insert_recs)
    assert set(recs) == {b.hash() for b in blocks}
    assert recs[blocks[0].hash()]["number"] == 1
    assert recs[blocks[1].hash()]["number"] == 2
    fault.clear_all()  # release the parked commit worker
    chain.pipeline.drain()
    with chain._insert_recs_mu:
        assert not chain._insert_recs
    assert chain.current_block.hash() == blocks[1].hash()
    chain.stop()


def test_accept_of_in_flight_block_drains_first():
    """accept() of a block still in the pipeline drains before taking
    chainmu: no deadlock, no lost commit."""
    blocks = corpus("cross")[:3]
    chain = port_chain(insert_pipeline_depth=2)
    pb = decoded(chain, blocks)
    for b in pb:
        chain.insert_block(b)
    chain.accept(pb[0])
    chain.accept(pb[1])
    assert chain.last_accepted.hash() == blocks[1].hash()
    assert chain.current_block.hash() == blocks[2].hash()
    chain.stop()


def test_reject_of_in_flight_block_drains_first():
    blocks = corpus("cross")[:2]
    chain = port_chain(insert_pipeline_depth=2)
    pb = decoded(chain, blocks)
    for b in pb:
        chain.insert_block(b)
    chain.reject(pb[1])
    assert blocks[1].hash() not in chain._blocks
    with chain._insert_recs_mu:
        assert not chain._insert_recs
    chain.stop()


# ------------------------------------------------- sender cacher batches

def _two_txs():
    b = corpus("cross")[0]
    return [[Transaction.decode(t.encode())] for t in b.transactions[:2]]


def test_wait_joins_one_batch_by_token():
    """wait(token) joins its own recover() batch only: with block k+1's
    recovery parked, block k's wait returns."""
    gates = {}
    signer = Signer(CHAIN_ID)
    real = signer.sender_batch

    def parked(txs, native_threads=0):
        gates[id(txs[0])].wait(10)
        real(txs, native_threads=native_threads)

    signer.sender_batch = parked
    cacher = TxSenderCacher(threads=2)
    txs1, txs2 = _two_txs()
    ev1, ev2 = threading.Event(), threading.Event()
    gates[id(txs1[0])], gates[id(txs2[0])] = ev1, ev2
    tok1 = cacher.recover(signer, txs1)
    tok2 = cacher.recover(signer, txs2)
    assert tok1 != tok2
    ev1.set()
    cacher.wait(tok1)  # returns though batch 2 is still parked
    with cacher._lock:
        assert tok2 in cacher._batches
        assert tok1 not in cacher._batches
    assert txs1[0]._sender == ADDRS[0] and txs2[0]._sender is None
    ev2.set()
    cacher.wait(tok2)
    with cacher._lock:
        assert not cacher._batches
    assert txs2[0]._sender == ADDRS[1]
    cacher.shutdown()


def test_wait_none_joins_everything():
    signer = Signer(CHAIN_ID)
    cacher = TxSenderCacher(threads=2)
    txs1, txs2 = _two_txs()
    t1 = cacher.recover(signer, txs1)
    t2 = cacher.recover(signer, txs2)
    cacher.wait()  # joins both
    with cacher._lock:
        assert not cacher._batches
    cacher.wait(t1)  # completed tokens are a no-op
    cacher.wait(t2)
    assert cacher.recover(signer, []) is None
    cacher.wait(None)
    assert [t[0]._sender for t in (txs1, txs2)] == ADDRS[:2]
    cacher.shutdown()


# ------------------------------------------------- knobs

def test_knob_reaches_the_chain():
    """CacheConfig(insert_pipeline_depth=d) builds the chain's pipeline at
    depth d; 0 builds none."""
    for depth in (0, 1, 3):
        chain = port_chain(insert_pipeline_depth=depth)
        if depth == 0:
            assert chain.pipeline is None
        else:
            assert chain.pipeline.depth == depth
        chain.stop()


def test_pipeline_rejects_out_of_range_depth():
    chain = port_chain()
    for depth in (4, 0):
        with pytest.raises(ValueError):
            InsertPipeline(chain, depth=depth)
    with pytest.raises(ValueError):
        port_chain(insert_pipeline_depth=4)
    chain.stop()


# ------------------------------------------------- SIGKILL drills

CHILD_PRELUDE = r"""
import os, sys, threading, time
sys.path.insert(0, sys.argv[1])
from coreth_tpu_torch import fault, params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig, \
    ChainError
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.ethdb import MemoryDB


class LogDB(MemoryDB):
    # every write appended to a file, one os-level write each: what the
    # kernel holds survives the SIGKILL
    def __init__(self, path):
        super().__init__()
        self.fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)

    def _log(self, writes):
        rec = b"".join(
            (b"D" if v is None else b"P") + len(k).to_bytes(4, "big") + k
            + len(v or b"").to_bytes(4, "big") + (v or b"")
            for k, v in writes)
        os.write(self.fd, rec)

    def put(self, key, value):
        with self._lock:
            super().put(key, value)
            self._log([(bytes(key), bytes(value))])

    def delete(self, key):
        with self._lock:
            super().delete(key)
            self._log([(bytes(key), None)])

    def write_batch(self, writes):
        with self._lock:
            super().write_batch(writes)
            self._log(writes)


lines = open(sys.argv[3]).read().split()
alloc = {bytes.fromhex(a): GenesisAccount(balance=int(v),
                                          code=bytes.fromhex(c))
         for a, v, c in (l.split(":") for l in lines[4:])}
blocks = [Block.decode(bytes.fromhex(h)) for h in lines[:4]]
chain = BlockChain(LogDB(sys.argv[2]),
                   CacheConfig(commit_interval=4096, insert_pipeline_depth=2),
                   params.TEST_CHAIN_CONFIG,
                   Genesis(config=params.TEST_CHAIN_CONFIG,
                           gas_limit=params.CORTINA_GAS_LIMIT, alloc=alloc),
                   new_dummy_engine(), device="cpu")


def build(bs):
    for b in bs:
        chain.insert_block(b)
    chain.pipeline.drain()
"""

# env-armed before_head hang: the tail worker parks on block 1's head
# item while block 2's body+head items (queued by the pipelined commits)
# sit behind it in the FIFO. After SIGKILL the disk shows body 1 durable,
# nothing canonical, body 2 never written.
CHILD_ORDERING = CHILD_PRELUDE + r"""
build(blocks[:2])
deadline = 60
while chain._tail_queue.unfinished_tasks > 3 and deadline > 0:
    time.sleep(0.01); deadline -= 0.01
print("READY", flush=True)
threading.Event().wait(120)  # parked until SIGKILL
"""

# raise*2 on partial_body tears BOTH pipelined blocks' bodies while their
# head items land: the head pointer ends two blocks ahead of durable data
# and the boot scan must walk down both.
CHILD_TORN = CHILD_PRELUDE + r"""
build(blocks[:2])
chain.join_tail()
fault.set_failpoint("chain/tail/partial_body", "raise*2")
build(blocks[2:4])
try:
    chain.join_tail()
except ChainError:
    pass
print("READY", flush=True)
threading.Event().wait(120)  # parked until SIGKILL
"""


def _run_until_ready(script, tmp_path, env=None):
    """Run `script` over a LogDB at tmp_path/log (the corpus's first four
    blocks and genesis handed over in a file), SIGKILL it at READY, and
    return the store its log replays into."""
    blocks = corpus("cross")[:4]
    spec = tmp_path / "blocks.txt"
    spec.write_text("\n".join(
        [b.encode().hex() for b in blocks]
        + [f"{a.hex()}:{FUND}:" for a in ADDRS]
        + [f"{a.hex()}:{bal}:{code.hex()}"
           for a, (bal, code) in EXTRA.items()]))
    log = tmp_path / "log"
    full = dict(os.environ)
    full.update(env or {})
    proc = subprocess.Popen(
        [sys.executable, "-c", script, REPO, str(log), str(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=full)
    timer = threading.Timer(120, proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.strip())
            if line.strip() == "READY":
                break
        assert "READY" in lines, (lines, proc.stderr.read()[-3000:])
    finally:
        timer.cancel()
        proc.kill()  # SIGKILL: no atexit, no close, no flush
        proc.wait(30)
    return _replay(log)


def _replay(path) -> MemoryDB:
    db = MemoryDB()
    blob = path.read_bytes()
    i = 0
    while i < len(blob):
        op = blob[i:i + 1]
        n = int.from_bytes(blob[i + 1:i + 5], "big")
        k = blob[i + 5:i + 5 + n]
        i += 5 + n
        m = int.from_bytes(blob[i:i + 4], "big")
        v = blob[i + 4:i + 4 + m]
        i += 4 + m
        db.write_batch([(k, None if op == b"D" else v)])
    return db


def _reopen(db) -> BlockChain:
    return BlockChain(
        db, CacheConfig(commit_interval=4096), params.TEST_CHAIN_CONFIG,
        Genesis(config=params.TEST_CHAIN_CONFIG,
                gas_limit=params.CORTINA_GAS_LIMIT,
                alloc={**{a: GenesisAccount(balance=FUND) for a in ADDRS},
                       **{a: GenesisAccount(balance=bal, code=code)
                          for a, (bal, code) in EXTRA.items()}}),
        new_dummy_engine(), device="cpu")


def _torn_repairs():
    return _counter("chain/tail/torn_repairs")


def test_sigkill_mid_pipeline_keeps_write_ordering(tmp_path):
    db = _run_until_ready(
        CHILD_ORDERING, tmp_path,
        env={"CORETH_TPU_FAILPOINTS": "chain/tail/before_head=hang"})
    h1, h2 = (b.hash() for b in corpus("cross")[:2])
    before = _torn_repairs()
    chain = _reopen(db)
    # block 1's body was durable before its head item parked; block 2's
    # items never left the FIFO — nothing torn, nothing repaired
    assert rawdb.read_body_rlp(db, 1, h1) is not None
    assert rawdb.read_body_rlp(db, 2, h2) is None
    assert chain.current_block.number == 0
    assert _torn_repairs() == before
    chain.stop()


def test_sigkill_two_block_torn_tail_repairs_at_reboot(tmp_path):
    db = _run_until_ready(CHILD_TORN, tmp_path)
    blocks = corpus("cross")[:4]
    h2, h3, h4 = (b.hash() for b in blocks[1:4])
    assert rawdb.read_head_block_hash(db) == h4
    assert rawdb.read_body_rlp(db, 3, h3) is None
    assert rawdb.read_body_rlp(db, 4, h4) is None
    before = _torn_repairs()
    chain = _reopen(db)
    # the scan walked down past BOTH torn pipelined blocks
    assert chain.current_block.hash() == h2
    assert rawdb.read_head_block_hash(db) == h2
    assert rawdb.read_canonical_hash(db, 3) is None
    assert rawdb.read_canonical_hash(db, 4) is None
    assert _torn_repairs() == before + 1
    ref = run(ref_chain(), blocks[:2], accept=False)
    sp, sr = chain.state(), ref.state()
    for a in ADDRS[:4] + [b"\xbb" * 20]:
        assert sp.get_balance(a) == sr.get_balance(a)
        assert sp.get_nonce(a) == sr.get_nonce(a)
    ref.stop()
    chain.stop()
