"""The port's process execution shards (core/exec_shards.py,
core/shard_worker.py, metrics/shardstats.py) against the JAX package's,
on the CPU: the cases of tests/test_exec_shards.py.

Every corpus is built once by the reference's generate_chain (its serial
loop stamps the headers; tests/torch_exec_twin.py). A reference chain
runs its serial loop, the port's chain the shards, whose write-sets fold
into inserts that validate against the serial headers; both must then
hold the same blocks, receipts (RLP), logs, gas and head, and the port's
store must sit within the reference's. Where the shards' outcome is
deterministic the reference runs its shards too and the flight records'
`parallel` fields must agree (the per-worker timings aside).

The failure ladder is drilled for real, in the port's design: its workers
start from a forkserver and take the parent's armed failpoints with them.
An armed crash kills a live worker mid-dispatch, a child process SIGKILLs
workers parked mid-block, repeated crashes demote the pool; each block
still lands the serial root. The sender cacher's fork guard is drilled in
a bare CPU process that really forks.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from coreth_tpu.core import exec_shards as jexec_shards
from coreth_tpu.metrics import default_registry as j_registry
from coreth_tpu_torch.core import exec_shards
from coreth_tpu_torch.core.sender_cacher import TxSenderCacher
from coreth_tpu_torch.core.state_processor import new_block_context
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.evm.evm import Config
from coreth_tpu_torch.fault import clear_all, set_failpoint
from coreth_tpu_torch.metrics import default_registry

from torch_exec_twin import (
    CHAIN_ID, compare_stores, corpus, port_chain, records, ref_chain, run,
    signature)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    clear_all()
    yield
    clear_all()


def _counter(name):
    return default_registry.counter(name).count()


def _twin(name, **knobs):
    blocks = corpus(name)
    ref = run(ref_chain(), blocks)
    port = run(port_chain(**knobs), blocks)
    assert signature(port, blocks) == signature(ref, blocks)
    return ref, port, blocks


def _without_timings(stats):
    """A `parallel` record with each worker's seconds left out."""
    out = dict(stats)
    if "per_worker" in out:
        out["per_worker"] = {
            w: {k: v for k, v in row.items() if not k.endswith("_seconds")}
            for w, row in out["per_worker"].items()}
    return out


# ------------------------------------------------- determinism sweep

@pytest.mark.parametrize("shards", [0, 1, 2, 4])
def test_disjoint_transfers_bit_exact(shards):
    """Conflict-free blocks at every shard count: the shipped write-sets
    fold to the serial roots with zero parent-side re-executions, and the
    records equal the reference's shards' (timings aside)."""
    ref, port, blocks = _twin("disjoint", evm_exec_shards=shards)
    jmode = run(ref_chain(evm_exec_shards=shards), blocks)
    got = [_without_timings(r["parallel"]) for r in records(port, blocks)]
    assert got == [_without_timings(r["parallel"])
                   for r in records(jmode, blocks)]
    for stats in got:
        if shards == 0:
            assert stats == {"mode": "serial"}
        else:
            assert stats["mode"] == "shards"
            assert stats["fallback"] is False
            assert stats["conflicts"] == stats["reexecs"] == 0
            assert stats["workers"] == shards
    jmode.stop()
    compare_stores(ref, port)


@pytest.mark.parametrize("shards", [0, 2, 4])
def test_conflict_corpus_bit_exact(shards):
    """Shared-slot calls and an out-of-gas call: stale shipped reads force
    parent-side re-execution (or the conflict-rate fallback), and the fold
    still lands the serial roots and the status-0 receipt."""
    ref, port, blocks = _twin("oog", evm_exec_shards=shards)
    for b in blocks:
        statuses = [r.status for r in port.get_receipts(b.hash())]
        assert statuses.count(0) == 1
    stats = port.processor.last_parallel
    if shards == 0:
        assert stats["mode"] == "serial"
    else:
        assert stats["mode"] in ("shards", "serial")
        assert stats["fallback"] is (stats["mode"] == "serial")
    compare_stores(ref, port)


@pytest.mark.parametrize("shards", [2, 4])
def test_fuzz_shared_account_transfers(shards):
    """Balance chains criss-crossing tx indices: the parent sweep's
    validate-or-re-execute paths fire and the fold stays bit-exact."""
    ref, port, _ = _twin("fuzz3", evm_exec_shards=shards)
    compare_stores(ref, port)


def test_coinbase_read_falls_back():
    """A call reading the fee recipient fails speculatively in a worker,
    fails again in the parent's sweep, and the block runs the serial
    loop: one exec/shard/fallbacks in each package, equal records."""
    before = (j_registry.counter("exec/shard/fallbacks").count(),
              _counter("exec/shard/fallbacks"))
    ref, port, blocks = _twin("coinbase", evm_exec_shards=2)
    jmode = run(ref_chain(evm_exec_shards=2), blocks)
    assert j_registry.counter("exec/shard/fallbacks").count() == \
        before[0] + 1
    assert _counter("exec/shard/fallbacks") == before[1] + 1
    assert records(port, blocks)[0]["parallel"] == \
        records(jmode, blocks)[0]["parallel"]
    assert port.processor.last_parallel["fallback"] is True
    jmode.stop()
    compare_stores(ref, port)


# ------------------------------------------------- failure ladder

def test_crash_failpoint_kills_worker_and_falls_back():
    """Armed exec/shard_crash: the parent translates the fire into a real
    worker kill, the dispatch fails, the pool respawns the corpse and the
    block commits through the serial loop; the next block dispatches."""
    crashes = _counter("exec/shard/crashes")
    respawns = _counter("exec/shard/respawns")
    fallbacks = _counter("exec/shard/fallbacks")
    blocks = corpus("disjoint")
    ref = run(ref_chain(), blocks)
    port = port_chain(evm_exec_shards=2)
    pblocks = [Block.decode(b.encode()) for b in blocks]
    set_failpoint("exec/shard_crash", "raise*1")
    port.insert_block(pblocks[0])
    assert _counter("exec/shard/crashes") > crashes
    assert _counter("exec/shard/respawns") > respawns
    assert _counter("exec/shard/fallbacks") > fallbacks
    assert port.processor.last_parallel["fallback"] is True
    clear_all()
    port.insert_block(pblocks[1])
    assert port.processor.last_parallel["mode"] == "shards"
    assert signature(port, blocks) == signature(ref, blocks)
    ref.stop()
    port.stop()


def test_before_dispatch_failpoint_falls_back():
    """exec/before_dispatch fires before anything reaches a worker: the
    block runs serial, the next one through the shards."""
    fallbacks = _counter("exec/shard/fallbacks")
    set_failpoint("exec/before_dispatch", "raise*1")
    ref, port, blocks = _twin("disjoint", evm_exec_shards=2)
    assert _counter("exec/shard/fallbacks") == fallbacks + 1
    assert [r["parallel"]["mode"] for r in records(port, blocks)] == \
        ["serial", "shards"]
    compare_stores(ref, port)


def test_repeated_crashes_demote_pool_to_serial():
    """DEMOTE_AFTER consecutive dispatch failures turn the pool off: later
    blocks run serial without starting workers."""
    assert exec_shards.DEMOTE_AFTER == jexec_shards.DEMOTE_AFTER
    demotions = _counter("exec/shard/demotions")
    blocks = corpus("disjoint4")
    ref = run(ref_chain(), blocks)
    port = port_chain(evm_exec_shards=2)
    pblocks = [Block.decode(b.encode()) for b in blocks]
    set_failpoint("exec/shard_crash", f"raise*{exec_shards.DEMOTE_AFTER}")
    for b in pblocks[:exec_shards.DEMOTE_AFTER]:
        port.insert_block(b)
        assert port.processor.last_parallel["fallback"] is True
    assert _counter("exec/shard/demotions") == demotions + 1
    clear_all()
    assert port.processor.shard_pool() is None
    port.insert_block(pblocks[-1])
    assert port.processor.last_parallel["mode"] == "serial"
    assert signature(port, blocks) == signature(ref, blocks)
    ref.stop()
    port.stop()


CHILD_SHARD = r"""
import os, signal, sys, threading, time
sys.path.insert(0, sys.argv[1])
from coreth_tpu_torch import params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.metrics import default_registry

lines = open(sys.argv[2]).read().split()
alloc = {bytes.fromhex(a): GenesisAccount(balance=int(v),
                                          code=bytes.fromhex(c))
         for a, v, c in (l.split(":") for l in lines[1:])}
block = Block.decode(bytes.fromhex(lines[0]))
chain = BlockChain(MemoryDB(), CacheConfig(pruning=True, evm_exec_shards=2),
                   params.TEST_CHAIN_CONFIG,
                   Genesis(config=params.TEST_CHAIN_CONFIG,
                           gas_limit=params.CORTINA_GAS_LIMIT, alloc=alloc),
                   new_dummy_engine(), device="cpu")

def killer():
    # the env-armed hang parks both workers inside the exec request;
    # SIGKILL them for real once the pool exists
    deadline = time.time() + 60
    while time.time() < deadline:
        pool = chain.processor._shard_pool
        if pool is not None and pool.workers:
            pids = pool.pids()
            time.sleep(0.3)
            for pid in pids:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            return
        time.sleep(0.01)

threading.Thread(target=killer, daemon=True).start()
chain.insert_block(block)  # parks in the shards until the kill
print("NUM", chain.current_block.number, flush=True)
print("ROOT", chain.current_block.root.hex(), flush=True)
print("CRASH", int(default_registry.counter("exec/shard/crashes").count()),
      flush=True)
print("READY", flush=True)
chain.stop()
"""


def _run_child(script, args, env=None, timeout=120):
    """`script` in a fresh interpreter (the port alone); its stdout lines
    until READY, then the child is killed."""
    full = dict(os.environ)
    full.update(env or {})
    proc = subprocess.Popen(
        [sys.executable, "-c", script, REPO, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=full)
    timer = threading.Timer(timeout, proc.kill)
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
        proc.kill()
        proc.wait(30)
    return dict(p for p in (l.split() for l in lines) if len(p) == 2)


def test_sigkill_worker_mid_block_falls_back_bit_exact(tmp_path):
    """SIGKILL live workers parked mid-dispatch (the hang armed through
    the environment reaches them through their start arguments): the
    parent sees pipe EOF, counts the crashes, and the block commits
    serially with the root the reference's serial loop stamped."""
    block = corpus("disjoint")[0]
    spec = tmp_path / "block.txt"
    spec.write_text("\n".join([block.encode().hex()] + [
        f"{a.hex()}:{bal}:{code.hex()}" for a, (bal, code) in _alloc()]))
    out = _run_child(CHILD_SHARD, [str(spec)], env={
        "CORETH_TPU_FAILPOINTS": "exec/shard_crash=hang",
        "CORETH_TPU_SHARD_TIMEOUT_S": "120"})
    assert out["NUM"] == "1"
    assert out["ROOT"] == block.header.root.hex()
    assert int(out["CRASH"]) >= 2  # both parked workers died for real


def _alloc():
    from torch_exec_twin import ADDRS, EXTRA, FUND

    return [(a, (FUND, b"")) for a in ADDRS] + list(EXTRA.items())


# ------------------------------------------------- knob + env plumbing

def test_knob_roundtrip_and_env_off(monkeypatch):
    """CacheConfig(evm_exec_shards=2) reaches the processor, whose pool
    starts at that width; the env override set to 0 turns it off."""
    monkeypatch.delenv(exec_shards.SHARDS_ENV, raising=False)
    port = port_chain(evm_exec_shards=2)
    assert port.processor.exec_shards == 2
    assert len(port.processor.shard_pool().workers) == 2
    monkeypatch.setenv(exec_shards.SHARDS_ENV, "0")
    assert port.processor.shard_pool() is None
    port.stop()
    assert port.processor._shard_pool is None


def test_effective_shards_env_precedence(monkeypatch):
    """The env over the knob, junk falling through, values clamped: the
    port's effective_shards equals the reference's on every row."""
    rows = [(None, 0), (None, 3), (None, 99), ("4", 0), ("0", 3),
            ("99", 0), ("banana", 3), ("-1", 2)]
    for env, cfg in rows:
        if env is None:
            monkeypatch.delenv(exec_shards.SHARDS_ENV, raising=False)
        else:
            monkeypatch.setenv(exec_shards.SHARDS_ENV, env)
        assert exec_shards.effective_shards(cfg) == \
            jexec_shards.effective_shards(cfg), (env, cfg)
    assert exec_shards.MAX_SHARDS == jexec_shards.MAX_SHARDS


# ------------------------------------------------- fork safety

def test_sender_cacher_fork_guard_rebuilds_pool():
    """A cacher that 'crossed a fork' (the owner pid forged) rebuilds its
    thread pool and drops inherited futures before dispatch."""
    trips = _counter("exec/shard/fork_guard_trips")
    cacher = TxSenderCacher(threads=1)
    try:
        old_pool = cacher._pool
        cacher._batches[99] = []  # a parent-process leftover
        cacher._owner_pid = -1  # no real pid: "we are not the owner"
        cacher.wait()
        assert _counter("exec/shard/fork_guard_trips") == trips + 1
        assert cacher._owner_pid == os.getpid()
        assert cacher._pool is not old_pool
        assert cacher._batches == {}
        cacher.wait()  # same-process calls never trip it again
        assert _counter("exec/shard/fork_guard_trips") == trips + 1
    finally:
        cacher.shutdown()


CHILD_FORK = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
from coreth_tpu_torch.core.sender_cacher import TxSenderCacher
from coreth_tpu_torch.core.types import Signer, Transaction
from coreth_tpu_torch.metrics import default_registry

signer = Signer(int(sys.argv[2]))
blobs = [bytes.fromhex(h) for h in sys.argv[3].split(",")]
cacher = TxSenderCacher(threads=2)
warm = [Transaction.decode(b) for b in blobs]
cacher.wait(cacher.recover(signer, warm))  # the pool's threads now run
want = [signer.sender(tx) for tx in warm]
pid = os.fork()
if pid == 0:
    txs = [Transaction.decode(b) for b in blobs]
    cacher.wait(cacher.recover(signer, txs))
    trips = default_registry.counter("exec/shard/fork_guard_trips").count()
    ok = [tx._sender for tx in txs] == want and trips == 1
    os._exit(0 if ok else 3)
_, status = os.waitpid(pid, 0)
print("CHILD", os.waitstatus_to_exitcode(status), flush=True)
print("READY", flush=True)
"""


def test_sender_cacher_fork_guard_in_a_forked_process():
    """A bare CPU process whose cacher pool is running forks: the child's
    recover/wait rebuild the pool (one fork-guard trip) and recover every
    sender instead of hanging on the parent's threadless pool."""
    blobs = [tx.encode().hex() for tx in corpus("disjoint")[0].transactions]
    out = _run_child(CHILD_FORK, [str(CHAIN_ID), ",".join(blobs[:80])],
                     timeout=60)
    assert out["CHILD"] == "0"


def test_workers_are_clean():
    """Workers started from the forkserver report no inherited thread, no
    CUDA context and no jax, jaxlib or coreth_tpu module, before and
    after they executed a block."""
    trips = _counter("exec/shard/fork_guard_trips")
    ref, port, blocks = _twin("disjoint", evm_exec_shards=2)
    pongs = port.processor.shard_pool().ping()
    assert [p[:2] for p in pongs] == [("pong", 0), ("pong", 1)]
    for p in pongs:
        assert p[3:] == (0, False, []), p
    assert _counter("exec/shard/fork_guard_trips") == trips
    fresh = exec_shards.ShardPool(2, None)
    try:
        assert [p[3:] for p in fresh.ping()] == [(0, False, [])] * 2
    finally:
        fresh.close()
    compare_stores(ref, port)


# ------------------------------------------------- pipeline + smoke

def test_pipeline_with_shards_parity():
    """Depth-2 pipeline speculating through the shard pool: the serial
    roots, and the records say the shards ran the submit stage, as the
    reference's do (timings aside)."""
    ref, port, blocks = _twin("disjoint4", evm_exec_shards=2,
                              insert_pipeline_depth=2)
    jmode = run(ref_chain(evm_exec_shards=2, insert_pipeline_depth=2),
                blocks)
    got = records(port, blocks)
    want = records(jmode, blocks)
    for g, w in zip(got, want):
        assert _without_timings(g["parallel"]) == \
            _without_timings(w["parallel"])
        assert g["parallel"]["mode"] == "pipeline-spec"
        assert g["parallel"]["shards"] == 2
        assert set(g["parallel"]["per_worker"]) == {"0", "1"}
        assert g["pipeline"]["mode"] == w["pipeline"]["mode"] == "spec"
    jmode.stop()
    compare_stores(ref, port)


def test_smoke_cli_in_process():
    assert exec_shards.main(["--smoke"]) == 0


def test_smoke_cli_subprocess():
    """python -m coreth_tpu_torch.core.exec_shards --smoke: a 2-worker
    pool, one worker SIGKILLed, respawned under a new pid."""
    r = subprocess.run(
        [sys.executable, "-m", "coreth_tpu_torch.core.exec_shards",
         "--smoke"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("shard smoke: OK"), r.stdout
    started = line.split("started [")[1].split("]")[0]
    killed = line.split("killed ")[1].split(",")[0]
    respawned = line.split("respawned -> ")[1].split(",")[0]
    assert killed == started.split(",")[0].strip()
    assert respawned not in started


_MAIN_PROBE = """\
import json, os, signal, sys
sys.path.insert(0, {repo!r})
with open(os.environ["MAIN_MARKS"], "a") as f:
    f.write(f"{{__name__}} {{os.getpid()}}\\n")
if __name__ == "__main__":
    from coreth_tpu_torch.core.exec_shards import ShardPool
    pool = ShardPool(2, None)
    started = pool.pids()
    os.kill(started[0], signal.SIGKILL)
    pool.workers[0].proc.join(10)
    pool.respawn_failed()
    pongs = pool.ping()
    print(json.dumps({{"started": started, "now": pool.pids(),
                      "pongs": [list(p) for p in pongs]}}))
    pool.close()
"""


def test_workers_inherit_the_main_module_from_the_server(tmp_path):
    """A script that starts a pool, SIGKILLs a worker and respawns it: its
    module body runs twice, as __main__ in the script and as __mp_main__
    once in the forkserver, never in a worker (started or respawned),
    and every worker answers its ping clean."""
    script = tmp_path / "probe.py"
    script.write_text(_MAIN_PROBE.format(repo=REPO))
    marks = tmp_path / "marks.txt"
    r = subprocess.run(
        [sys.executable, str(script)], cwd=str(tmp_path),
        env={**os.environ, "MAIN_MARKS": str(marks)},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    runs = [line.split() for line in marks.read_text().splitlines()]
    assert [name for name, _ in runs] == ["__main__", "__mp_main__"]
    server = int(runs[1][1])
    workers = set(out["started"]) | set(out["now"])
    assert len(workers) == 3 and server not in workers
    assert out["now"][0] != out["started"][0]
    for pong in out["pongs"]:
        assert pong[4] is False and pong[5] == []


_EXIT_PROBE = """\
import json, os, sys
sys.path.insert(0, {repo!r})
if __name__ == "__main__":
    from multiprocessing import forkserver, resource_tracker
    from coreth_tpu_torch.core.exec_shards import ShardPool, stop_servers
    pool = ShardPool(2, None)
    pids = pool.pids() + [forkserver._forkserver._forkserver_pid,
                          resource_tracker._resource_tracker._pid]
    if sys.argv[1] == "explicit":
        stop_servers()
        assert pool.workers == []
        gone = [p for p in pids if not os.path.exists(f"/proc/{{p}}")]
        assert gone == pids, (gone, pids)
        # a pool made after the stop starts both servers again
        pool = ShardPool(2, None)
        assert len(pool.ping()) == 2
        pids += pool.pids() + [forkserver._forkserver._forkserver_pid,
                               resource_tracker._resource_tracker._pid]
    print(json.dumps(pids))
"""


@pytest.mark.parametrize("how", ["at_exit", "explicit"])
def test_no_process_outlives_the_parent(tmp_path, how):
    """The workers, the forkserver and the resource tracker are gone when
    the process that made a pool has exited: stop_servers runs at exit
    (a pool left open), or earlier when called, after which a new pool
    starts them again."""
    script = tmp_path / "exit_probe.py"
    script.write_text(_EXIT_PROBE.format(repo=REPO))
    r = subprocess.run(
        [sys.executable, str(script), how], cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    pids = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(pids) == (4 if how == "at_exit" else 8)
    assert all(isinstance(p, int) for p in pids)
    assert [p for p in pids if os.path.exists(f"/proc/{p}")] == []


# ------------------------------------------------- worker telemetry

def _worker_tx_total(workers=(0, 1)):
    return sum(_counter(f"exec/shard/worker/{i}/txs") for i in workers)


def test_worker_stats_merge_exactly_once_per_dispatch():
    """Across N blocks the per-worker tx counters sum to exactly N times
    the txs a block; the record decomposes each dispatch per worker."""
    t0 = _worker_tx_total()
    ref, port, blocks = _twin("disjoint", evm_exec_shards=2)
    assert _worker_tx_total() - t0 == 2 * 12
    per_worker = records(port, blocks)[-1]["parallel"]["per_worker"]
    assert set(per_worker) == {"0", "1"}
    assert sum(r["txs"] for r in per_worker.values()) == 12
    for row in per_worker.values():
        assert row["execute_seconds"] >= 0.0
        assert row["pipe_wait_seconds"] >= 0.0
        assert row["pipe_reads"] >= 0
    compare_stores(ref, port)


def test_worker_stats_not_double_counted_on_crash_respawn():
    """A crashed dispatch merges nothing; the respawned pool's next
    dispatch merges one block's worth exactly."""
    t0 = _worker_tx_total()
    blocks = corpus("disjoint")
    port = port_chain(evm_exec_shards=2)
    pblocks = [Block.decode(b.encode()) for b in blocks]
    set_failpoint("exec/shard_crash", "raise*1")
    port.insert_block(pblocks[0])
    assert port.processor.last_parallel["fallback"] is True
    assert _worker_tx_total() - t0 == 0
    clear_all()
    port.insert_block(pblocks[1])
    assert port.processor.last_parallel["mode"] == "shards"
    assert _worker_tx_total() - t0 == 12
    port.stop()


def test_concurrent_dispatches_on_one_pool_serialize():
    """Two threads dispatch a block each through one pool at once (the
    processor's serial path and the pipeline's submit stage can): the
    pool takes them one at a time, and each block folds its own serial
    receipts and root. The reference's pool lets the two interleave on
    the workers' pipes (ROADMAP Queue 3)."""
    blocks = [corpus("disjoint")[0], corpus("oog")[0]]
    port = port_chain(evm_exec_shards=2)
    pool = port.processor.shard_pool()
    parent = port.genesis_block.header
    out, errs = {}, []

    def dispatch(jblock):
        block = Block.decode(jblock.encode())
        try:
            sdb = port.state_at(parent.root)
            (receipts, _, used), stats = exec_shards.execute_block_sharded(
                port.config, block, parent, sdb,
                new_block_context(block.header, port), Config(), 2, pool)
            out[block.hash()] = ([r.encode() for r in receipts], used,
                                 stats["mode"], sdb.intermediate_root(True))
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    threads = [threading.Thread(target=dispatch, args=(b,)) for b in blocks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs, errs
    for b in blocks:
        ref = run(ref_chain(), [b], accept=False)
        assert out[b.hash()] == (
            [r.encode() for r in ref.get_receipts(b.hash())],
            b.header.gas_used, "shards", b.header.root)
        ref.stop()
    port.stop()
