"""The port's fault-injecting store and SQLite backend against the JAX
package's (coreth_tpu/ethdb/faultdb.py, sqlitedb.py), on the CPU.

The same operation sequence under the same failpoint specs, with
`fault.set_seed` set alike in both packages, must give the same outcomes
(values read, typed DBError raised) and the same store contents. The
SQLite cases cover the round trip, ordered iteration, the torn batch,
the corrupt read, close and reopen. Last come the child-process cases
that tests/test_torch_chain_faults.py left for these modules: a process
SIGKILLed mid-batch or mid-insert-tail, its SQLite file reopened by the
port's chain alone. Those children import only the port.
"""

import os
import random
import subprocess
import sys
import time

import pytest

from coreth_tpu import fault as jfault
from coreth_tpu.ethdb import DBError as JDBError
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.ethdb.faultdb import FaultInjectingDB as JFaultInjectingDB
from coreth_tpu.ethdb.sqlitedb import SQLiteDB as JSQLiteDB
from coreth_tpu_torch import fault
from coreth_tpu_torch.ethdb import DBError, MemoryDB
from coreth_tpu_torch.ethdb.faultdb import FaultInjectingDB
from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB
from coreth_tpu_torch.metrics import default_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    fault.clear_all()
    jfault.clear_all()
    yield
    fault.clear_all()
    jfault.clear_all()


def _script(seed: int, n: int = 160):
    """A seeded sequence of (op, key, value, armed failpoint or None,
    spec): gets, puts, deletes, has, batches and prefix scans, about one
    in three under an armed ethdb/* failpoint."""
    rng = random.Random(seed)
    sites = ("ethdb/before_get", "ethdb/before_put",
             "ethdb/before_batch_write", "ethdb/torn_batch",
             "ethdb/corrupt_read")
    specs = ("raise*1", "raise*2", "raise%0.5*3")
    keys = [bytes([0x61 + i % 3]) + rng.randbytes(3) for i in range(24)]
    out = []
    for _ in range(n):
        op = rng.choice(("get", "get", "put", "put", "delete", "has",
                         "batch", "iterate"))
        k = rng.choice(keys)
        v = rng.randbytes(rng.randint(1, 40))
        arm = rng.choice(sites) if rng.random() < 0.35 else None
        out.append((op, k, v, arm, rng.choice(specs),
                    [(rng.choice(keys), rng.randbytes(8) if rng.random() < 0.8
                      else None) for _ in range(rng.randint(1, 7))]))
    return out


def _drive(db, fmod, err_type, script):
    """Run the script on one package's store; every step's outcome."""
    outcomes = []
    for op, k, v, arm, spec, batch in script:
        fmod.clear_all()
        if arm:
            fmod.set_failpoint(arm, spec)
        try:
            if op == "get":
                res = db.get(k)
            elif op == "put":
                res = db.put(k, v)
            elif op == "delete":
                res = db.delete(k)
            elif op == "has":
                res = db.has(k)
            elif op == "batch":
                res = db.write_batch(batch)
            else:
                res = list(db.iterate(k[:1]))
            outcomes.append(("ok", res))
        except err_type as e:
            outcomes.append(("DBError", str(e).split(":")[0]))
    fmod.clear_all()
    return outcomes, list(db.iterate())


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_same_script_same_outcomes_and_store(seed):
    """One scripted run on each package's FaultInjectingDB over its
    MemoryDB, both seeded alike: equal outcomes step by step (a torn
    batch's prefix and a corrupt read's flipped bit included) and equal
    final contents."""
    script = _script(seed)
    fault.set_seed(seed)
    jfault.set_seed(seed)
    got = _drive(FaultInjectingDB(MemoryDB()), fault, DBError, script)
    want = _drive(JFaultInjectingDB(JMemoryDB()), jfault, JDBError, script)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert {o[0] for o in got[0]} == {"ok", "DBError"}


def test_corrupt_read_flips_the_reference_bit():
    """ethdb/corrupt_read flips the same seeded bit of the same record as
    the reference, for several seeds and keys."""
    for seed in (0, 5, 99):
        fault.set_seed(seed)
        jfault.set_seed(seed)
        for i in range(6):
            key, val = b"k%d" % i, bytes(range(i, i + 33))
            port, ref = FaultInjectingDB(MemoryDB()), JFaultInjectingDB(
                JMemoryDB())
            port.put(key, val)
            ref.put(key, val)
            fault.set_failpoint("ethdb/corrupt_read", "raise*1")
            jfault.set_failpoint("ethdb/corrupt_read", "raise*1")
            a, b = port.get(key), ref.get(key)
            assert a == b != val
            assert sum(bin(x ^ y).count("1") for x, y in zip(a, val)) == 1
            assert port.get(key) == val  # the one-shot is spent


def test_unarmed_wrapper_is_transparent_and_passes_extras(tmp_path):
    db = FaultInjectingDB(SQLiteDB(str(tmp_path / "x.db")))
    db.write_batch([(b"a", b"1"), (b"b", b"2"), (b"c", None)])
    db.put(b"d", b"4")
    db.delete(b"a")
    assert list(db.iterate()) == [(b"b", b"2"), (b"d", b"4")]
    assert db.has(b"b") and not db.has(b"a") and len(db) == 2
    assert db.path.endswith("x.db") and db.stat()["entries"] == 2
    db.compact()
    db.close()


@pytest.fixture
def pair(tmp_path):
    a = SQLiteDB(str(tmp_path / "port.db"), sync=False)
    b = JSQLiteDB(str(tmp_path / "ref.db"), sync=False)
    yield a, b
    a.close()
    b.close()


def test_sqlite_round_trip_and_order_match_reference(pair):
    """Binary keys, overwrites, deletes, batches with deletes and prefix
    scans from a start key (across the 1024-row chunking) give the same
    answers and the same file contents as the reference's SQLiteDB."""
    rng = random.Random(4)
    a, b = pair
    for db in (a, b):
        assert db.get(b"\x00") is None
    for _ in range(2600):
        k = bytes([rng.choice((0, 1, 0x61))]) + rng.randbytes(
            rng.randint(0, 4))
        v = rng.randbytes(rng.randint(0, 20))
        r = rng.random()
        for db in (a, b):
            if r < 0.6:
                db.put(k, v)
            elif r < 0.7:
                db.delete(k)
            else:
                db.write_batch([(k, v), (k + b"\x01", None),
                                (b"\xff" + k, v)])
    assert list(a.iterate()) == list(b.iterate())
    for prefix, start in ((b"", b""), (b"\x00", b""), (b"\x01", b"\x80"),
                          (b"a", b"\x10\x20"), (b"\xff", b"")):
        assert list(a.iterate(prefix, start)) == list(b.iterate(prefix,
                                                                start))
    assert a.stat()["entries"] == b.stat()["entries"] == len(a)


def test_sqlite_torn_batch_and_corrupt_read(tmp_path):
    """Over SQLite the torn batch leaves exactly the first half durable
    (a reopen sees it), before_batch_write applies nothing, and a
    corrupt read flips the reference's bit: the same on both packages."""
    results = []
    for pkg, Fdb, Sdb, err, fmod in (
            ("port", FaultInjectingDB, SQLiteDB, DBError, fault),
            ("ref", JFaultInjectingDB, JSQLiteDB, JDBError, jfault)):
        path = str(tmp_path / f"{pkg}.db")
        fmod.set_seed(11)
        db = Fdb(Sdb(path))
        db.put(b"base", b"survives" * 4)
        writes = [(b"batch-%d" % i, b"v%d" % i) for i in range(7)]
        fmod.set_failpoint("ethdb/before_batch_write", "raise*1")
        with pytest.raises(err):
            db.write_batch(writes)
        fmod.clear_all()
        fmod.set_failpoint("ethdb/torn_batch", "raise*1")
        with pytest.raises(err, match="torn"):
            db.write_batch(writes)
        fmod.clear_all()
        fmod.set_failpoint("ethdb/corrupt_read", "raise*1")
        flipped = db.get(b"base")
        fmod.clear_all()
        db.close()
        reopened = Sdb(path)
        results.append((flipped, list(reopened.iterate())))
        reopened.close()
    assert results[0] == results[1]
    assert [k for k, _ in results[0][1]] == [
        b"base", b"batch-0", b"batch-1", b"batch-2", b"batch-3"]
    assert results[0][0] != b"survives" * 4


def test_sqlite_close_is_idempotent_and_later_ops_raise(tmp_path):
    for Sdb, err in ((SQLiteDB, DBError), (JSQLiteDB, JDBError)):
        db = Sdb(str(tmp_path / f"{Sdb.__module__}.db"))
        db.put(b"k", b"v")
        db.close()
        db.close()
        for call in (lambda: db.get(b"k"), lambda: db.put(b"k", b"w"),
                     lambda: db.has(b"k"), lambda: db.delete(b"k"),
                     lambda: db.write_batch([(b"a", b"b")]),
                     lambda: list(db.iterate()), db.stat, db.compact):
            with pytest.raises(err, match="closed"):
                call()
        again = Sdb(db.path)
        assert again.get(b"k") == b"v"
        again.close()


# ------------------------------------------ child processes, port only

_GUARD = r"""
import sys
FORBIDDEN = ("jax", "jaxlib", "coreth_tpu", "cryptography")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[2])
"""

_CHILD_EXIT = _GUARD + r"""
import os
from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB
d = SQLiteDB(sys.argv[1])
d.write_batch([(b"committed", b"yes")])
os._exit(0)  # no close(), no interpreter teardown
"""

_CHILD_TORN_BATCH = _GUARD + r"""
import threading, time
from coreth_tpu_torch.ethdb.faultdb import FaultInjectingDB
from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB

db = FaultInjectingDB(SQLiteDB(sys.argv[1]))
db.put(b"baseline", b"survives")
writes = [(b"batch-%d" % i, b"v%d" % i) for i in range(6)]
# env-armed hang: parks between the two halves, the first half durable
threading.Thread(target=db.write_batch, args=(writes,), daemon=True).start()
for _ in range(6000):
    probe = SQLiteDB(sys.argv[1])
    half = sum(1 for i in range(6) if probe.get(b"batch-%d" % i) is not None)
    probe.close()
    if half >= 3:
        break
    time.sleep(0.01)
print("READY", flush=True)
threading.Event().wait(120)  # parked until SIGKILL
"""


def _until_ready(script, path, env=None):
    full = dict(os.environ)
    full.update(env or {})
    proc = subprocess.Popen([sys.executable, "-c", script, path, REPO],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=full)
    lines = []
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
            if line.strip() == "READY":
                break
        assert "READY" in lines, (lines, proc.stderr.read()[-2000:])
    finally:
        proc.kill()  # SIGKILL: no atexit, no close, no flush
        proc.wait(30)
        proc.stdout.close()
        proc.stderr.close()
    return lines


def test_batch_survives_abrupt_process_exit(tmp_path):
    """A committed batch is durable across a process that exits without
    closing the store (WAL crash safety)."""
    path = str(tmp_path / "crash.db")
    subprocess.run([sys.executable, "-c", _CHILD_EXIT, path, REPO],
                   check=True, timeout=60)
    d = SQLiteDB(path)
    assert d.get(b"committed") == b"yes"
    d.close()


def test_sigkill_mid_batch_leaves_the_torn_prefix(tmp_path):
    """A child parked on an env-armed ethdb/torn_batch hang is SIGKILLed:
    exactly the first half of the batch is on disk, as in the
    reference's tests/test_storage_faults.py."""
    path = str(tmp_path / "torn-batch.db")
    _until_ready(_CHILD_TORN_BATCH, path,
                 {"CORETH_TPU_FAILPOINTS": "ethdb/torn_batch=hang"})
    db = SQLiteDB(path)
    assert db.get(b"baseline") == b"survives"
    assert [i for i in range(6)
            if db.get(b"batch-%d" % i) is not None] == [0, 1, 2]
    db.close()


def test_sigkill_torn_tail_repaired_at_reboot(tmp_path):
    """The chaos conductor's kill child (fault/chaos.py's _KILL_CHILD, on
    the CPU, under the import guard) tears block 3's insert tail and is
    SIGKILLed; the port's chain reopened on its SQLite file repairs to
    exactly block 2, as the reference's tests/test_tail_repair.py
    acceptance case does, with the repaired head's state live."""
    from coreth_tpu_torch import params
    from coreth_tpu_torch.consensus.dummy import new_dummy_engine
    from coreth_tpu_torch.core import rawdb
    from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
    from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
    from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
    from coreth_tpu_torch.fault.chaos import _KILL_CHILD
    from coreth_tpu_torch.state.database import Database
    from coreth_tpu_torch.trie.triedb import TrieDatabase

    path = str(tmp_path / "torn.db")
    script = _GUARD + _KILL_CHILD.replace(
        "sys.path.insert(0, sys.argv[2])\n", "", 1)
    proc = subprocess.Popen([sys.executable, "-c", script, path, REPO, "cpu"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    lines = []
    try:
        for _ in range(40):
            line = proc.stdout.readline()
            lines.append(line.strip())
            if not line or line.strip() == "READY":
                break
        assert "READY" in lines, (lines, proc.stderr.read()[-2000:])
    finally:
        proc.kill()
        proc.wait(30)
        proc.stdout.close()
        proc.stderr.close()
    assert "DEVICE cpu mirror False" in lines
    out = {p[0]: p[1] for p in (l.split() for l in lines) if len(p) == 2}
    h2, h3 = bytes.fromhex(out["B2"]), bytes.fromhex(out["B3"])
    probe = SQLiteDB(path)
    assert rawdb.read_head_block_hash(probe) == h3
    assert rawdb.read_body_rlp(probe, 3, h3) is None
    probe.close()
    repairs = default_registry.counter("chain/tail/torn_repairs").count()
    diskdb = SQLiteDB(path)
    chain = BlockChain(
        diskdb, CacheConfig(commit_interval=4096), params.TEST_CHAIN_CONFIG,
        Genesis(config=params.TEST_CHAIN_CONFIG,
                gas_limit=params.CORTINA_GAS_LIMIT,
                alloc={priv_to_address(b"\x11" * 32):
                       GenesisAccount(balance=10**22)}),
        new_dummy_engine(), state_database=Database(TrieDatabase(diskdb)),
        device="cpu")
    try:
        assert chain.current_block.number == 2
        assert chain.current_block.hash() == h2
        assert rawdb.read_head_block_hash(diskdb) == h2
        assert (default_registry.counter("chain/tail/torn_repairs").count()
                == repairs + 1)
        assert chain.flight_recorder.events(
            kind="tail/torn_repair")[-1]["torn_head"] == h3.hex()
        assert chain.state().get_balance(b"\xbb" * 20) == 2 * 1000
    finally:
        chain.stop()
        diskdb.close()
