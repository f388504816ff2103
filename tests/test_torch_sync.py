"""State sync and the peer layer of the port (coreth_tpu_torch/sync/,
peer/, vm/syncervm.py, vm/atomic_trie.py:AtomicSyncer) against the JAX
package's, on the CPU.

- The message codec is byte-equal to the reference's for every type.
- The handlers answer byte-equal responses when both packages' chains
  come from one genesis (accounts, contracts with storage and code) and
  the same signed blocks.
- A two-VM sync over the TCP transport, with a second peer whose
  FaultyTransport corrupts a response, leaves the port's client at the
  summary with the server's balances, nonces, slots and code, its
  resident mirror rebooted (K1's plain version), after which it
  verifies and accepts the server's next block; the reference's
  two-VM sync of the same blocks lands the same state.
- A segmented sync killed mid-way resumes from its markers on SQLite,
  and a pivot carries them to the new root; both packages leave the same
  store behind.
- The transport's frames are the reference's; its stop() and the
  Network's close() leave no thread (ROADMAP Queue 3).
- The same FaultyTransport scripts give the same rotation and
  quarantine outcomes in both packages.
- AtomicSyncer rebuilds the reference's atomic root.

Sync knobs are set small (attempts, back-off) so nothing waits long.
"""

import importlib
import json
import random
import threading
import time

import pytest

from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.sync import messages as jmsg
from coreth_tpu_torch.sync import messages as msg

KEY = b"\x11" * 32
ADDR = bytes.fromhex("19e7e376e7c213b7e7e7e46cc70a5dd086daff2a")
DEST = b"\xbb" * 20
FUND = 10**24
CHAIN_ID = 43112
# a contract that returns its first slot (code synced by hash)
CODE_A = bytes([0x60, 0x00, 0x54, 0x60, 0x00, 0x52, 0x60, 0x20, 0x60,
                0x00, 0xF3])
CODE_B = CODE_A + b"\x00"
CONTRACTS = {
    b"\xc1" * 20: (CODE_A, {i.to_bytes(32, "big"): (i * 7 + 1).to_bytes(
        32, "big") for i in range(40)}),
    b"\xc2" * 20: (CODE_A, {i.to_bytes(32, "big"): (i * 7 + 1).to_bytes(
        32, "big") for i in range(40)}),  # shares C1's storage root
    b"\xc3" * 20: (CODE_B, {i.to_bytes(32, "big"): (i + 2).to_bytes(
        32, "big") for i in range(0, 90, 3)}),
}
EOAS = [bytes([0xe0 + i % 16]) + i.to_bytes(19, "big") for i in range(150)]
SYNC_KNOBS = {"sync-max-attempts": 6, "sync-backoff-base": 0.001,
              "sync-backoff-cap": 0.005, "sync-quarantine-seconds": 5.0}
# the servers hash on the CPU hasher: the reference's "auto" would compile
# its XLA programs for seconds, and sync serves from the store either way
SERVER_KNOBS = {"commit-interval": 4, "device-hasher": "off", **SYNC_KNOBS}


def _signed_transfers(n_blocks=4, per_block=3):
    signer = JSigner(CHAIN_ID)
    out, nonce = [], 0
    for b in range(n_blocks + 1):
        blk = []
        for _ in range(per_block):
            blk.append(signer.sign(JTransaction(
                type=2, chain_id=CHAIN_ID, nonce=nonce, max_fee=10**12,
                max_priority_fee=10**9, gas=21000,
                to=EOAS[nonce % len(EOAS)] if nonce % 2 else DEST,
                value=3 + nonce), KEY).encode())
            nonce += 1
        out.append(blk)
    return out


class Node:
    """A VM of either package on one genesis and clock; the port's on
    device="cpu". `diskdb` defaults to the package's MemoryDB."""

    def __init__(self, pkg, config=None, diskdb=None):
        self.pkg = pkg

        def m(name):
            return importlib.import_module(f"{pkg}.{name}")

        self.m = m
        g = m("core.genesis")
        alloc = {ADDR: g.GenesisAccount(balance=FUND)}
        for addr, (code, storage) in CONTRACTS.items():
            alloc[addr] = g.GenesisAccount(balance=5, code=code,
                                           storage=dict(storage))
        for i, a in enumerate(EOAS):
            alloc[a] = g.GenesisAccount(balance=10**15 + i, nonce=i % 3)
        genesis = g.Genesis(config=m("params").TEST_CHAIN_CONFIG,
                            gas_limit=m("params").CORTINA_GAS_LIMIT,
                            alloc=alloc)
        vm = m("vm.vm").VM()
        kw = {"device": "cpu"} if pkg == "coreth_tpu_torch" else {}
        vm.initialize(
            m("vm.vm").SnowContext(shared_memory=m(
                "vm.shared_memory").Memory()),
            diskdb if diskdb is not None else m("ethdb").MemoryDB(), genesis,
            config_bytes=json.dumps(config or {}).encode(), **kw)
        vm.miner.clock = lambda: vm.blockchain.current_block.time + 2
        self.vm = vm

    def build(self, raws):
        T = self.m("core.types").Transaction
        for r in raws:
            self.vm.issue_tx(T.decode(r))
        blk = self.vm.build_block()
        blk.verify()
        self.vm.set_preference(blk.id())
        blk.accept()
        self.vm.blockchain.drain_acceptor_queue()
        return blk

    def world(self):
        """Balances, nonces, code and slots of every genesis account."""
        st = self.vm.blockchain.state()
        out = {}
        for a in [ADDR, DEST] + EOAS + list(CONTRACTS):
            slots = sorted(CONTRACTS.get(a, (b"", {}))[1])
            out[a] = (st.get_balance(a), st.get_nonce(a), st.get_code(a),
                      [st.get_state(a, s) for s in slots])
        return out

    def shutdown(self):
        self.vm.shutdown()


@pytest.fixture(scope="module")
def txs():
    return _signed_transfers()


@pytest.fixture(scope="module")
def servers(txs):
    """A server VM of each package with 4 accepted blocks, commit
    interval 4 (block 4 is a syncable summary)."""
    nodes = {p: Node(p, SERVER_KNOBS)
             for p in ("coreth_tpu", "coreth_tpu_torch")}
    for blk in txs[:4]:
        ids = {p: n.build(blk).id() for p, n in nodes.items()}
        assert len(set(ids.values())) == 1
    yield nodes
    for n in nodes.values():
        n.shutdown()


# ---------------------------------------------------------------- codec


def _random_messages(mod, rng):
    b = rng.randbytes
    return [
        mod.LeafsRequest(b(32)),
        mod.LeafsRequest(b(32), b(32), b(32), b(32), rng.randint(0, 2**20)),
        mod.LeafsResponse(),
        mod.LeafsResponse([b(32) for _ in range(5)],
                          [b(rng.randint(0, 90)) for _ in range(5)], True,
                          [b(rng.randint(1, 600)) for _ in range(3)]),
        mod.BlockRequest(b(32), rng.randint(0, 2**40), 256),
        mod.BlockResponse([b(rng.randint(1, 900)) for _ in range(4)]),
        mod.CodeRequest([b(32) for _ in range(5)]),
        mod.CodeResponse([b"", b(3000)]),
        mod.EthCallRequest(json.dumps({"to": "0x" + b(20).hex()}).encode()),
        mod.EthCallResponse(b"0x" + b(40).hex().encode(), b"revert"),
    ]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_codec_is_byte_equal_for_every_type(seed):
    port = _random_messages(msg, random.Random(seed))
    ref = _random_messages(jmsg, random.Random(seed))
    for p, r in zip(port, ref):
        assert p.encode() == r.encode()
        back = msg.decode_message(r.encode())
        assert type(back).__name__ == type(p).__name__
        assert back.encode() == r.encode()
    s = msg.SyncSummary(16384, b"\x01" * 32, b"\x02" * 32, b"\x03" * 32)
    js = jmsg.SyncSummary(16384, b"\x01" * 32, b"\x02" * 32, b"\x03" * 32)
    assert s.encode() == js.encode() and s.id() == js.id()
    assert msg.SyncSummary.decode(js.encode()) == s
    with pytest.raises(ValueError, match="unknown message type"):
        msg.decode_message(b"\x63garbage")


# ------------------------------------------------------------- handlers


def _requests(chain, storage_roots, code_hashes):
    root = chain.last_accepted.root
    tip = chain.last_accepted
    mid = (1 << 255).to_bytes(32, "big")
    reqs = [msg.LeafsRequest(root),
            msg.LeafsRequest(root, limit=7),
            msg.LeafsRequest(root, start=mid, limit=9),
            msg.LeafsRequest(root, start=b"\x20" * 32, end=b"\x90" * 32,
                             limit=1024),
            msg.LeafsRequest(root, start=b"\xf0" * 32, end=b"\xff" * 32),
            msg.LeafsRequest(b"\x77" * 32),  # unknown root: don't-have
            msg.BlockRequest(tip.hash(), tip.number, 3),
            msg.BlockRequest(tip.hash(), tip.number, 300),
            msg.BlockRequest(b"\x55" * 32, 9, 2),
            msg.CodeRequest(code_hashes + [b"\x12" * 32])]
    for acct, sroot in storage_roots:
        reqs += [msg.LeafsRequest(sroot, account=acct),
                 msg.LeafsRequest(sroot, account=acct, start=b"\x40" * 32,
                                  limit=5)]
    return reqs


def test_handler_responses_are_byte_equal(servers):
    from coreth_tpu_torch.native import keccak256

    port = servers["coreth_tpu_torch"].vm
    ref = servers["coreth_tpu"].vm
    st = port.blockchain.state()
    storage_roots = [(keccak256(a), st._get_state_object(a).data.root)
                     for a in CONTRACTS]
    codes = [keccak256(CODE_A), keccak256(CODE_B)]
    reqs = _requests(port.blockchain, storage_roots, codes)
    for req in reqs:
        blob = req.encode()
        got = port.sync_handler.handle(b"peer", blob)
        want = ref.sync_handler.handle(b"peer", blob)
        assert got == want, req
    # the snapshot fast path and the trie path answer the same bytes
    from coreth_tpu_torch.sync.handlers import LeafsRequestHandler

    trie_only = LeafsRequestHandler(port.state_database.triedb)
    for req in reqs[:5]:
        assert (trie_only.on_leafs_request(req).encode()
                == port.sync_handler.handle(b"peer", req.encode()))


# --------------------------------------------------------- two-VM sync


def _sync_reference(ref_server):
    """The reference's own two-VM sync of the same summary (in process)."""
    from coreth_tpu.peer.network import Network as JNetwork
    from coreth_tpu.sync.client import SyncClient as JSyncClient
    from coreth_tpu.vm.syncervm import StateSyncClient as JClient
    from coreth_tpu.vm.syncervm import StateSyncServer as JServer

    summary = JServer(ref_server.vm.blockchain,
                      syncable_interval=4).get_last_state_summary()
    client = Node("coreth_tpu", {"device-hasher": "off"})
    net = JNetwork(self_id=b"client")
    net.connect(b"server",
                lambda s, r: ref_server.vm.sync_handler.handle(s, r))
    JClient(client.vm, JSyncClient(net)).accept_summary(summary)
    if net._pool is not None:  # the reference's Network has no close()
        net._pool.shutdown(wait=True)
    return client, summary


def test_two_vm_sync_over_tcp_with_a_faulty_peer(servers, txs, tmp_path):
    """The port's client VM, on SQLite with the resident mirror on,
    syncs from the port's server over the TCP transport; a second peer
    corrupts its first answer (rejected by the range proof, the client
    rotates). The client lands on the summary with the server's world,
    rebooted its mirror, answers debug_syncStatus from the live client,
    then verifies and accepts the server's next block. The reference's
    two-VM sync of the same blocks lands the same world and head."""
    from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB
    from coreth_tpu_torch.metrics import default_registry
    from coreth_tpu_torch.peer.network import Network
    from coreth_tpu_torch.peer.testing import FaultyTransport
    from coreth_tpu_torch.peer.transport import TransportServer, dial
    from coreth_tpu_torch.sync.client import SyncClient
    from coreth_tpu_torch.vm.api import DebugMetricsAPI
    from coreth_tpu_torch.vm.syncervm import StateSyncClient, StateSyncServer

    server = servers["coreth_tpu_torch"]
    summary = StateSyncServer(server.vm.blockchain,
                              syncable_interval=4).get_last_state_summary()
    assert summary.block_number == 4
    before = set(threading.enumerate())
    tcp = TransportServer(server.vm.sync_handler.handle)
    port = tcp.serve("127.0.0.1", 0)
    good, other = dial("127.0.0.1", port), dial("127.0.0.1", port)
    faulty = FaultyTransport(other, script=["corrupt", "drop"])
    db = SQLiteDB(str(tmp_path / "client.db"), sync=False)
    client = Node("coreth_tpu_torch",
                  {"resident-account-trie": True, **SYNC_KNOBS}, diskdb=db)
    old_mirror = client.vm.blockchain.mirror
    net = Network(self_id=b"client")
    net.connect(b"good", good)
    net.connect(b"faulty", faulty)
    rejected = default_registry.counter("sync/failures/validation").count()
    sync = StateSyncClient(client.vm, SyncClient.from_config(
        net, client.vm.full_config))
    assert sync.client.max_attempts == 6 and sync.client.backoff_cap == 0.005
    sync.accept_summary(summary)
    try:
        chain = client.vm.blockchain
        assert chain.last_accepted.hash() == summary.block_hash
        assert chain.current_block.number == 4
        assert client.vm.last_accepted_vm_block.id() == summary.block_hash
        assert sync.ongoing_summary() is None
        assert chain.mirror is not None and chain.mirror is not old_mirror
        assert chain.mirror.root_of(summary.block_hash) == summary.block_root
        assert client.world() == server.world()
        assert faulty.faults_injected >= 1
        assert (default_registry.counter("sync/failures/validation").count()
                > rejected)
        out = DebugMetricsAPI(client.vm).syncStatus()
        assert out["syncing"] is True and set(out["peers"]) == {
            b"good".hex(), b"faulty".hex()}
        assert out["trie"]["phase"] == "done"

        # the reference's own sync of the same summary lands the same
        ref_client, ref_summary = _sync_reference(servers["coreth_tpu"])
        assert ref_summary.encode() == summary.encode()
        assert ref_client.world() == client.world()
        ref_client.shutdown()

        # the server's next block: parsed, verified, accepted on the client
        blk = server.build(txs[4])
        parsed = client.vm.parse_block(blk.bytes())
        parsed.verify()
        parsed.accept()
        chain.drain_acceptor_queue()
        assert chain.last_accepted.root == blk.eth_block.root
        assert client.world() == server.world()
    finally:
        client.shutdown()
        db.close()
        good.close()
        other.close()
        net.close()
        assert tcp.stop() == []
    deadline = time.time() + 5
    while (_new_threads(before)) and time.time() < deadline:
        time.sleep(0.02)
    assert not _new_threads(before), _new_threads(before)


def _new_threads(before):
    """Threads alive now that were not in `before`, but for a worker of a
    process-wide executor that already ran (the sender cacher's)."""
    pools = {t.name.rsplit("_", 1)[0] for t in before
             if t.name.startswith("ThreadPoolExecutor-")}
    return sorted(t.name for t in threading.enumerate()
                  if t not in before
                  and t.name.rsplit("_", 1)[0] not in pools)


# ------------------------------------------ segments, resume and pivot


def _segment_world(pkg, n):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    tdb = m("trie.triedb").TrieDatabase(m("ethdb").MemoryDB())
    st = m("state.statedb").StateDB(m("trie.node").EMPTY_ROOT,
                                    m("state.database").Database(tdb))
    for i in range(1, n + 1):
        st.add_balance(i.to_bytes(20, "big"), 10**15 + i)
    root = st.commit()
    tdb.commit(root)
    return tdb, root


class _Dying:
    """A sync client whose get_leafs dies after a call budget."""

    def __init__(self, inner, die_after=0):
        self.inner, self.die_after, self.calls = inner, die_after, 0
        self._mu = threading.Lock()

    def get_leafs(self, *a, **kw):
        with self._mu:
            self.calls += 1
            if self.die_after and self.calls > self.die_after:
                raise ConnectionError("simulated crash mid-sync")
        return self.inner.get_leafs(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _segmented_run(pkg, tmp_path):
    """Sync a 700-account trie segmented (leaf limit 40, threshold 80)
    into a SQLite store: a first attempt dies after 6 requests, a pivot
    moves its markers to a second root that holds the same leaves plus
    one, and the resumed sync completes there. Returns the store's
    contents and how many leaves the resume fetched."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    ss = m("sync.statesync")
    tdb, root = _segment_world(pkg, 700)
    tdb2, root2 = _segment_world(pkg, 701)
    handlers = m("sync.handlers")

    def client_for(triedb):
        h = handlers.LeafsRequestHandler(triedb)
        net = m("peer.network").Network(self_id=b"client")
        net.connect(b"server", lambda s, r: h.on_leafs_request(
            m("sync.messages").LeafsRequest.decode(r[1:])).encode())
        return m("sync.client").SyncClient(net), net

    db = m("ethdb.sqlitedb").SQLiteDB(str(tmp_path / f"{pkg}.db"),
                                      sync=False)
    c1, n1 = client_for(tdb)
    s = ss.StateSyncer(_Dying(c1, die_after=6), db, root, leaf_limit=40,
                       segment_threshold=80)
    with pytest.raises(ConnectionError):
        s._sync_trie(root, lambda k, v, b: None)
    s.close()
    markers = list(db.iterate(ss.SYNC_SEGMENT_PREFIX))
    assert markers and list(db.iterate(ss.SYNC_LEAF_PREFIX))
    # pivot: the markers and the buffer follow the new root
    c2, n2 = client_for(tdb2)
    counting = _Dying(c2)
    s = ss.StateSyncer(counting, db, root, leaf_limit=40,
                       segment_threshold=80)
    s.pivot(root2)
    assert not list(db.iterate(ss.SYNC_SEGMENT_PREFIX + root))
    assert len(list(db.iterate(ss.SYNC_SEGMENT_PREFIX + root2))) == len(
        markers)
    count = s._sync_trie(root2, lambda k, v, b: None)
    s.close()
    for n in (n1, n2):
        if hasattr(n, "close"):
            n.close()
    got = list(db.iterate())
    db.close()
    return count, got, counting.calls, root2


def test_segmented_resume_after_crash_and_pivot_on_sqlite(tmp_path):
    from coreth_tpu_torch.trie.triedb import TrieDatabase

    (pc, pstore, pcalls, root2) = _segmented_run("coreth_tpu_torch",
                                                 tmp_path)
    (rc, rstore, _rcalls, rroot2) = _segmented_run("coreth_tpu", tmp_path)
    assert root2 == rroot2 and pc == rc == 701
    assert pstore == rstore
    # the resume fetched less than the whole trie (markers honoured)
    assert pcalls < 701 // 40 + 4 + 1
    from coreth_tpu_torch.ethdb import memorydb_from_items
    from coreth_tpu_torch.trie.iterator import iterate_leaves

    t = TrieDatabase(memorydb_from_items(pstore)).open_trie(root2)
    assert sum(1 for _ in iterate_leaves(t)) == 701


# --------------------------------------------------- transport and peers


class _Sink:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


def test_transport_frames_are_the_references():
    from coreth_tpu.peer import transport as jt
    from coreth_tpu_torch.peer import transport as pt

    for kind, rid, payload in ((0, 1, b""), (1, 2**63 + 5, b"\x00" * 700),
                               (2, 0, b"gossip")):
        a, b = _Sink(), _Sink()
        pt._write_frame(a, threading.Lock(), kind, rid, payload)
        jt._write_frame(b, threading.Lock(), kind, rid, payload)
        assert a.data == b.data
        import socket

        x, y = socket.socketpair()
        x.sendall(b.data)
        assert pt._read_frame(y) == (kind, rid, payload)
        x.close()
        y.close()


def test_transport_round_trip_reconnect_and_stop_joins_every_thread():
    """Requests and gossip over TCP, a severed connection re-dialled,
    then stop() and close() join every thread they started (the
    reference's stop joins none: ROADMAP Queue 3)."""
    from coreth_tpu_torch.metrics import default_registry
    from coreth_tpu_torch.peer.network import Network
    from coreth_tpu_torch.peer.testing import DisruptiveServer
    from coreth_tpu_torch.peer.transport import dial

    before = set(threading.enumerate())
    seen = []
    srv = DisruptiveServer(lambda s, r: r[::-1],
                           gossip_handler=lambda s, p: seen.append(p))
    port = srv.serve()
    peer = dial("127.0.0.1", port, timeout=5)
    net = Network()
    net.connect(b"p", peer)
    assert net.send_request(b"p", b"abc") == b"cba"
    peer.gossip(b"hello")
    # gossip is fire-and-forget: let the server read it before the
    # connection is severed, or the sever may drop it in flight
    deadline = time.time() + 5
    while not seen and time.time() < deadline:
        time.sleep(0.01)
    reconnects = default_registry.counter("peer/reconnects").count()
    deadline = time.time() + 5
    while srv.sever_all() == 0 and time.time() < deadline:
        time.sleep(0.01)
    for _ in range(50):
        try:
            assert peer(b"me", b"xyz") == b"zyx"
            break
        except Exception:  # noqa: BLE001 - the request that died with it
            time.sleep(0.02)
    assert default_registry.counter("peer/reconnects").count() > reconnects
    assert seen == [b"hello"]
    peer.close()
    net.close()
    assert srv.stop() == []
    assert not _new_threads(before), _new_threads(before)


def _ladder_run(pkg):
    """Three peers over one honest leafs handler of pkg's own small trie:
    A scripted [drop, corrupt], B [corrupt], C dropping and corrupting
    in turn forever. Three leafs requests, the trackers' state after
    each; then one that only C may answer."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    tdb, root = _segment_world(pkg, 60)
    h = m("sync.handlers").LeafsRequestHandler(tdb)

    def honest(sender, req):
        return h.on_leafs_request(
            m("sync.messages").LeafsRequest.decode(req[1:])).encode()

    FT = m("peer.testing").FaultyTransport
    net = m("peer.network").Network(self_id=b"client")
    net.connect(b"A", FT(honest, ["drop", "corrupt"]))
    net.connect(b"B", FT(honest, ["corrupt"]))
    net.connect(b"C", FT(honest, ["drop", "corrupt"], cycle=True))
    client = m("sync.client").SyncClient(net, max_attempts=8,
                                         backoff_base=0.0005,
                                         backoff_cap=0.001)
    out = []
    for limit in (1024, 10, 1024):
        resp = client.get_leafs(root, limit=limit)
        out.append((len(resp.keys), resp.more, resp.peer))
        out.append({nid: {k: v for k, v in st.items()
                          if k not in ("bandwidth", "quarantineRemaining")}
                    for nid, st in net.tracker.status().items()})
    # C, never chosen once the others answered, forced by exclusion: it
    # fails every attempt, is quarantined, and the request gives up
    try:
        client.get_leafs(root, exclude={b"A", b"B"})
        out.append("answered")
    except m("sync.client").ClientError as e:
        out.append(str(e))
    c = net.tracker.status()[b"C".hex()]
    out.append((c["state"], c["strikes"], c["failKinds"]))
    if hasattr(net, "close"):
        net.close()
    return out


def test_faulty_scripts_rotate_and_quarantine_like_the_reference():
    got, want = _ladder_run("coreth_tpu_torch"), _ladder_run("coreth_tpu")
    assert got == want
    # A: a drop and a proof rejection; B rejected once, then served
    first = got[1]
    assert first[b"A".hex()]["failKinds"] == {"transport": 1, "proof": 1}
    assert first[b"B".hex()]["failKinds"] == {"proof": 1}
    assert got[-2] == "exhausted retries: invalid proof: full-range root mismatch"
    assert got[-1][0] == "quarantined" and got[-1][1] >= 1


# ------------------------------------------------------------ atomic trie


def test_atomic_syncer_reaches_the_reference_atomic_root():
    """The same atomic ops indexed in each package's AtomicTrie and
    committed; the port's AtomicSyncer rebuilds that root from the port's
    leafs handler, marks it committed at the height, and iterates the
    same ops; the reference's syncer over the reference's trie agrees."""
    out = {}
    for pkg in ("coreth_tpu", "coreth_tpu_torch"):
        m = lambda name, p=pkg: importlib.import_module(f"{p}.{name}")  # noqa
        at_mod, sm = m("vm.atomic_trie"), m("vm.shared_memory")
        src = at_mod.AtomicTrie(m("ethdb").MemoryDB(), commit_interval=4)
        for h in range(1, 9):
            req = sm.Requests(put_requests=[sm.Element(
                key=h.to_bytes(32, "big"), value=b"utxo%d" % h,
                traits=[ADDR])], remove_requests=[b"\x01" * 32] if h % 3
                else [])
            src.index(h, {bytes([0x58 + h % 2]) * 32: req})
        assert src.last_committed_height == 8
        h = m("sync.handlers").LeafsRequestHandler(src.triedb)
        net = m("peer.network").Network(self_id=b"client")
        net.connect(b"s", lambda s, r, h=h, m=m: h.on_leafs_request(
            m("sync.messages").LeafsRequest.decode(r[1:])).encode())
        dst_db = m("ethdb").MemoryDB()
        syncer = at_mod.AtomicSyncer(m("sync.client").SyncClient(net),
                                     dst_db, src.last_committed_root, 8)
        syncer.sync()
        reopened = at_mod.AtomicTrie(dst_db, commit_interval=4)
        out[pkg] = (src.last_committed_root,
                    syncer.trie.last_committed_root,
                    reopened.last_committed_height,
                    [(hh, c, r.put_requests[0].value)
                     for hh, c, r in reopened.iterate()])
        if hasattr(net, "close"):
            net.close()
    assert out["coreth_tpu_torch"] == out["coreth_tpu"]
    root, synced, height, ops = out["coreth_tpu_torch"]
    assert synced == root and height == 8 and len(ops) == 8
