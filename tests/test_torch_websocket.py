"""The port's WebSocket transport (coreth_tpu_torch/rpc/websocket.py,
ethclient/ws.py, vm/api.py:serve_ws) against the JAX package's, on the
CPU: a twin of tests/test_websocket.py and of
tests/test_rpc_overload.py::TestWSBackpressure.

The frame codec writes the reference's bytes and reads the reference's
frames. One VM of each package (tests/torch_rpc_twin.Node; the port's on
device="cpu", with the keccak256Batch precompile) serves WebSocket
beside its create_handlers server (one backend and one filter stack);
the same transactions, signed once with the reference's Signer, reach
both, and every request and every eth_subscription push over WS must
decode to equal JSON on both (subscription ids aside: each server mints
its own). The backpressure drill runs on a bare RPCServer of each
package and must move the same counters. The port's WSServer.stop()
joins every thread it started (ROADMAP Queue 3).
"""

import importlib
import json
import socket
import threading
import time

import pytest

from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.rpc import websocket as jws
from coreth_tpu_torch import fault
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.ops import device as pdevice
from coreth_tpu_torch.rpc import websocket as pws

import torch_rpc_twin as tw

PKGS = ("coreth_tpu", "coreth_tpu_torch")
WS_THREADS = ("ws-accept", "ws-conn", "ws-notify")


@pytest.fixture(autouse=True)
def _port_isolation():
    yield
    fault.clear_all()
    pdevice.default_ladder().reset()


# ------------------------------------------------------------ frame codec

@pytest.mark.parametrize("size", [0, 5, 125, 126, 65535, 65536, 70000])
def test_frames_equal_and_cross_read(size):
    """Unmasked frames of every length class are the reference's bytes;
    masked frames of either package read back on the other."""
    payload = bytes(range(256)) * (size // 256) + bytes(size % 256)
    for writer, reader in ((pws, jws), (jws, pws)):
        for mask in (False, True):
            a, b = socket.socketpair()
            try:
                writer.write_frame(a, pws.OP_TEXT, payload, mask=mask)
                assert reader.read_frame(b) == (pws.OP_TEXT, payload)
            finally:
                a.close()
                b.close()
    raw = []
    for mod in (jws, pws):
        a, b = socket.socketpair()
        mod.write_frame(a, mod.OP_PING, payload)
        a.close()
        buf = b""
        while True:
            chunk = b.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
        b.close()
        raw.append(buf)
    assert raw[1] == raw[0]


def test_fragments_and_frame_too_large():
    """A fragmented message is concatenated; a frame over max_payload is
    refused from its declared length, before its payload is read."""
    a, b = socket.socketpair()
    try:
        a.sendall(bytes([pws.OP_TEXT, 3]) + b"abc" + bytes([0x80, 2]) + b"de")
        assert pws.read_frame(b) == (pws.OP_TEXT, b"abcde")
        a.sendall(bytes([0x80 | pws.OP_TEXT, 126]) + (300).to_bytes(2, "big"))
        with pytest.raises(pws.FrameTooLarge, match="300 > 100"):
            pws.read_frame(b, max_payload=100)
        assert issubclass(pws.FrameTooLarge, ConnectionError)
    finally:
        a.close()
        b.close()
    assert pws._accept_key("dGhlIHNhbXBsZSBub25jZQ==") == (
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=")  # RFC 6455 section 1.3


def test_token_bucket_matches_reference():
    """ws-cpu-refill-rate / ws-cpu-max-stored: the same capacity clamp,
    and a drained bucket waits for its refill."""
    for rate, cap in ((0, 0), (50.0, 0.5), (200.0, 3)):
        pb, jb = pws._TokenBucket(rate, cap), jws._TokenBucket(rate, cap)
        assert (pb.rate, pb.cap, pb.tokens) == (jb.rate, jb.cap, jb.tokens)
    b = pws._TokenBucket(200.0, 3)
    t0 = time.monotonic()
    for _ in range(5):  # 3 stored, then two refills of 5 ms
        b.take()
    assert time.monotonic() - t0 >= 0.008


# ------------------------------------------------------------- the twin

class WSTwin:
    def __init__(self):
        self.node = {p: tw.Node(p, {"ws-notify-queue-size": 16},
                                precompile=True) for p in PKGS}
        self.ws, self.port = {}, {}
        for p, n in self.node.items():
            api = importlib.import_module(f"{p}.vm.api")
            self.ws[p], self.port[p] = api.serve_ws(n.vm, rpc_server=n.server)
        self.nonce = 0

    def clients(self, kind="WSClient"):
        out = {}
        for p in PKGS:
            if kind == "WSClient":
                mod = importlib.import_module(f"{p}.rpc.websocket")
                out[p] = mod.WSClient("127.0.0.1", self.port[p])
            else:
                mod = importlib.import_module(f"{p}.ethclient")
                out[p] = mod.ws_connect("127.0.0.1", self.port[p])
        return out

    def tx(self, to, gas=21000, value=0, data=b""):
        t = JSigner(tw.CHAIN_ID).sign(JTransaction(
            type=2, chain_id=tw.CHAIN_ID, nonce=self.nonce, max_fee=10**12,
            max_priority_fee=10**9, gas=gas, to=to, value=value, data=data),
            tw.KEY)
        self.nonce += 1
        return t

    def block(self, *txs):
        for p in PKGS:
            self.node[p].submit([t.encode() for t in txs])
        blks = [self.node[p].build_and_accept() for p in PKGS]
        assert blks[1].bytes() == blks[0].bytes()
        return blks[1]

    def shutdown(self):
        for p in PKGS:
            self.ws[p].stop()
            self.node[p].shutdown()


@pytest.fixture(scope="module")
def twin():
    t = WSTwin()
    yield t
    t.shutdown()


def _same(got):
    assert got["coreth_tpu_torch"] == got["coreth_tpu"], got
    return got["coreth_tpu_torch"]


def _push(n):
    """A push without its connection-scoped subscription id."""
    assert n["method"] == "eth_subscription"
    return n["params"]["result"]


def test_requests_over_ws(twin):
    cs = twin.clients()
    blob = "ab" * 40000  # > 64 KiB: the 8-byte length
    for method, params in (("web3_clientVersion", []),
                           ("eth_blockNumber", []), ("eth_chainId", []),
                           ("web3_sha3", ["0x" + blob]),
                           ("eth_getBalance", ["0x" + tw.ADDR.hex(),
                                               "latest"])):
        _same({p: c.request(method, params) for p, c in cs.items()})
    for p, c in cs.items():
        with pytest.raises(RuntimeError):
            c.request("eth_subscribe", ["syncing2000"])
        with pytest.raises(RuntimeError):
            c.request("eth_nope")
        c.close()


def test_pushes_equal_the_chain(twin):
    """newHeads, logs (an address criterion) and newPendingTransactions
    on one connection each side: the same pushes from both, each head
    the accepted block's hash, number and root, each log the receipt's,
    one pending push per transaction."""
    cs = twin.clients()
    subs = {p: [c.request("eth_subscribe", ["newHeads"]),
                c.request("eth_subscribe", ["logs", {
                    "address": "0x" + tw.EMITTER_ADDR.hex()}]),
                c.request("eth_subscribe", ["newPendingTransactions"])]
            for p, c in cs.items()}
    t1 = twin.tx(tw.DEST, value=5)
    t2 = twin.tx(tw.EMITTER_ADDR, gas=100_000)
    blk = twin.block(t1, t2)
    got = {p: [c.next_notification() for _ in range(4)]
           for p, c in cs.items()}
    for p in PKGS:  # routed to the connection's own ids
        assert {n["params"]["subscription"] for n in got[p]} <= set(subs[p])
    pushes = _same({p: sorted((json.dumps(_push(n), sort_keys=True)
                               for n in got[p])) for p in PKGS})
    items = [json.loads(x) for x in pushes]
    pending = sorted(x for x in items if isinstance(x, str))
    assert pending == sorted("0x" + t.hash().hex() for t in (t1, t2))
    head, = [x for x in items if isinstance(x, dict) and "number" in x]
    eth = blk.eth_block
    assert (head["hash"], int(head["number"], 16), head["stateRoot"]) == (
        "0x" + blk.id().hex(), eth.number, "0x" + eth.header.root.hex())
    log, = [x for x in items if isinstance(x, dict) and "topics" in x]
    receipt = twin.node["coreth_tpu_torch"].result(
        "eth_getTransactionReceipt", "0x" + t2.hash().hex())
    assert log == receipt["logs"][0]
    for p, c in cs.items():
        assert c.request("eth_unsubscribe", [subs[p][0]]) is True
        assert c.request("eth_unsubscribe", [subs[p][0]]) is False
    twin.block(twin.tx(tw.DEST, value=1))
    for p, c in cs.items():  # only the pending push: newHeads is gone
        n = c.next_notification()
        assert n["params"]["subscription"] == subs[p][2]
        with pytest.raises(OSError):
            c.next_notification(timeout=0.3)
        c.close()


def test_ws_eth_client_subscriptions(twin):
    """ethclient.ws_connect: two subscriptions and plain requests on one
    connection, pushes routed by id; unsubscribe stops them; a closed
    connection fails the next read."""
    cs = twin.clients("WSEthClient")
    heads = {p: c.subscribe_new_heads() for p, c in cs.items()}
    logs = {p: c.subscribe_logs({}) for p, c in cs.items()}
    blk = twin.block(twin.tx(tw.DEST, value=9))
    got = _same({p: h.next(timeout=10) for p, h in heads.items()})
    assert got["hash"] == "0x" + blk.id().hex()
    for p, c in cs.items():
        assert logs[p]._q.qsize() == 0  # a transfer logs nothing
        assert int(c.request("eth_blockNumber"), 16) == blk.height()
        assert heads[p].unsubscribe() is True
        assert heads[p].unsubscribe() is False
    twin.block(twin.tx(tw.DEST, value=9))
    for p, c in cs.items():
        mod = importlib.import_module(f"{p}.ethclient.ws")
        with pytest.raises(mod.WSSubscriptionError):
            heads[p].next(timeout=0.3)
        c.close()
        with pytest.raises(mod.WSSubscriptionError):
            logs[p].next(timeout=5)


def test_keccak_batch_eth_call_over_ws(twin):
    """The keccak256Batch eth_call over WS: the same answer from both,
    the digests native keccak256's (on the port: the precompile through
    the head state's seam, K2's plain version on the CPU); a failing
    dispatch reaches the WS client as an error object, the ladder
    healthy."""
    from coreth_tpu_torch.accounts.abi import ABI
    from coreth_tpu_torch.precompile import TPU_KECCAK_ADDR

    abi = ABI([{"type": "function", "name": "keccak256Batch",
                "stateMutability": "view",
                "inputs": [{"name": "data", "type": "bytes[]"}],
                "outputs": [{"name": "", "type": "bytes32[]"}]}])
    msgs = [bytes([i]) * (40 + i) for i in range(64)]
    call = {"to": "0x" + TPU_KECCAK_ADDR.hex(),
            "data": "0x" + abi.pack("keccak256Batch", msgs).hex()}
    cs = twin.clients()
    out = _same({p: c.request("eth_call", [call, "latest"])
                 for p, c in cs.items()})
    assert abi.unpack("keccak256Batch", bytes.fromhex(out[2:])) == [
        [keccak256(m) for m in msgs]]
    fault.set_failpoint("ops/device/dispatch", "raise*1")
    with pytest.raises(RuntimeError, match="ops/device/dispatch"):
        cs["coreth_tpu_torch"].request("eth_call", [call, "latest"])
    assert pdevice.default_ladder().healthy
    assert cs["coreth_tpu_torch"].request("eth_call", [call, "latest"]) == out
    for c in cs.values():
        c.close()


def test_close_and_dead_client_clean_subscriptions(twin):
    """A closed connection and one whose socket died without a close
    frame both lose their subscriptions; accepting goes on."""
    for p in PKGS:
        filters = twin.node[p].vm.eth_backend.filters
        mod = importlib.import_module(f"{p}.rpc.websocket")
        c = mod.WSClient("127.0.0.1", twin.port[p])
        c.request("eth_subscribe", ["newHeads"])
        dead = mod.WSClient("127.0.0.1", twin.port[p])
        dead.request("eth_subscribe", ["newHeads"])
        assert len(filters._subscribers) == 2
        c.close()
        dead.sock.close()
    twin.block(twin.tx(tw.DEST, value=3))
    twin.block(twin.tx(tw.DEST, value=3))
    for p in PKGS:
        filters = twin.node[p].vm.eth_backend.filters
        deadline = time.time() + 5
        while filters._subscribers and time.time() < deadline:
            time.sleep(0.02)
        assert not filters._subscribers, p


def test_http_and_ws_share_one_backend(twin):
    """A filter installed over WS is read over the create_handlers
    server: one backend, one filter stack."""
    cs = twin.clients()
    fids = {p: c.request("eth_newBlockFilter") for p, c in cs.items()}
    blk = twin.block(twin.tx(tw.DEST, value=4))
    assert _same({p: twin.node[p].result("eth_getFilterChanges", fids[p])
                  for p in PKGS}) == ["0x" + blk.id().hex()]
    for c in cs.values():
        c.close()


# -------------------------------------------------------- backpressure

def _ws_stack(pkg, notify_queue_size):
    server_mod = importlib.import_module(f"{pkg}.rpc.server")
    ws_mod = importlib.import_module(f"{pkg}.rpc.websocket")
    srv = server_mod.RPCServer()
    feeds = []

    def factory(notify, *params):
        feeds.append(notify)
        return None

    srv.register_subscription("eth", "newHeads", factory)
    ws = ws_mod.WSServer(srv, notify_queue_size=notify_queue_size)
    return ws, ws.serve(), feeds, ws_mod


def _drill(pkg):
    """tests/test_rpc_overload.py's slow-client drill on `pkg`: the
    counters it moves and what a healthy second client then gets."""
    fmod = importlib.import_module(f"{pkg}.fault")
    reg = importlib.import_module(f"{pkg}.metrics").default_registry

    def count(name):
        return reg.counter(name).count()

    def fired():
        return sum(a["fired"] for a in fmod.list_armed()
                   if a["name"] == "ws/before_notify")

    ws, port, feeds, mod = _ws_stack(pkg, notify_queue_size=2)
    names = ("rpc/ws/notify_drops", "rpc/ws/slow_disconnects")
    before = {n: count(n) for n in names}
    try:
        c1 = mod.WSClient("127.0.0.1", port)
        c1.request("eth_subscribe", ["newHeads"])
        fmod.set_failpoint("ws/before_notify", "hang")
        feeds[0]({"n": 0})  # the writer dequeues it and parks
        deadline = time.monotonic() + 10
        while fired() < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        t0 = time.monotonic()
        for i in range(1, 5):  # fills the queue (2), then overflows
            feeds[0]({"n": i})
        assert time.monotonic() - t0 < 1.0, "producer must never block"
        moved = {n: count(n) - before[n] for n in names}
        with pytest.raises((ConnectionError, OSError)):
            while True:  # the slow client is torn down, not wedged
                c1.next_notification(timeout=5.0)
        c2 = mod.WSClient("127.0.0.1", port)
        c2.request("eth_subscribe", ["newHeads"])
        fmod.set_failpoint("ws/before_notify", None)
        feeds[1]({"fresh": True})
        note = c2.next_notification(timeout=10.0)["params"]["result"]
        c2.close()
    finally:
        fmod.set_failpoint("ws/before_notify", None)
        ws.stop()
    return moved, note, len(feeds)


def test_slow_client_disconnected_like_reference():
    got = {p: _drill(p) for p in PKGS}
    assert got["coreth_tpu_torch"] == got["coreth_tpu"]
    assert got["coreth_tpu_torch"] == (
        {"rpc/ws/notify_drops": 2, "rpc/ws/slow_disconnects": 1},
        {"fresh": True}, 2)


@pytest.mark.parametrize("pkg", PKGS)
def test_queue_size_zero_keeps_direct_writes(pkg):
    ws, port, feeds, mod = _ws_stack(pkg, notify_queue_size=0)
    try:
        c = mod.WSClient("127.0.0.1", port)
        c.request("eth_subscribe", ["newHeads"])
        feeds[0]({"direct": 1})
        assert c.next_notification(timeout=10.0)["params"]["result"] == {
            "direct": 1}
        c.close()
    finally:
        ws.stop()


def _ws_threads(before=()):
    return [t for t in threading.enumerate()
            if t.name in WS_THREADS and t.is_alive() and t not in before]


def test_stop_joins_every_thread():
    """ROADMAP Queue 3: stop() returns with no thread of the server left,
    the accept thread, two connections' readers and a notify writer
    parked in a failpoint included (the reference closes the sockets and
    joins nothing)."""
    before = set(_ws_threads())  # the module twin's servers
    ws, port, feeds, mod = _ws_stack("coreth_tpu_torch", notify_queue_size=4)
    clients = [mod.WSClient("127.0.0.1", port) for _ in range(2)]
    for c in clients:
        c.request("eth_subscribe", ["newHeads"])
    assert sorted(t.name for t in _ws_threads(before)) == [
        "ws-accept", "ws-conn", "ws-conn", "ws-notify", "ws-notify"]
    fault.set_failpoint("ws/before_notify", "hang:400*1")
    feeds[0]({"n": 0})
    deadline = time.monotonic() + 5
    while not fault.list_armed()[0]["fired"] and time.monotonic() < deadline:
        time.sleep(0.005)
    t0 = time.monotonic()
    ws.stop()
    left = _ws_threads(before)
    assert not left, [t.name for t in left]
    assert time.monotonic() - t0 < 5
    for c in clients:
        c.close()


def test_serve_ws_honours_the_knobs():
    """The three ws-* knobs reach the WSServer as on the reference (the
    body cap from rpc-body-limit); a throttled connection still serves."""
    cfg = {"ws-cpu-refill-rate": 500, "ws-cpu-max-stored": 2,
           "ws-notify-queue-size": 3, "rpc-body-limit": 4096}
    nodes = {p: tw.Node(p, cfg) for p in PKGS}
    got = {}
    try:
        for p, n in nodes.items():
            api = importlib.import_module(f"{p}.vm.api")
            ws, port = api.serve_ws(n.vm)  # its own create_handlers server
            mod = importlib.import_module(f"{p}.rpc.websocket")
            c = mod.WSClient("127.0.0.1", port)
            answers = [c.request("eth_chainId") for _ in range(5)]
            c.close()
            ws.stop()
            got[p] = ((ws.refill_rate, ws.max_stored, ws.notify_queue_size,
                       ws.max_payload), answers)
    finally:
        for n in nodes.values():
            n.shutdown()
    assert _same(got) == ((500, 2, 3, 4096), [hex(tw.CHAIN_ID)] * 5)
