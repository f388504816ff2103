"""The out-of-process VM boundary of the port (coreth_tpu_torch/plugin/)
against the JAX package's (coreth_tpu/plugin/), on the CPU.

- protocol: the frames of both packages are byte-equal, each decodes the
  other's, and both refuse an oversized or cut frame alike.
- VMServer.dispatch: a VM of each package, one genesis, the same signed
  blocks, served in process; every method of the snowman and state-sync
  surface answers the same (a block lifecycle accepted, another
  rejected, the errors' texts).
- The flagship across a real process boundary (twin of
  tests/test_plugin_process.py:75): the port's VM runs in a child
  process on device="cpu" (this file run as a script, under an import
  guard that refuses jax, jaxlib, coreth_tpu and cryptography) and serves
  its socket; a port client VM state-syncs through RemoteVM.app_request
  to the remote summary, the remote VM builds, verifies and accepts one
  more block at the engine's request (its bytes the in-process twins'),
  and the client takes it.
- Errors cross the boundary as RemoteVMError and the connection survives
  them (twin of :126).
- After `shutdown` the child exits 0; its VMServer joined its connection
  threads (ROADMAP Queue 3: the reference's are daemon threads nothing
  joins) and nothing of the forbidden packages was loaded.

One module-scoped child serves every process-boundary case.
"""

import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest

PKGS = ("coreth_tpu", "coreth_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "coreth_tpu", "cryptography")
KEY = b"\x11" * 32
ADDR = bytes.fromhex("19e7e376e7c213b7e7e7e46cc70a5dd086daff2a")
DEST = b"\xbb" * 20
EOAS = [bytes([0xe0 + i % 16]) + i.to_bytes(19, "big") for i in range(24)]
FUND = 10**24
CHAIN_ID = 43112
N_BLOCKS = 4
SERVER_KNOBS = {"commit-interval": 4, "device-hasher": "off"}
SYNC_KNOBS = {"sync-max-attempts": 6, "sync-backoff-base": 0.001,
              "sync-backoff-cap": 0.005}


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def boot(pkg, knobs):
    """A VM of `pkg` on one genesis and clock; the port's on
    device="cpu"."""
    g = mod(pkg, "core.genesis")
    params = mod(pkg, "params")
    alloc = {ADDR: g.GenesisAccount(balance=FUND)}
    for i, a in enumerate(EOAS):
        alloc[a] = g.GenesisAccount(balance=10**15 + i, nonce=i % 3)
    genesis = g.Genesis(config=params.TEST_CHAIN_CONFIG,
                        gas_limit=params.CORTINA_GAS_LIMIT, alloc=alloc)
    vm = mod(pkg, "vm.vm").VM()
    kw = {"device": "cpu"} if pkg == "coreth_tpu_torch" else {}
    vm.initialize(
        mod(pkg, "vm.vm").SnowContext(
            shared_memory=mod(pkg, "vm.shared_memory").Memory()),
        mod(pkg, "ethdb").MemoryDB(), genesis,
        config_bytes=json.dumps(knobs).encode(), **kw)
    vm.miner.clock = lambda: vm.blockchain.current_block.time + 2
    return vm


def build(pkg, vm, raws):
    """One block of `raws` through the VM: issue, build, verify,
    preference, accept."""
    T = mod(pkg, "core.types").Transaction
    for r in raws:
        vm.issue_tx(T.decode(r))
    blk = vm.build_block()
    blk.verify()
    vm.set_preference(blk.id())
    blk.accept()
    vm.blockchain.drain_acceptor_queue()
    return blk


def world(vm):
    """Balances and nonces at the last accepted block."""
    chain = vm.blockchain
    st = chain.state_at(chain.last_accepted.root)
    return {a: (st.get_balance(a), st.get_nonce(a))
            for a in [ADDR, DEST] + EOAS}


# ------------------------------------------------------------ the child


def _child(sock_path: str, spec_path: str) -> None:
    """The VM process: the port's VM on the CPU, the spec's blocks
    accepted, served on `sock_path` until an engine asks for shutdown."""

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

    from coreth_tpu_torch.plugin import VMServer

    spec = json.load(open(spec_path))
    vm = boot("coreth_tpu_torch", SERVER_KNOBS)
    for raws in spec["blocks"]:
        build("coreth_tpu_torch", vm, [bytes.fromhex(r) for r in raws])
    srv = VMServer(vm, sock_path)
    try:
        srv.serve_forever()
    finally:
        vm.shutdown()
    print("SERVER-THREADS-LEFT " + json.dumps(srv.threads_left))
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            t.name.startswith("plugin-conn") for t in threading.enumerate()):
        time.sleep(0.02)
    print("THREADS " + json.dumps(sorted(
        t.name for t in threading.enumerate()
        if t is not threading.main_thread())))
    leaked = [m for m in sys.modules if refused(m)]
    assert not leaked, leaked
    print("ISOLATED-OK", flush=True)


# ------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def signed():
    """Reference-signed raw transactions: N_BLOCKS blocks of three, then
    one for the remote block and one for the rejected block."""
    from coreth_tpu.core.types import Signer, Transaction

    signer = Signer(CHAIN_ID)
    out, nonce = [], 0
    for b in range(N_BLOCKS + 2):
        blk = []
        for _ in range(3 if b < N_BLOCKS else 1):
            blk.append(signer.sign(Transaction(
                type=2, chain_id=CHAIN_ID, nonce=nonce, max_fee=10**12,
                max_priority_fee=10**9, gas=21000,
                to=EOAS[nonce % len(EOAS)] if nonce % 2 else DEST,
                value=3 + nonce), KEY).encode())
            nonce += 1
        out.append(blk)
    return out


@pytest.fixture(scope="module")
def child(signed, tmp_path_factory):
    """The port's VM process, started early (it boots while the in-process
    cases run). The socket lives in a short temporary directory of its
    own: a unix socket's path must stay under 108 bytes."""
    d = tmp_path_factory.mktemp("plugin")
    spec = d / "spec.json"
    spec.write_text(json.dumps({"blocks": [[r.hex() for r in blk]
                                           for blk in signed[:N_BLOCKS]]}))
    sock_dir = tempfile.mkdtemp(prefix="plg")
    sock = os.path.join(sock_dir, "vm.sock")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), sock, str(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    yield proc, sock
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)
    proc.stdout.close()
    shutil.rmtree(sock_dir, ignore_errors=True)


@pytest.fixture(scope="module")
def remote(child):
    from coreth_tpu_torch.plugin import RemoteVM

    proc, sock = child
    deadline = time.monotonic() + 120
    while not os.path.exists(sock):
        if proc.poll() is not None:
            pytest.fail(f"plugin child died at boot:\n"
                        f"{proc.stdout.read()[-3000:]}")
        if time.monotonic() > deadline:
            pytest.fail("plugin child never opened its socket")
        time.sleep(0.05)
    r = RemoteVM(sock, connect_timeout=30)
    yield r
    r.close()


@pytest.fixture(scope="module")
def twins(signed):
    """{pkg: VMServer} over a VM of each package at height N_BLOCKS, in
    process (the servers' sockets are never opened)."""
    out = {}
    for pkg in PKGS:
        vm = boot(pkg, SERVER_KNOBS)
        for raws in signed[:N_BLOCKS]:
            build(pkg, vm, raws)
        out[pkg] = mod(pkg, "plugin").VMServer(vm, "unused.sock")
    assert out[PKGS[0]].vm.last_accepted().id() == \
        out[PKGS[1]].vm.last_accepted().id()
    yield out
    for srv in out.values():
        srv.vm.shutdown()


ERRORS = {}  # the in-process errors, held against the remote ones


def _answer(srv, method, params):
    try:
        return {"result": srv.dispatch(method, params)}
    except Exception as e:  # noqa: BLE001 — crosses the boundary as text
        return {"error": f"{type(e).__name__}: {e}"}


# ---------------------------------------------------------------- cases


def test_protocol_frames_are_byte_equal(child):
    from coreth_tpu.plugin import protocol as jp
    from coreth_tpu_torch.plugin import protocol as pp

    objs = [{"id": 1, "method": "handshake", "params": {}},
            {"id": 2, "result": {"id": pp.b2h(b"\x01" * 32), "height": 7,
                                 "bytes": pp.b2h(bytes(range(256)))}},
            {"id": 3, "error": "VMError: no pending transactions"},
            {"id": 4, "result": {"summary": None}}]
    for obj in objs:
        frames = []
        for m in (jp, pp):
            a, b = socket.socketpair()
            m.send_msg(a, obj)
            a.close()
            frames.append(b"".join(iter(lambda: b.recv(65536), b"")))
            b.close()
        assert frames[0] == frames[1]
        for m in (jp, pp):
            a, b = socket.socketpair()
            a.sendall(frames[0])
            assert m.recv_msg(b) == obj
            a.close()
            b.close()
    assert pp._MAX_FRAME == jp._MAX_FRAME == 64 * 1024 * 1024
    for m, err in ((jp, jp.ProtocolError), (pp, pp.ProtocolError)):
        a, b = socket.socketpair()
        a.sendall((m._MAX_FRAME + 1).to_bytes(4, "big"))
        with pytest.raises(err, match="frame too large"):
            m.recv_msg(b)
        a.sendall(b"\x00\x00\x00\x09{}")
        a.close()
        with pytest.raises(err, match="connection closed"):
            m.recv_msg(b)
        b.close()
    for v in (None, b"", b"\x00\xff"):
        assert pp.b2h(v) == jp.b2h(v)
    for s in (None, "0x", "0xabcd", "abcd"):
        assert pp.h2b(s) == jp.h2b(s)


def test_dispatch_answers_equal_the_reference(twins, signed):
    """Every method of the served surface, on both packages' VMServer
    over twin VMs: equal answers, a block built, verified and accepted,
    another built, verified and rejected, and the errors' texts."""
    from coreth_tpu_torch.native import keccak256
    from coreth_tpu_torch.sync import messages as msg

    port = twins[PKGS[1]]
    chain = port.vm.blockchain
    b2 = chain.get_block_by_number(2)
    b3 = chain.get_block_by_number(3)
    root, tip = chain.last_accepted.root, chain.last_accepted
    calls = [
        ("handshake", {}), ("lastAccepted", {}), ("health", {}),
        ("getBlock", {"id": "0x" + b2.hash().hex()}),
        ("parseBlock", {"bytes": "0x" + b3.encode().hex()}),
        ("getLastStateSummary", {}), ("getStateSummary", {"height": 4}),
        ("getStateSummary", {"height": 3}),
        ("appRequest", {"request": "0x" + msg.LeafsRequest(
            root, limit=9).encode().hex()}),
        ("appRequest", {"request": "0x" + msg.BlockRequest(
            tip.hash(), tip.number, 3).encode().hex()}),
        ("appRequest", {"request": "0x" + msg.CodeRequest(
            [keccak256(b"")]).encode().hex()}),
        ("buildBlock", {}),  # empty pool: an error
        ("blockVerify", {"id": "0x" + "00" * 32}),
        ("nope", {}),
    ]
    for method, params in calls:
        got = {pkg: _answer(srv, method, params)
               for pkg, srv in twins.items()}
        assert got[PKGS[1]] == got[PKGS[0]], (method, got)
        if "error" in got[PKGS[1]]:
            ERRORS[method] = got[PKGS[1]]["error"]
    assert set(ERRORS) == {"buildBlock", "blockVerify", "nope"}

    for raws, decision in ((signed[N_BLOCKS], "blockAccept"),
                           (signed[N_BLOCKS + 1], "blockReject")):
        ids = set()
        for pkg, srv in twins.items():
            assert srv.dispatch("issueTx", {"raw": "0x" + raws[0].hex()}) \
                == {}
        built = {pkg: srv.dispatch("buildBlock", {})
                 for pkg, srv in twins.items()}
        assert built[PKGS[1]] == built[PKGS[0]]
        bid = built[PKGS[1]]["id"]
        for step in ("blockVerify", "setPreference", decision):
            if step == "setPreference" and decision == "blockReject":
                continue
            for pkg, srv in twins.items():
                assert srv.dispatch(step, {"id": bid}) == {}
            ids.add(bid)
        got = {pkg: (srv.dispatch("lastAccepted", {}),
                     srv.dispatch("handshake", {}))
               for pkg, srv in twins.items()}
        assert got[PKGS[1]] == got[PKGS[0]]
        accepted = got[PKGS[1]][0]["id"] == bid
        assert accepted == (decision == "blockAccept")
    assert world(twins[PKGS[1]].vm) == world(twins[PKGS[0]].vm)
    assert all(srv.dispatch("shutdown", {}) == {} for srv in twins.values())


def test_state_sync_across_process_boundary(remote, twins, signed):
    """Twin of tests/test_plugin_process.py:75 on the port: a client VM
    syncs from the child through RemoteVM.app_request, then the child
    builds the next block at the engine's request and the client takes
    it; the summary and the block are the in-process twins' bytes."""
    from coreth_tpu_torch.peer.network import Network
    from coreth_tpu_torch.sync.client import SyncClient
    from coreth_tpu_torch.vm.syncervm import StateSyncClient

    ref = twins[PKGS[0]]
    assert remote.health()
    last = remote.last_accepted()
    assert last.height == N_BLOCKS
    assert remote.handshake() == last.id
    assert last.bytes == ref.vm.blockchain.get_block_by_number(
        N_BLOCKS).encode()
    summary = remote.get_last_state_summary()
    assert summary is not None and summary.block_number == N_BLOCKS
    want = ref.dispatch("getStateSummary", {"height": N_BLOCKS})["summary"]
    assert "0x" + summary.encode().hex() == want
    assert remote.get_state_summary(N_BLOCKS - 1) is None

    client = boot("coreth_tpu_torch", SYNC_KNOBS)
    net = Network(self_id=b"engine")
    net.connect(b"plugin", remote.app_request)
    try:
        StateSyncClient(client, SyncClient.from_config(
            net, client.full_config)).accept_summary(summary)
        chain = client.blockchain
        assert chain.last_accepted.hash() == summary.block_hash
        assert chain.current_block.number == N_BLOCKS

        # the next block across the boundary: issued, built, verified,
        # preferred and accepted remotely; the client ingests its bytes
        remote.issue_tx(signed[N_BLOCKS][0])
        blk = remote.build_block()
        assert blk.height == N_BLOCKS + 1 and blk.parent_id == last.id
        assert blk.bytes == ref.vm.blockchain.get_block_by_number(
            N_BLOCKS + 1).encode()
        assert remote.get_block(blk.id) == blk
        remote.block_verify(blk.id)
        remote.set_preference(blk.id)
        remote.block_accept(blk.id)
        assert remote.last_accepted().id == blk.id
        vmb = client.parse_block(blk.bytes)
        assert vmb.id() == blk.id
        vmb.verify()
        client.set_preference(vmb.id())
        vmb.accept()
        chain.drain_acceptor_queue()
        assert chain.last_accepted.hash() == blk.id
        assert world(client) == world(ref.vm)
    finally:
        client.shutdown()
        net.close()


def test_remote_errors_and_the_connection_survives(remote):
    """Twin of tests/test_plugin_process.py:126: an empty pool's build
    and an unknown block's verify fail loudly across the boundary, with
    the in-process reference's texts, and the connection still works."""
    from coreth_tpu_torch.plugin import RemoteVMError

    with pytest.raises(RemoteVMError) as e1:
        remote.build_block()
    with pytest.raises(RemoteVMError) as e2:
        remote.block_verify(b"\x00" * 32)
    with pytest.raises(RemoteVMError) as e3:
        remote.request("nope")
    if ERRORS:  # the dispatch case ran in this session
        assert [str(e.value) for e in (e1, e2, e3)] == [
            ERRORS["buildBlock"], ERRORS["blockVerify"], ERRORS["nope"]]
    assert remote.last_accepted().height == N_BLOCKS + 1


def test_child_exits_zero_after_shutdown(remote, child):
    """`shutdown` over the socket ends the child with 0: its VMServer
    joined every connection thread (a second, idle connection too), the
    VM shut down, and nothing of the forbidden packages was loaded."""
    from coreth_tpu_torch.plugin import RemoteVM

    proc, sock = child
    idle = RemoteVM(sock, connect_timeout=10)
    assert idle.health()
    remote.shutdown()
    assert proc.wait(timeout=60) == 0
    out = proc.stdout.read()
    idle.close()
    lines = dict(line.split(" ", 1) for line in out.splitlines()
                 if line.startswith(("SERVER-THREADS-LEFT ", "THREADS ")))
    assert json.loads(lines["SERVER-THREADS-LEFT"]) == []
    assert not [t for t in json.loads(lines["THREADS"])
                if t.startswith("plugin-conn")], out[-2000:]
    assert "ISOLATED-OK" in out


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])
