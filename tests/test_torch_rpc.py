"""The port's JSON-RPC serving tier (coreth_tpu_torch/{rpc,eth,ethclient},
vm/api.py, state/dump.py, metrics/{http,profiler}.py, utils/racecheck.py)
against the JAX package's, on the CPU.

A module-scoped twin of tests/test_api.py's live_vm: one VM of each
package (tests/torch_rpc_twin.Node; the port's on device="cpu") on the
same genesis, clock and transactions, signed once with the reference's
classes, each behind its own create_handlers(vm) server. Transactions
enter both by eth_sendRawTransaction and avax.issueTx. Every case sends
the same request to both servers and requires equal decoded JSON answers
(results and error objects alike): the eth namespace, the filters, the
tracers and the DSL scripts of tests/test_tracer_dsl.py, the parity
sweep, batch, method-not-found, HTTP and IPC transport, health, avax,
txpool, net and web3. Fields that differ by nature are compared by shape,
each with its reason beside it. A second twin runs with
resident-account-trie: its eth_getProof at the head walks the exported
resident delta, gives the reference's node lists, verifies against the
header root and leaves equal trie stores after the next accept.
"""

import json
import os
import re
import socket
import threading
import time
import urllib.request

import pytest

from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.evm import opcodes as OP
from coreth_tpu.vm import atomic_tx as jatx
from coreth_tpu_torch import fault
from coreth_tpu_torch import rlp as rlp
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.ops import device as pdevice
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.proof import verify_proof

import torch_rpc_twin as tw

PKGS = ("coreth_tpu", "coreth_tpu_torch")
UTXO = {"tx_id": b"\x01" * 32, "amount": 5 * 10**9, "address": tw.ADDR}


@pytest.fixture(autouse=True)
def _port_isolation():
    """The port's ladder and failpoints are process-global."""
    yield
    fault.clear_all()
    pdevice.default_ladder().reset()


def signed(nonce, to, gas=21000, value=0, data=b""):
    """A type-2 transaction signed once with the reference's signer."""
    return JSigner(tw.CHAIN_ID).sign(JTransaction(
        type=2, chain_id=tw.CHAIN_ID, nonce=nonce, max_fee=10**12,
        max_priority_fee=10**9, gas=gas, to=to, value=value, data=data),
        tw.KEY)


def import_tx(amount=4 * 10**9):
    """The reference's ImportTx of UTXO to DEST, signed once."""
    utxo = jatx.UTXO(tx_id=UTXO["tx_id"], output_index=0, asset_id=tw.AVAX,
                     amount=UTXO["amount"], address=UTXO["address"])
    tx = jatx.Tx(jatx.ImportTx(
        network_id=1337, blockchain_id=tw.C_CHAIN, source_chain=tw.X_CHAIN,
        imported_inputs=[utxo],
        outs=[jatx.EVMOutput(address=tw.DEST, amount=amount,
                             asset_id=tw.AVAX)]))
    tx.sign([tw.KEY])
    return tx


def _scrub(resp):
    """An error's trace id is minted per process (metrics/tracectx.py):
    held to its shape, then left out of the comparison."""
    err = resp.get("error")
    if not isinstance(err, dict):
        return resp
    data = err.get("data")
    if isinstance(data, dict) and "traceId" in data:
        assert re.fullmatch(r"rpc-[0-9a-f]+-[0-9a-f]+", data["traceId"])
        data["traceId"] = "rpc-*"
    err["message"] = re.sub(r"\[trace rpc-[0-9a-f]+-[0-9a-f]+\]",
                            "[trace rpc-*]", err["message"])
    return resp


class Twin:
    """A node of each package; every step on both."""

    def __init__(self, config=None, precompile=False):
        self.node = {p: tw.Node(p, config, utxos=[UTXO],
                                precompile=precompile) for p in PKGS}
        self.nonce = 0

    def same(self, method, *params):
        """Both servers' decoded answers to one request; equal."""
        got = [_scrub(self.node[p].rpc(method, *params)) for p in PKGS]
        assert got[1] == got[0], (method, params, got)
        return got[1]

    def result(self, method, *params):
        out = self.same(method, *params)
        assert "error" not in out, out
        return out["result"]

    def block(self, *txs, atomic=()):
        """txs and atomic txs in over RPC, then one block built, verified
        and accepted on both; the port's block."""
        for p in PKGS:
            got = self.node[p].submit([t.encode() for t in txs],
                                      [a.encode() for a in atomic])
            assert got == ["0x" + t.hash().hex() for t in txs] + [
                {"txID": "0x" + a.id().hex()} for a in atomic]
        blks = [self.node[p].build_and_accept() for p in PKGS]
        assert blks[1].bytes() == blks[0].bytes()
        return blks[1]

    def tx(self, to, gas=21000, value=0, data=b""):
        t = signed(self.nonce, to, gas, value, data)
        self.nonce += 1
        return t

    def shutdown(self):
        for n in self.node.values():
            n.shutdown()


@pytest.fixture(scope="module")
def twin():
    t = Twin(precompile=True)
    t1 = t.tx(tw.DEST, value=12345)
    b1 = t.block(t1)
    t2 = t.tx(tw.EMITTER_ADDR, gas=100_000)
    b2 = t.block(t2)
    t.reads = tw.read_requests(t1.hash(), t2.hash(), b1.id(), b2.id())
    t.t2, t.b2 = t2, b2
    yield t
    t.shutdown()


def _ids():
    reqs = tw.read_requests(b"\x00" * 32, b"\x00" * 32, b"\x00" * 32,
                            b"\x00" * 32)
    return [f"{i:03d}-{m}" for i, (m, _) in enumerate(reqs)]


# ------------------------------------------------------- the read requests


@pytest.mark.parametrize("i", range(len(_ids())), ids=_ids())
def test_read_request(twin, i):
    """One of tests/test_api.py's read requests (and the eth methods it
    leaves out) over blocks 1-2: the same decoded answer from both."""
    method, params = twin.reads[i]
    twin.same(method, *params)


def test_registry_and_subscriptions_equal(twin):
    """create_handlers registers the same method names and the same
    eth_subscribe kinds on both (served over WebSocket by serve_ws:
    tests/test_torch_websocket.py)."""
    j, p = (twin.node[x].server for x in PKGS)
    assert sorted(p._methods) == sorted(j._methods)
    assert sorted(p._sub_factories) == sorted(j._sub_factories)


def test_answers_match_test_api_expectations(twin):
    """The port's answers hold what tests/test_api.py asserts of the
    reference's."""
    n = twin.node["coreth_tpu_torch"]
    assert int(n.result("eth_chainId"), 16) == 43112
    blk = n.result("eth_getBlockByNumber", "0x2", True)
    assert blk["hash"] == "0x" + twin.b2.id().hex()
    assert n.result("eth_getTransactionReceipt",
                    "0x" + twin.t2.hash().hex())["status"] == "0x1"
    logs = n.result("eth_getLogs", {"fromBlock": "0x0", "toBlock": "0x2"})
    assert len(logs) == 1
    trace = n.result("debug_traceTransaction", "0x" + twin.t2.hash().hex())
    assert "LOG1" in [s["op"] for s in trace["structLogs"]]
    assert n.result("health_check")["healthy"] is True
    assert n.result("web3_sha3", "0x") == "0x" + keccak256(b"").hex()


def test_get_proof_verifies_against_header_root(twin):
    """eth_getProof's account and storage proofs verify against the
    block's header root with the port's trie/proof.verify_proof."""
    n = twin.node["coreth_tpu_torch"]
    head = n.result("eth_getBlockByNumber", "latest", False)
    emitter = "0x" + tw.EMITTER_ADDR.hex()
    proof = twin.result("eth_getProof", emitter, ["0x0"], "latest")
    _check_account_proof(head["stateRoot"], tw.EMITTER_ADDR, proof)


def _check_account_proof(state_root, addr, proof):
    db = {keccak256(b): b for b in (bytes.fromhex(x[2:])
                                    for x in proof["accountProof"])}
    val = verify_proof(bytes.fromhex(state_root[2:]), keccak256(addr), db)
    acct = rlp.decode(val)
    assert int.from_bytes(acct[0], "big") == int(proof["nonce"], 16)
    assert int.from_bytes(acct[1], "big") == int(proof["balance"], 16)
    assert "0x" + acct[2].hex() == proof["storageHash"]
    for sp in proof["storageProof"]:
        if acct[2] == EMPTY_ROOT:  # no storage: nothing to walk
            assert sp["proof"] == [] and sp["value"] == "0x0"
            continue
        sdb = {keccak256(b): b for b in (bytes.fromhex(x[2:])
                                         for x in sp["proof"])}
        got = verify_proof(acct[2], keccak256(bytes.fromhex(sp["key"][2:])),
                           sdb)
        want = int(sp["value"], 16)
        assert (int.from_bytes(rlp.decode(got), "big") if got else 0) == want


# ------------------------------------------------- ingress, avax, filters


def test_raw_and_atomic_ingress(twin):
    """Block 3's transactions enter both nodes over RPC: a transfer by
    eth_sendRawTransaction, an ImportTx by avax.issueTx. The atomic tx's
    status moves Processing -> Accepted in both."""
    atx = import_tx()
    tid = "0x" + atx.id().hex()
    twin.same("avax_getAtomicTxStatus", tid)          # Unknown
    for p in PKGS:
        twin.node[p].submit(raw_atomic=[atx.encode()])
    assert twin.result("avax_getAtomicTxStatus", tid) == {
        "status": "Processing"}
    twin.same("avax_getAtomicTx", tid)
    twin.same("avax_getUTXOs", ["0x" + tw.ADDR.hex()])
    t = twin.tx(tw.DEST, value=7)
    for p in PKGS:
        assert twin.node[p].result(
            "eth_sendRawTransaction", "0x" + t.encode().hex()) == \
            "0x" + t.hash().hex()
    twin.same("txpool_content")
    twin.same("txpool_inspect")
    blks = [twin.node[p].build_and_accept() for p in PKGS]
    assert blks[1].bytes() == blks[0].bytes()
    assert len(blks[1].atomic_txs) == 1
    assert twin.result("avax_getAtomicTxStatus", tid)["status"] == "Accepted"
    twin.same("avax_getAtomicTx", tid)
    twin.same("avax_getUTXOs", ["0x" + tw.ADDR.hex()])
    twin.same("eth_getBalance", "0x" + tw.DEST.hex(), "latest")
    twin.same("eth_getBlockByNumber", "latest", True)
    twin.same("eth_sendRawTransaction", "0x" + t.encode().hex())  # known
    twin.same("avax_issueTx", "0x" + atx.encode().hex())  # spent


def test_filters(twin):
    """Block, log and pending-tx filters on both, fed by the chain's
    accepted feed (acceptor thread) and the pool's new-tx feed: each
    filter sees the accepted block once. Filter ids are fresh uuids in
    each process: compared by shape, each answer by content."""
    emitter = "0x" + tw.EMITTER_ADDR.hex()
    ids = {p: {} for p in PKGS}
    for p in PKGS:
        n = twin.node[p]
        ids[p]["b"] = n.result("eth_newBlockFilter")
        ids[p]["l"] = n.result("eth_newFilter", {"address": emitter})
        ids[p]["t"] = n.result("eth_newPendingTransactionFilter")
        for fid in ids[p].values():
            assert re.fullmatch(r"0x[0-9a-f]{32}", fid), fid
    t = twin.tx(tw.EMITTER_ADDR, gas=100_000)
    blk = twin.block(t)
    got = {p: {k: twin.node[p].result("eth_getFilterChanges", fid)
               for k, fid in ids[p].items()} for p in PKGS}
    assert got["coreth_tpu_torch"] == got["coreth_tpu"]
    assert got["coreth_tpu_torch"]["b"] == ["0x" + blk.id().hex()]
    assert len(got["coreth_tpu_torch"]["l"]) == 1
    assert got["coreth_tpu_torch"]["t"] == ["0x" + t.hash().hex()]
    for p in PKGS:  # drained: nothing new
        assert twin.node[p].result("eth_getFilterChanges",
                                   ids[p]["b"]) == []
        assert twin.node[p].result("eth_uninstallFilter", ids[p]["b"])
        assert not twin.node[p].result("eth_uninstallFilter", ids[p]["b"])
    twin.same("eth_getFilterChanges", "0x" + "00" * 16)  # unknown id


def test_subscription_factories_push(twin):
    """The eth_subscribe kinds create_handlers registers, driven as the
    WebSocket transport drives them: the same JSON pushes from both for
    one pending tx and its accepted block."""
    pushed = {p: [] for p in PKGS}
    cleanups = []
    for p in PKGS:
        factories = twin.node[p].server._sub_factories
        for kind in ("eth_newPendingTransactions", "eth_newHeads",
                     "eth_logs"):
            cleanups.append(factories[kind](
                lambda item, p=p, kind=kind: pushed[p].append((kind, item))))
    t = twin.tx(tw.EMITTER_ADDR, gas=100_000)
    blk = twin.block(t)
    for c in cleanups:
        c()
    assert pushed["coreth_tpu_torch"] == pushed["coreth_tpu"]
    got = dict(pushed["coreth_tpu_torch"])
    assert [k for k, _ in pushed["coreth_tpu_torch"]] == [
        "eth_newPendingTransactions", "eth_newHeads", "eth_logs"]
    assert got["eth_newPendingTransactions"] == "0x" + t.hash().hex()
    assert got["eth_newHeads"]["hash"] == "0x" + blk.id().hex()


# ------------------------------------------------ state-changing sweeps


def test_storage_range_at_committed_storage(twin):
    """tests/test_api.py's committed-storage case: an untouched
    contract's stored slots, paged."""
    init = bytes([OP.PUSH1, 0xAA, OP.PUSH1, 0x00, OP.SSTORE,
                  OP.PUSH1, 0xBB, OP.PUSH1, 0x01, OP.SSTORE, OP.STOP])
    t = twin.tx(None, gas=300_000, data=init)
    twin.block(t)
    contract = twin.result("eth_getTransactionReceipt",
                           "0x" + t.hash().hex())["contractAddress"]
    blk2 = twin.block(twin.tx(tw.DEST, value=1))
    bh = "0x" + blk2.id().hex()
    page1 = twin.result("debug_storageRangeAt", bh, 0, contract, "0x", 1)
    assert len(page1["storage"]) == 1 and page1["nextKey"]
    page2 = twin.result("debug_storageRangeAt", bh, 0, contract,
                        page1["nextKey"], 10)
    assert len(page2["storage"]) == 1 and page2["nextKey"] is None
    twin.same("eth_getProof", contract, ["0x0", "0x1", "0x2"], "latest")
    twin.same("debug_dumpBlock", "latest", {"includeCode": True})


def test_storage_range_after_selfdestruct(twin):
    runtime = bytes([0x73]) + b"\x00" * 20 + bytes([0xFF])
    init = bytes([OP.PUSH1, 0xAA, OP.PUSH1, 0x00, OP.SSTORE])
    off = len(init) + 12
    init += bytes([OP.PUSH1, len(runtime), OP.PUSH1, off, OP.PUSH1, 0,
                   OP.CODECOPY, OP.PUSH1, len(runtime), OP.PUSH1, 0,
                   OP.RETURN]) + runtime
    t = twin.tx(None, gas=300_000, data=init)
    twin.block(t)
    contract = twin.result("eth_getTransactionReceipt",
                           "0x" + t.hash().hex())["contractAddress"]
    blk2 = twin.block(twin.tx(bytes.fromhex(contract[2:]), gas=100_000))
    bh = "0x" + blk2.id().hex()
    assert len(twin.result("debug_storageRangeAt", bh, 0, contract, "0x",
                           10)["storage"]) == 1
    assert twin.result("debug_storageRangeAt", bh, 1, contract, "0x",
                       10) == {"storage": {}, "nextKey": None}
    twin.same("debug_traceBlockByHash", bh, {"tracer": "prestateTracer"})
    twin.same("debug_getModifiedAccountsByHash", bh)


def test_bad_blocks_recorded_and_deduped(twin):
    """A block with a corrupt root is refused by both and recorded once
    (the flight record beside it carries timings: compared by shape)."""
    for p in PKGS:
        vm = twin.node[p].vm
        bad = type(twin.b2.eth_block).decode(
            vm.blockchain.get_block(twin.b2.id()).encode())
        bad.header.root = b"\xde" * 32
        for _ in range(2):
            with pytest.raises(Exception):
                vm.blockchain.insert_block(bad)
    got = [twin.node[p].result("debug_getBadBlocks") for p in PKGS]
    assert [b["hash"] for b in got[1]] == [b["hash"] for b in got[0]]
    assert len(got[1]) == 1
    for j, p in zip(got[0], got[1]):
        assert p["reason"] == j["reason"] and p["block"] == j["block"]


# ------------------------------------------- transports and the server


def test_batch_and_method_not_found(twin):
    batch = [{"jsonrpc": "2.0", "id": i, "method": m, "params": []}
             for i, m in enumerate(["eth_chainId", "eth_blockNumber",
                                    "eth_nope", "net_version"])]
    got = [twin.node[p].raw(batch) for p in PKGS]
    assert got[1] == got[0] and len(got[1]) == 4
    assert got[1][2]["error"]["code"] == -32601
    for bad in (b"{", b"[]", b'{"jsonrpc": "2.0", "id": 1}'):
        out = [json.loads(twin.node[p].server.handle_raw(bad))
               for p in PKGS]
        assert out[1] == out[0], out


def test_http_and_ipc_transport(twin, tmp_path):
    """The same request over HTTP (ethclient's Client) and over the IPC
    socket, on both servers."""
    from coreth_tpu_torch.ethclient import Client

    req = {"jsonrpc": "2.0", "id": 7, "method": "eth_getBlockByNumber",
           "params": ["0x2", True]}
    answers = []
    for p in PKGS:
        server = twin.node[p].server
        port = server.serve_http()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}", data=json.dumps(req).encode(),
                headers={"Content-Type": "application/json"}),
                timeout=10) as resp:
            answers.append(json.loads(resp.read()))
        client = Client(f"http://127.0.0.1:{port}")
        assert client.block_number() == int(
            twin.node[p].result("eth_blockNumber"), 16)
        assert client.batch_raw([("eth_chainId", []),
                                 ("net_version", [])]) == ["0xa868", "1337"]
        path = str(tmp_path / f"{p}.ipc")
        stop = server.serve_ipc(path)
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(path)
            f = s.makefile("rwb")
            f.write(json.dumps(req).encode() + b"\n")
            f.flush()
            answers.append(json.loads(f.readline()))
            s.close()
        finally:
            stop()
        assert not os.path.exists(path)
    assert answers[0] == answers[1] == answers[2] == answers[3]


def test_debug_surface_by_shape(twin):
    """The debug namespace's live-state methods: the same keys from both.
    Their values are this process's timings, counters and registry
    (metrics, flight records, spans, SLO series, the ladder's knobs: the
    port retries no device dispatch, ROADMAP Queue 3) or fresh ids, so
    only the shape is held equal; what the port must say is checked."""
    for method, params in (("debug_deviceStatus", []),
                           ("debug_rpcStatus", []),
                           ("debug_sloStatus", []),
                           ("debug_commitmentStatus", []),
                           ("debug_lockStatus", []),
                           ("debug_syncStatus", []),
                           ("debug_profileDump", [])):
        got = [twin.node[p].result(method, *params) for p in PKGS]
        # the port's ladder has no retry budget to report (it retries no
        # device dispatch: ROADMAP Queue 3)
        want = set(got[0]) - ({"max_retries"}
                              if method == "debug_deviceStatus" else set())
        assert set(got[1]) == want, (method, got)
    n = twin.node["coreth_tpu_torch"]
    assert n.result("debug_deviceStatus")["state"] == "healthy"
    assert n.result("debug_commitmentStatus")["shadow"] is None
    # no lock witness in the port until fault/chaos.py (item 8b)
    assert n.result("debug_lockStatus") == {
        "slow_hold_budget_seconds": 0.0, "contention": [],
        "recent_slow_holds": []}
    assert n.result("debug_rpcStatus")["pooled"] is True
    assert "ops/device/status" in n.result("debug_metrics")
    recs = [twin.node[p].result("debug_blockFlightRecord", 2)
            for p in PKGS]
    assert [r["number"] for r in recs[1]] == [r["number"] for r in recs[0]]
    assert [sorted(r) for r in recs[1]] == [sorted(r) for r in recs[0]]
    # the failpoint registries list each package's own sites
    fps = n.result("debug_listFailpoints")
    assert "rpc/before_dispatch" in fps["registered"] and fps["armed"] == []
    armed = n.result("debug_setFailpoint", "insert/before_write", "raise*1")
    assert [a["name"] for a in armed] == ["insert/before_write"]
    assert n.result("debug_setFailpoint", "insert/before_write", "") == []
    assert n.result("debug_setSpans", False) is False
    assert n.result("debug_setExpensiveMetrics", False) is False
    twin.same("debug_traceRequest", "nope")


def test_admin_export_import(twin, tmp_path):
    """admin_exportChain on each; the files are equal, and a fresh port
    VM replays the reference's file to the same tip."""
    from coreth_tpu_torch.vm.api import AdminAPI

    from coreth_tpu.vm.api import AdminAPI as JAdminAPI

    paths = []
    for p, cls in zip(PKGS, (JAdminAPI, AdminAPI)):
        path = str(tmp_path / f"{p}.rlp")
        assert cls(twin.node[p].vm, profile_dir=str(tmp_path)).exportChain(
            path)
        paths.append(open(path, "rb").read())
    assert paths[1] == paths[0]
    fresh = tw.Node("coreth_tpu_torch", precompile=True)
    try:
        assert AdminAPI(fresh.vm).importChain(
            str(tmp_path / "coreth_tpu.rlp"))
        assert fresh.vm.blockchain.last_accepted.hash() == \
            twin.node["coreth_tpu_torch"].vm.blockchain.last_accepted.hash()
    finally:
        fresh.shutdown()


# ------------------------------------------- the precompile's eth_call


def test_precompile_eth_call_and_device_fault(twin):
    """An eth_call of keccak256Batch with 64 messages (DEVICE_THRESHOLD)
    runs the precompile through the head state's device seam: the same
    answer from both, the digests native keccak256's. A failing dispatch
    on the port reaches the client as an error object: no answer from the
    host, the ladder still healthy."""
    from coreth_tpu_torch.precompile import TPU_KECCAK_ADDR, function_selector

    msgs = [bytes([i]) * (40 + i) for i in range(64)]
    heads, tail = b"", b""
    for m in msgs:
        heads += (32 * len(msgs) + len(tail)).to_bytes(32, "big")
        tail += len(m).to_bytes(32, "big") + m + b"\x00" * (-len(m) % 32)
    call = {"to": "0x" + TPU_KECCAK_ADDR.hex(), "data": "0x" + (
        function_selector("keccak256Batch(bytes[])")
        + (32).to_bytes(32, "big") + len(msgs).to_bytes(32, "big") + heads
        + tail).hex()}
    out = bytes.fromhex(twin.result("eth_call", call, "latest")[2:])
    assert [out[64 + 32 * i:96 + 32 * i] for i in range(64)] == [
        keccak256(m) for m in msgs]
    port = twin.node["coreth_tpu_torch"]
    fault.set_failpoint("ops/device/dispatch", "raise*1")
    err = port.rpc("eth_call", call, "latest")
    assert err["error"]["code"] == -32603, err
    assert "ops/device/dispatch" in err["error"]["message"]
    assert pdevice.default_ladder().healthy
    assert port.result("eth_call", call, "latest") == "0x" + out.hex()


def test_health_and_drain(twin):
    """The twin's last case: stop() drains both servers cleanly, after
    which health reports the node unhealthy and draining (a load balancer
    routes away) and requests shed as draining, on both."""
    from coreth_tpu.vm.api import health_check as j_health_check
    from coreth_tpu_torch.vm.api import health_check

    twin.same("health_check")
    for p in PKGS:
        assert twin.node[p].server.stop() == {
            "drained": True, "abandoned": 0, "abandoned_methods": []}
    assert health_check(twin.node["coreth_tpu_torch"].vm) == j_health_check(
        twin.node["coreth_tpu"].vm)
    assert health_check(twin.node["coreth_tpu_torch"].vm)["draining"]
    assert twin.same("eth_chainId")["error"]["code"] == -32000


# ------------------------------------------------------ the resident twin


@pytest.fixture(scope="module")
def resident_twin():
    t = Twin({"resident-account-trie": True})
    t.block(t.tx(tw.DEST, value=5))
    t.block(t.tx(tw.EMITTER_ADDR, gas=100_000))
    yield t
    t.shutdown()


def _trie_nodes(vm):
    return {k: v for k, v in vm.blockchain.diskdb.iterate()
            if len(k) == 32}


def test_resident_get_proof_at_head(resident_twin):
    """On a resident head, eth_getProof first reads the account trie's
    delta back from the resident store (export_to, children first), then
    walks it: the reference's node lists, verified against the header
    root; after the next block's accept both stores hold the same trie
    nodes."""
    t = resident_twin
    port = t.node["coreth_tpu_torch"].vm
    assert port.blockchain.mirror is not None
    head = port.blockchain.last_accepted
    assert port.blockchain.state_database.open_trie(head.root).resident
    for addr, keys in ((tw.ADDR, []), (tw.DEST, ["0x0"]),
                       (tw.EMITTER_ADDR, ["0x0", "0x1"])):
        proof = t.result("eth_getProof", "0x" + addr.hex(), keys, "latest")
        _check_account_proof("0x" + head.root.hex(), addr, proof)
    t.block(t.tx(tw.DEST, value=6))
    for p in PKGS:  # the reference leaves storage tries dirty until cap
        t.node[p].vm.blockchain.state_database.triedb.cap(0)
    nodes = [_trie_nodes(t.node[p].vm) for p in PKGS]
    assert nodes[1] == nodes[0]
    t.same("eth_getProof", "0x" + tw.ADDR.hex(), [], "latest")


# -------------------------------------------------- knobs and left-outs

# every knob that left vm/config.py's NOT_PORTED with this slice, at a
# value away from its default
PORTED_KNOBS = {
    "eth-apis": tw.ETH_APIS, "admin-api-enabled": True,
    "health-api-enabled": False, "coreth-admin-api-enabled": True,
    "api-max-duration": 2.5, "api-max-blocks-per-request": 64,
    "allow-unfinalized-queries": True, "rpc-max-workers": 2,
    "rpc-queue-size": 8, "rpc-expensive-workers": 1,
    "rpc-expensive-queue-size": 2, "rpc-expensive-duration": 4.0,
    "rpc-batch-limit": 10, "rpc-body-limit": 4096,
    "rpc-breaker-threshold": 2, "rpc-breaker-probe-every": 3,
    "rpc-breaker-close-after": 2, "rpc-drain-timeout": 1.0,
    "rpc-max-connections": 4, "rpc-slo-budget": 0.5,
    "gasprice-cache-size": 2, "logs-cache-size": 3,
    "continuous-profiler-frequency": 60.0,
    "continuous-profiler-max-files": 2, "profiler-hz": 50.0,
    "profiler-ring-size": 64, "metrics-http-enabled": True,
    "metrics-http-host": "127.0.0.1", "metrics-http-port": 0,
    # the WebSocket transport and the wallet (item 10b)
    "ws-cpu-refill-rate": 1000, "ws-cpu-max-stored": 50,
    "ws-notify-queue-size": 32, "keystore-directory": "keystore",
    "keystore-external-signer": "clef.ipc",
    # the lock witness's slow-hold budget (item 8b)
    "lock-slow-hold-budget": 0.25,
}


@pytest.mark.parametrize("knob", sorted(PORTED_KNOBS))
def test_ported_knob_parses(knob):
    """Each knob of the RPC tier, the profilers and the metrics endpoint
    is read now: parse_config takes it as the reference's does."""
    from coreth_tpu.vm.config import parse_config as j_parse_config
    from coreth_tpu_torch.vm.config import parse_config

    blob = json.dumps({knob: PORTED_KNOBS[knob]}).encode()
    attr = knob.replace("-", "_")
    assert getattr(parse_config(blob), attr) == getattr(
        j_parse_config(blob), attr) == PORTED_KNOBS[knob]


def test_ported_knobs_boot_and_are_honoured(tmp_path):
    """One VM of each package boots with all of them at once: the RPC
    policy carries the rpc-* knobs, the profilers sample, /metrics and
    /healthz answer over HTTP; shutdown() stops
    the server, the endpoint and the profilers and leaves no thread."""
    from coreth_tpu_torch.metrics import profiler

    before = set(threading.enumerate())
    knobs = dict(PORTED_KNOBS, **{
        "continuous-profiler-dir": str(tmp_path / "prof"),
        "keystore-directory": str(tmp_path / "keystore"),
        "keystore-external-signer": str(tmp_path / "clef.ipc")})
    nodes = {p: tw.Node(p, knobs) for p in PKGS}
    try:
        j, n = nodes["coreth_tpu"], nodes["coreth_tpu_torch"]
        for k in ("max_workers", "batch_limit", "body_limit",
                  "cheap_budget", "expensive_budget", "drain_timeout",
                  "max_connections", "slo_budget"):
            assert getattr(n.server.policy, k) == getattr(j.server.policy, k)
        assert n.server.policy.status() == j.server.policy.status()
        assert (n.server.policy.batch_limit, n.server.policy.slo_budget,
                n.server.policy.status()["cheap"]["queue_capacity"]) == (
            10, 0.5, 8)
        assert sorted(n.server._methods) == sorted(j.server._methods)
        assert "health_check" not in n.server._methods  # health off
        assert "admin_exportChain" in n.server._methods
        assert n.vm.eth_backend.api_max_blocks == 64
        assert profiler.profile_dump()["running"] is True
        port = n.vm.metrics_http.port
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
            assert json.loads(r.read())["healthy"] is True
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            assert b"# TYPE" in r.read()
        # the first roll makes the directory and starts a sampler; its
        # profile lands a frequency later (tests/test_api.py rolls them)
        deadline = time.time() + 5
        while (not (tmp_path / "prof").exists()
               and time.time() < deadline):
            time.sleep(0.02)
        assert n.vm.continuous_profiler._sampler is not None
        from coreth_tpu_torch.utils import racecheck

        assert racecheck.slow_hold_budget() == 0.25
        batch = [{"jsonrpc": "2.0", "id": i, "method": "eth_chainId",
                  "params": []} for i in range(11)]
        assert n.raw(batch) == j.raw(batch)  # over rpc-batch-limit
        assert n.raw(batch)["error"]["code"] == -32600
        assert n.vm.keystore.keydir == j.vm.keystore.keydir
        assert (n.vm.external_signer.endpoint
                == j.vm.external_signer.endpoint)
        from coreth_tpu_torch.vm.api import serve_ws

        ws, port = serve_ws(n.vm, rpc_server=n.server)
        assert (ws.refill_rate, ws.max_stored, ws.notify_queue_size,
                ws.max_payload) == (1000, 50, 32, 4096)
        from coreth_tpu_torch.rpc.websocket import WSClient

        c = WSClient("127.0.0.1", port)
        assert c.request("eth_chainId") == hex(tw.CHAIN_ID)
        c.close()
        ws.stop()
    finally:
        for node in nodes.values():
            node.shutdown()
        from coreth_tpu.utils import racecheck as j_racecheck
        from coreth_tpu_torch.utils import racecheck

        racecheck.set_slow_hold_budget(0.0)  # process-wide, like the VM's
        j_racecheck.set_slow_hold_budget(0.0)
    assert profiler.profile_dump()["running"] is False
    deadline = time.time() + 5
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.02)
    left = set(threading.enumerate()) - before
    assert not left, sorted(th.name for th in left)


@pytest.mark.parametrize("knob,value,item", [
    ("keystore-insecure-unlock-allowed", True, "item 10 "),
    ("allow-unprotected-txs", True, "item 10 "),
])
def test_left_out_knob_raises(knob, value, item):
    """allow-unprotected-txs and keystore-insecure-unlock-allowed are
    read by neither package, and still refuse the boot. (The lock budget
    left this list with the lock witness: PORTED_KNOBS.)"""
    from coreth_tpu_torch.vm.config import parse_config

    with pytest.raises(NotImplementedError, match=item):
        parse_config(json.dumps({knob: value}).encode())


@pytest.fixture(scope="module")
def personal_twin():
    """A twin whose eth-apis open the account-signing gates."""
    t = Twin({"eth-apis": tw.ETH_APIS + ["personal", "internal-account"]})
    yield t
    t.shutdown()


@pytest.mark.parametrize("method,params", [
    ("eth_accounts", []),
    ("eth_sign", ["0x" + tw.ADDR.hex(), "0x00"]),
    ("eth_signTransaction", [{"from": "0x" + tw.ADDR.hex()}]),
    ("eth_sendTransaction", [{"from": "0x" + tw.ADDR.hex()}]),
    ("eth_resend", [{"from": "0x" + tw.ADDR.hex(), "nonce": "0x0"}]),
    ("eth_pendingTransactions", []),
    ("personal_listAccounts", []),
    ("personal_newAccount", ["pw"]),
    ("personal_importRawKey", ["0x" + "11" * 32, "pw"]),
    ("personal_unlockAccount", ["0x" + tw.ADDR.hex(), "pw"]),
    ("personal_lockAccount", ["0x" + tw.ADDR.hex()]),
    ("personal_sign", ["0x00", "0x" + tw.ADDR.hex(), "pw"]),
    ("personal_sendTransaction", [{"from": "0x" + tw.ADDR.hex()}, "pw"]),
    ("personal_ecRecover", ["0x00", "0x" + "11" * 65]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_keystore_backed_methods(personal_twin, method, params):
    """With the signing namespaces on, every keystore-backed method gives
    the reference's answer on a node without a keystore: the "keystore
    not configured" error (or an empty account list)."""
    out = personal_twin.same(method, *params)
    if method in ("eth_accounts", "eth_pendingTransactions",
                  "personal_listAccounts"):
        assert out["result"] == []
    elif method not in ("eth_resend", "personal_ecRecover"):
        assert out["error"] == {"code": -32000, "message":
                                "keystore not configured (set "
                                "keystore-directory)"}
