"""The port's wallet over JSON-RPC (keystore-backed eth/personal methods,
avax key management and the tx builder, contract bindings) against the
JAX package's, on the CPU: a twin of tests/test_wallet_rpc.py and
tests/test_bind.py.

One VM of each package (tests/torch_rpc_twin.Node; the port's on
device="cpu") boots from the same JSON with a keystore directory of its
own and the personal namespace opted in, on the same genesis and with
the same UTXO exported from the X chain. The steps run in file order on
that module-scoped pair: every request goes to both servers and the
decoded answers must be equal (results and error objects alike), every
block built after them must have equal bytes, so transaction hashes,
atomic tx IDs and state roots are the reference's. Where a transaction
is signed by the node, its hash also equals the hash of the same
transaction signed here with the reference's Signer (signing is
deterministic).
"""

import importlib
import json
import os
import subprocess
import sys
import threading

import pytest

from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.vm.atomic_tx import UTXO as JUTXO
from coreth_tpu.vm.atomic_tx import X2C_RATE

import torch_rpc_twin as tw
from test_bind import ABI_JSON, INIT, RUNTIME

PKGS = ("coreth_tpu", "coreth_tpu_torch")
PASSWORD = "hunter2"
ADDR = "0x" + tw.ADDR.hex()
DEST = "0x" + tw.DEST.hex()
APIS = tw.ETH_APIS + ["personal", "internal-account"]
UTXO = {"tx_id": b"\x07" * 32, "amount": 5 * 10**9, "address": tw.ADDR}
X_DEST = b"\x77" * 20


class WalletTwin:
    def __init__(self, tmp_path):
        self.node = {p: tw.Node(p, {"keystore-directory": str(tmp_path / p),
                                    "eth-apis": APIS}, utxos=[UTXO])
                     for p in PKGS}

    def same(self, method, *params):
        got = [self.node[p].rpc(method, *params) for p in PKGS]
        assert got[1] == got[0], (method, params, got)
        return got[1]

    def result(self, method, *params):
        out = self.same(method, *params)
        assert "error" not in out, out
        return out["result"]

    def error(self, method, *params):
        out = self.same(method, *params)
        assert "error" in out, out
        return out["error"]

    def block(self):
        blks = [self.node[p].build_and_accept() for p in PKGS]
        assert blks[1].bytes() == blks[0].bytes()
        return blks[1]

    def shutdown(self):
        for n in self.node.values():
            n.shutdown()


@pytest.fixture(scope="module")
def wt(tmp_path_factory):
    t = WalletTwin(tmp_path_factory.mktemp("wallet"))
    yield t
    t.shutdown()


def ref_signed(nonce, to, value, gas=21000, max_fee=10**12, tip=10**9,
               data=b""):
    return JSigner(tw.CHAIN_ID).sign(JTransaction(
        type=2, chain_id=tw.CHAIN_ID, nonce=nonce, max_fee=max_fee,
        max_priority_fee=tip, gas=gas, to=to, value=value, data=data),
        tw.KEY)


def tx_obj(nonce, value, **kw):
    """An eth_sendTransaction object with every field given."""
    obj = {"from": ADDR, "to": DEST, "value": hex(value), "gas": hex(21000),
           "maxFeePerGas": hex(10**12), "maxPriorityFeePerGas": hex(10**9),
           "nonce": hex(nonce)}
    obj.update(kw)
    return obj


def test_keys_and_accounts(wt):
    assert wt.result("eth_accounts") == []
    assert wt.result("personal_importRawKey", "0x" + tw.KEY.hex(),
                     PASSWORD) == ADDR
    assert wt.result("eth_accounts") == [ADDR]
    assert wt.result("personal_listAccounts") == [ADDR]
    wt.error("personal_importRawKey", "0x11", PASSWORD)
    new = wt.node["coreth_tpu_torch"].result("personal_newAccount", "pw2")
    assert new in wt.node["coreth_tpu_torch"].result("eth_accounts")
    ks = wt.node["coreth_tpu_torch"].vm.keystore
    ks.delete(bytes.fromhex(new[2:]), "pw2")  # keep the twins' sets equal
    assert wt.result("eth_accounts") == [ADDR]


def test_send_transaction_locked_then_unlocked(wt):
    err = wt.error("eth_sendTransaction", tx_obj(0, 12345))
    assert "unlock" in err["message"]
    assert wt.result("personal_unlockAccount", ADDR, PASSWORD, 0) is True
    hashes = [wt.result("eth_sendTransaction", tx_obj(n, 100 + n))
              for n in range(3)]
    assert hashes == ["0x" + ref_signed(n, tw.DEST, 100 + n).hash().hex()
                      for n in range(3)]
    assert len(wt.result("eth_pendingTransactions")) == 3
    blk = wt.block()
    assert [t.hash() for t in blk.eth_block.transactions] == [
        bytes.fromhex(h[2:]) for h in hashes]
    for h in hashes:
        assert wt.result("eth_getTransactionReceipt", h)["status"] == "0x1"
    assert int(wt.result("eth_getBalance", DEST, "latest"), 16) == 303


def test_sign_transaction_sign_and_recover(wt):
    out = wt.result("eth_signTransaction", tx_obj(3, 55))
    assert out["raw"] == "0x" + ref_signed(3, tw.DEST, 55).encode().hex()
    assert wt.result("eth_sendRawTransaction", out["raw"]) == out["tx"]["hash"]
    msg = "0x" + b"hello coreth".hex()
    sig = wt.result("personal_sign", msg, ADDR, PASSWORD)
    assert wt.result("personal_ecRecover", msg, sig) == ADDR
    sig2 = wt.result("eth_sign", ADDR, msg)
    assert sig2 == sig
    wt.error("personal_sign", msg, ADDR, "wrong")
    # personal_sendTransaction fills the defaults itself (the pool's next
    # nonce, the oracle's fees, estimated gas)
    h = wt.result("personal_sendTransaction",
                  {"from": ADDR, "to": DEST, "value": hex(777)}, PASSWORD)
    wt.error("personal_sendTransaction",
             {"from": ADDR, "to": DEST, "value": hex(1)}, "wrong")
    resent = wt.result("eth_resend", tx_obj(4, 777, gas=hex(30000),
                                            maxFeePerGas=None,
                                            maxPriorityFeePerGas=None),
                       hex(10**12))
    assert resent != h
    blk = wt.block()
    assert len(blk.eth_block.transactions) == 2
    assert int(wt.result("eth_getBalance", DEST, "latest"), 16) == 303 + 55 + 777


def test_avax_keys_import_and_export(wt):
    """avax.importKey / exportKey, then an ImportTx of the X chain's UTXO
    and an ExportTx back, built by the tx builder from the keystore's
    keys: equal tx IDs, blocks and shared memory."""
    assert wt.result("avax_importKey", PASSWORD, "0x" + tw.KEY.hex()) == {
        "address": ADDR}
    assert wt.result("avax_exportKey", PASSWORD, ADDR) == {
        "privateKey": "0x" + tw.KEY.hex()}
    wt.error("avax_exportKey", "wrong", ADDR)
    wt.error("avax_import", "wrong", DEST, "0x" + tw.X_CHAIN.hex())
    before = int(wt.result("eth_getBalance", DEST, "latest"), 16)
    imp = wt.result("avax_import", PASSWORD, DEST, "0x" + tw.X_CHAIN.hex())
    blk = wt.block()
    assert [a.id() for a in blk.atomic_txs] == [bytes.fromhex(imp["txID"][2:])]
    credited = int(wt.result("eth_getBalance", DEST, "latest"), 16) - before
    assert 0 < credited <= UTXO["amount"] * X2C_RATE
    assert wt.result("avax_getAtomicTxStatus", imp["txID"])["status"] == (
        "Accepted")
    wt.error("avax_import", PASSWORD, DEST, "0x" + tw.X_CHAIN.hex())  # spent
    exp = wt.result("avax_export", PASSWORD, 2 * 10**9,
                    "0x" + X_DEST.hex(), "0x" + tw.X_CHAIN.hex())
    wt.error("avax_export", PASSWORD, 0, "0x" + X_DEST.hex())
    blk = wt.block()
    assert [a.id() for a in blk.atomic_txs] == [bytes.fromhex(exp["txID"][2:])]
    utxos = []
    for p in PKGS:
        node = wt.node[p]
        got, _, _ = node.mem.new_shared_memory(tw.X_CHAIN).indexed(
            tw.C_CHAIN, [X_DEST], limit=10)
        utxos.append(got)
    assert utxos[1] == utxos[0] and len(utxos[1]) == 1
    out = JUTXO.decode(utxos[1][0])
    assert (out.amount, out.address) == (2 * 10**9, X_DEST)


def test_tx_builder_matches_reference(wt):
    """new_import_tx / new_export_tx called directly on both VMs, with
    the fee fixed point: the same signed bytes (not issued)."""
    out = []
    for p in PKGS:
        node = wt.node[p]
        txb = importlib.import_module(f"{p}.vm.tx_builder")
        node.put_utxo(b"\x08" * 32, 3 * 10**9, tw.ADDR)
        u = txb.spendable_utxos(node.vm, tw.X_CHAIN, [tw.ADDR])
        imp = txb.new_import_tx(node.vm, tw.DEST, tw.X_CHAIN, [tw.KEY])
        exp = txb.new_export_tx(node.vm, 10**9, node.vm.avax_asset_id,
                                tw.X_CHAIN, X_DEST, [tw.KEY])
        out.append([x.encode() for x in u] + [imp.encode(), exp.encode()])
        with pytest.raises(Exception, match="cannot import from self"):
            txb.new_import_tx(node.vm, tw.DEST, tw.C_CHAIN, [tw.KEY])
        with pytest.raises(Exception, match="insufficient AVAX"):
            txb.new_export_tx(node.vm, 10**17, node.vm.avax_asset_id,
                              tw.X_CHAIN, X_DEST, [b"\x55" * 32])
    assert out[1] == out[0] and len(out[1]) == 3


def test_lock_account_then_send_fails(wt):
    assert wt.result("personal_lockAccount", ADDR) is True
    err = wt.error("eth_sendTransaction", tx_obj(5, 1))
    assert "unlock" in err["message"]
    err = wt.error("eth_sign", ADDR, "0x00")
    assert "unlock" in err["message"]


def test_bound_contract_deploy_call_transact_events(wt):
    """tests/test_bind.py's counter through each package's bind over its
    own in-process ethclient.Client: the same deploy hash and address,
    calls, transactions and filtered logs."""
    rec = {}
    for p in PKGS:
        node = wt.node[p]
        bind = importlib.import_module(f"{p}.accounts.bind")
        client = importlib.import_module(f"{p}.ethclient").Client(
            server=node.server)
        abi = importlib.import_module(f"{p}.accounts.abi").ABI(ABI_JSON)
        opts = bind.TransactOpts(tw.KEY, tw.CHAIN_ID)
        addr, h, bound = bind.deploy_contract(client, opts, abi, INIT)
        rec[p] = [addr, h]
    blk = wt.block()
    assert rec["coreth_tpu_torch"] == rec["coreth_tpu"]
    for p in PKGS:
        node = wt.node[p]
        bind = importlib.import_module(f"{p}.accounts.bind")
        client = importlib.import_module(f"{p}.ethclient").Client(
            server=node.server)
        abi = importlib.import_module(f"{p}.accounts.abi").ABI(ABI_JSON)
        bound = bind.BoundContract(rec[p][0], abi, client)
        assert client.code_at(rec[p][0]) == RUNTIME
        rec[p].append(bound.call("get", b""))
        rec[p].append(bound.transact(bind.TransactOpts(tw.KEY, tw.CHAIN_ID),
                                     None))
    blk = wt.block()
    for p in PKGS:
        node = wt.node[p]
        bind = importlib.import_module(f"{p}.accounts.bind")
        client = importlib.import_module(f"{p}.ethclient").Client(
            server=node.server)
        abi = importlib.import_module(f"{p}.accounts.abi").ABI(ABI_JSON)
        bound = bind.BoundContract(rec[p][0], abi, client)
        rec[p].append(bound.call("get", b""))
        rec[p].append(bound.filter_logs("Ticked", from_block=0))
        rec[p].append([client.chain_id(), client.block_number(),
                       client.nonce_at(tw.ADDR), client.suggest_gas_price(),
                       client.storage_at(rec[p][0], 0),
                       client.block_by_number(blk.height())["hash"],
                       client.transaction_receipt(rec[p][1])["status"]])
    assert rec["coreth_tpu_torch"] == rec["coreth_tpu"]
    assert rec["coreth_tpu_torch"][2] == [0]
    assert rec["coreth_tpu_torch"][4] == [1]


def test_generate_bindings_equal_and_abigen_cli(tmp_path):
    """The generated module is the reference's with the package name
    swapped; it compiles and runs; the CLI writes the same text."""
    from coreth_tpu.accounts.bind import generate_bindings as jgen
    from coreth_tpu_torch.accounts.bind import generate_bindings as pgen

    src = pgen(ABI_JSON, "Counter", INIT)
    assert src == jgen(ABI_JSON, "Counter", INIT).replace(
        "coreth_tpu", "coreth_tpu_torch")
    ns = {}
    exec(compile(src, "counter_binding.py", "exec"), ns)
    assert hasattr(ns["Counter"], "filter_Ticked")
    abi_file = tmp_path / "c.json"
    abi_file.write_text(json.dumps(ABI_JSON))
    (tmp_path / "c.bin").write_text(INIT.hex())
    out_file = tmp_path / "c.py"
    r = subprocess.run(
        [sys.executable, "-m", "coreth_tpu_torch.accounts.bind",
         "--abi", str(abi_file), "--name", "Counter", "--bin",
         str(tmp_path / "c.bin"), "--out", str(out_file)],
        capture_output=True, text=True, timeout=60,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-500:]
    assert out_file.read_text() == src


def test_generated_binding_drives_the_port(wt):
    """The generated module against the port's VM: deploy, read, event
    filter method present."""
    from coreth_tpu_torch.accounts.bind import TransactOpts, \
        generate_bindings
    from coreth_tpu_torch.ethclient import Client

    node = wt.node["coreth_tpu_torch"]
    ns = {}
    exec(compile(generate_bindings(ABI_JSON, "Counter", INIT), "c.py",
                 "exec"), ns)
    client = Client(server=node.server)
    counter, _ = ns["Counter"].deploy(client,
                                      TransactOpts(tw.KEY, tw.CHAIN_ID))
    node.build_and_accept()
    assert client.code_at(counter.address) == RUNTIME
    assert counter.get(b"") == 0


def test_shutdown_cancels_the_relock_timer(tmp_path):
    """ROADMAP Queue 3: personal_unlockAccount with its default duration
    (300 s) starts a relock timer on both VMs; the port's shutdown()
    closes the keystore, so its timer thread is gone when shutdown()
    returns; the reference's stays (cancelled here by lock_account)."""
    nodes = {p: tw.Node(p, {"keystore-directory": str(tmp_path / p),
                            "eth-apis": APIS}) for p in PKGS}
    for node in nodes.values():
        assert node.result("personal_importRawKey", "0x" + tw.KEY.hex(),
                           PASSWORD) == ADDR
        before = {t for t in threading.enumerate() if t.is_alive()}
        assert node.result("personal_unlockAccount", ADDR, PASSWORD) is True
        node.timer, = [t for t in threading.enumerate() if t not in before
                       and isinstance(t, threading.Timer)]
    ref, port = nodes["coreth_tpu"], nodes["coreth_tpu_torch"]
    port.shutdown()
    assert not port.timer.is_alive()
    assert port.vm.keystore._relock == {}
    ref.shutdown()
    assert ref.timer.is_alive()
    ref.vm.keystore.lock_account(tw.ADDR)
    ref.timer.join(timeout=5)
