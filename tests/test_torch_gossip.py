"""Transaction gossip of the port (coreth_tpu_torch/vm/gossiper.py)
against the JAX package's (coreth_tpu/vm/gossiper.py), on the CPU.

- Two VMs of each package wired through two peer.Network objects (each
  one's app_request the other's transport, as tests/test_accounts.py's
  TestGossip wires them): a tx issued to the first reaches the second's
  pool, and both packages end with the same pools. Both count the same
  echo: the second VM's pool feed gossips the tx back while the first
  VM's issue still holds its pool lock, so the first's gossip waits out
  its deadline (peer/gossip_timeouts) and the echo is then refused as
  already known (gossip/drops/eth_tx_rejected): a fault the port shares
  with the reference (ROADMAP Queue 3).
- encode_tx_gossip and encode_atomic_gossip give the reference's bytes.
- regossip() picks the same transactions (the lowest-nonce executable
  one an account, highest tip first, cut at regossip-max-txs).
- Malformed and rejected gossip counts the same gossip/drops/* counters
  (twin of tests/test_config_knobs.py's test_malformed_gossip_counted_
  not_fatal), and an atomic tx gossiped in lands in the same mempool.
- The regossip knobs flow in from the config (twin of test_regossip_
  knobs_flow_into_gossiper).
- stop() joins the regossip thread, where the reference's leaves it
  running (ROADMAP Queue 3).

Transactions are signed once by the reference and decoded into the port.
"""

import importlib
import json
import threading
import time

import pytest

from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address

PKGS = ("coreth_tpu", "coreth_tpu_torch")
KEYS = [bytes([0x11 + i]) * 32 for i in range(4)]
ADDRS = [priv_to_address(k) for k in KEYS]
DEST = b"\xbb" * 20
FUND = 10**24
CHAIN_ID = 43112
X_CHAIN = b"\x58" * 32
C_CHAIN = b"\x02" * 32
AVAX = b"\x41" * 32
DROPS = ("empty", "unknown_kind", "malformed", "eth_tx_rejected",
         "atomic_tx_rejected")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def boot(pkg, knobs=None, mem=None):
    """A VM of `pkg` on one genesis (the four keys funded) and clock; the
    port's on device="cpu"."""
    g = mod(pkg, "core.genesis")
    params = mod(pkg, "params")
    genesis = g.Genesis(config=params.TEST_CHAIN_CONFIG,
                        gas_limit=params.CORTINA_GAS_LIMIT,
                        alloc={a: g.GenesisAccount(balance=FUND)
                               for a in ADDRS})
    vm = mod(pkg, "vm.vm").VM()
    kw = {"device": "cpu"} if pkg == "coreth_tpu_torch" else {}
    ctx = mod(pkg, "vm.vm").SnowContext(
        chain_id=C_CHAIN, x_chain_id=X_CHAIN, avax_asset_id=AVAX,
        shared_memory=mem or mod(pkg, "vm.shared_memory").Memory())
    vm.initialize(ctx, mod(pkg, "ethdb").MemoryDB(), genesis,
                  config_bytes=json.dumps(
                      {"device-hasher": "off", **(knobs or {})}).encode(),
                  **kw)
    vm.miner.clock = lambda: vm.blockchain.current_block.time + 2
    return vm


def signed(key_i, nonce, tip=10**9):
    t = JTransaction(type=2, chain_id=CHAIN_ID, nonce=nonce, max_fee=10**12,
                     max_priority_fee=tip, gas=21000, to=DEST, value=1)
    return JSigner(CHAIN_ID).sign(t, KEYS[key_i]).encode()


def decode(pkg, raw):
    return mod(pkg, "core.types").Transaction.decode(raw)


def counts(pkg, names):
    reg = mod(pkg, "metrics").default_registry
    return {n: reg.counter(n).count() for n in names}


class _Capture:
    """A network that records what is gossiped."""

    def __init__(self):
        self.sent = []
        self.handlers = []

    def subscribe_gossip(self, fn):
        self.handlers.append(fn)

    def gossip(self, payload):
        self.sent.append(payload)


def pool_hashes(vm):
    return sorted(t.hash() for txs in vm.txpool.pending_txs().values()
                  for t in txs)


def test_tx_gossip_between_vms():
    """Twin of tests/test_accounts.py's TestGossip: vm1's pool feed
    gossips to vm2's pool. Both packages end with the same pools on both
    VMs and the same drop and timeout counts: the echo from vm2 reaches
    vm1 while vm1's issue holds its pool lock, in both. vm2's gossip
    deadline is cut to 0.2 s, so its echo times out first and the stall
    is short; vm1 keeps the default 2 s, so its own gossip completes and
    the counts do not depend on which deadline expires first."""
    raw = signed(0, 0)
    names = ["gossip/drops/" + d for d in DROPS] + [
        "peer/gossip_timeouts", "peer/drops/gossip_send_failure"]
    out = {}
    for pkg in PKGS:
        net_mod = mod(pkg, "peer.network")
        gossiper = mod(pkg, "vm.gossiper")
        vms, nets, gs = [], [], []
        for name in (b"vm1", b"vm2"):
            vm = boot(pkg)
            net = net_mod.Network(self_id=name)
            if name == b"vm2":
                net.gossip_deadline = 0.2
            vms.append(vm)
            nets.append(net)
            gs.append(gossiper.Gossiper(vm, net))
        nets[0].connect(b"vm2", nets[1].app_request)
        nets[1].connect(b"vm1", nets[0].app_request)
        before = counts(pkg, names)
        tx = decode(pkg, raw)
        vms[0].issue_tx(tx)  # pool feed -> gossip -> vm2's pool
        assert vms[1].txpool.has(tx.hash())
        assert vms[0].txpool.has(tx.hash())
        deadline = time.monotonic() + 5
        while (time.monotonic() < deadline and sum(counts(pkg, names).values())
               < sum(before.values()) + 2):
            time.sleep(0.01)
        time.sleep(0.05)
        after = counts(pkg, names)
        out[pkg] = ([pool_hashes(vm) for vm in vms],
                    {n: after[n] - before[n] for n in names})
        for g in gs:
            g.stop()
        for vm in vms:
            vm.shutdown()
        if hasattr(nets[0], "close"):
            for net in nets:
                net.close()
        else:  # the reference's Network has no close()
            for net in nets:
                if net._pool is not None:
                    net._pool.shutdown(wait=True)
    assert out["coreth_tpu_torch"] == out["coreth_tpu"], out
    pools, moved = out["coreth_tpu_torch"]
    assert pools == [[decode(PKGS[1], raw).hash()]] * 2
    assert {n: v for n, v in moved.items() if v} == {
        "gossip/drops/eth_tx_rejected": 1, "peer/gossip_timeouts": 1}


def test_gossip_payloads_are_the_references_bytes():
    from coreth_tpu.vm import atomic_tx as jatx
    from coreth_tpu.vm import gossiper as jg
    from coreth_tpu_torch.vm import atomic_tx as patx
    from coreth_tpu_torch.vm import gossiper as pg

    raws = [signed(i % 4, i // 4, tip=10**9 + i) for i in range(20)]
    for n in (0, 1, 16, 20):
        assert pg.encode_tx_gossip([decode(PKGS[1], r) for r in raws[:n]]) \
            == jg.encode_tx_gossip([decode(PKGS[0], r) for r in raws[:n]])
    utxo = jatx.UTXO(tx_id=b"\x01" * 32, output_index=0, asset_id=AVAX,
                     amount=5 * 10**9, address=ADDRS[0])
    tx = jatx.Tx(jatx.ImportTx(
        network_id=1337, blockchain_id=C_CHAIN, source_chain=X_CHAIN,
        imported_inputs=[utxo], outs=[jatx.EVMOutput(
            address=DEST, amount=4 * 10**9, asset_id=AVAX)]))
    tx.sign([KEYS[0]])
    assert pg.encode_atomic_gossip(patx.decode_tx(tx.encode())) == \
        jg.encode_atomic_gossip(tx)
    assert (pg.GOSSIP_ETH_TXS, pg.GOSSIP_ATOMIC_TX,
            pg.MAX_TXS_PER_GOSSIP, pg.REGOSSIP_INTERVAL) == (
        jg.GOSSIP_ETH_TXS, jg.GOSSIP_ATOMIC_TX, jg.MAX_TXS_PER_GOSSIP,
        jg.REGOSSIP_INTERVAL)


def test_regossip_picks_the_same_transactions():
    """Four senders, three nonces each, tips that differ by sender: both
    packages' regossip() sends the same payload, cut at
    regossip-max-txs."""
    raws = [signed(k, n, tip=10**9 * (1 + (k * 5 + n) % 7))
            for k in range(4) for n in range(3)]
    sent = {}
    for pkg in PKGS:
        vm = boot(pkg, {"regossip-max-txs": 3})
        net = _Capture()
        g = mod(pkg, "vm.gossiper").Gossiper(vm, net)
        for r in raws:
            vm.issue_tx(decode(pkg, r))
        fed = list(net.sent)
        net.sent.clear()
        g.regossip()
        sent[pkg] = (fed, net.sent)
        vm.shutdown()
    assert sent["coreth_tpu_torch"] == sent["coreth_tpu"]
    fed, regossiped = sent["coreth_tpu_torch"]
    assert len(fed) == len(raws) and len(regossiped) == 1


def test_malformed_and_rejected_gossip_counted_the_same():
    """Twin of tests/test_config_knobs.py:174, plus an eth tx the pool
    refuses (a second copy), an atomic tx the mempool takes and a second
    copy of it it refuses: the same gossip/drops/* counters move by the
    same amounts, and the pools and mempools hold the same."""
    from coreth_tpu.vm import atomic_tx as jatx

    utxo = jatx.UTXO(tx_id=b"\x01" * 32, output_index=0, asset_id=AVAX,
                     amount=5 * 10**9, address=ADDRS[0])
    atx = jatx.Tx(jatx.ImportTx(
        network_id=1337, blockchain_id=C_CHAIN, source_chain=X_CHAIN,
        imported_inputs=[utxo], outs=[jatx.EVMOutput(
            address=DEST, amount=4 * 10**9, asset_id=AVAX)]))
    atx.sign([KEYS[0]])
    raw = signed(1, 0)
    moved, held = {}, {}
    for pkg in PKGS:
        g_mod = mod(pkg, "vm.gossiper")
        sm = mod(pkg, "vm.shared_memory")
        mem = sm.Memory()
        mem.new_shared_memory(X_CHAIN).apply({C_CHAIN: sm.Requests(
            put_requests=[sm.Element(key=utxo.utxo_id(),
                                     value=utxo.encode(),
                                     traits=[utxo.address])])})
        vm = boot(pkg, mem=mem)
        g = g_mod.Gossiper(vm, _Capture())
        names = ["gossip/drops/" + d for d in DROPS]
        before = counts(pkg, names)
        eth = g_mod.encode_tx_gossip([decode(pkg, raw)])
        atomic = bytes([g_mod.GOSSIP_ATOMIC_TX]) + atx.encode()
        for payload in (bytes([g_mod.GOSSIP_ETH_TXS]) + b"\xde\xad\xbe\xef",
                        b"", b"\x7fwhat", eth, eth, atomic, atomic,
                        bytes([g_mod.GOSSIP_ATOMIC_TX]) + b"\x00\x01"):
            g.handle_gossip(b"peer", payload)
        after = counts(pkg, names)
        moved[pkg] = {n: after[n] - before[n] for n in names}
        held[pkg] = (pool_hashes(vm), sorted(vm.mempool.txs))
        vm.shutdown()
    assert moved["coreth_tpu_torch"] == moved["coreth_tpu"], moved
    assert held["coreth_tpu_torch"] == held["coreth_tpu"]
    m = moved["coreth_tpu_torch"]
    assert m["gossip/drops/empty"] == m["gossip/drops/unknown_kind"] == 1
    assert m["gossip/drops/eth_tx_rejected"] >= 1
    assert m["gossip/drops/atomic_tx_rejected"] >= 1
    assert len(held["coreth_tpu_torch"][0]) == 1
    assert len(held["coreth_tpu_torch"][1]) == 1


def test_regossip_knobs_flow_into_gossiper():
    """Twin of tests/test_config_knobs.py:156."""
    got = {}
    for pkg in PKGS:
        vm = boot(pkg, {"regossip-frequency": 0.5, "regossip-max-txs": 3})
        g = mod(pkg, "vm.gossiper").Gossiper(vm, _Capture())
        got[pkg] = (g.regossip_interval, g.regossip_max_txs)
        vm.shutdown()
    assert got["coreth_tpu_torch"] == got["coreth_tpu"] == (0.5, 3)


class _SlowNet(_Capture):
    """gossip() parks until released, so a regossip is in flight when
    stop() is called."""

    def __init__(self):
        super().__init__()
        self.entered = threading.Event()
        self.release = threading.Event()

    def gossip(self, payload):
        self.entered.set()
        self.release.wait(5)
        super().gossip(payload)


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_stop_joins_the_regossip_thread(pkg):
    """The port's stop() joins the regossip thread (ROADMAP Queue 3): a
    regossip in flight ends before stop() returns. The reference's stop()
    only sets the event, so its thread is still inside the regossip."""
    vm = boot(pkg, {"regossip-frequency": 0.01})
    vm.issue_tx(decode(pkg, signed(0, 0)))  # before the gossiper's feed
    net = _SlowNet()
    g = mod(pkg, "vm.gossiper").Gossiper(vm, net)
    g.start_regossip()
    thread = g._regossip_thread
    assert net.entered.wait(5)
    threading.Timer(0.2, net.release.set).start()
    t0 = time.monotonic()
    g.stop()
    if pkg == "coreth_tpu_torch":
        assert not thread.is_alive()
        assert time.monotonic() - t0 >= 0.1
    else:
        assert thread.is_alive()
        thread.join(5)
    assert net.sent  # the regossip in flight was delivered
    vm.shutdown()
