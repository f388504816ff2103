"""One node of the RPC twin: a VM of either package (the JAX reference,
coreth_tpu, or the port, coreth_tpu_torch) behind its own
vm/api.create_handlers server, on one genesis, clock and set of signed
transactions. tests/test_torch_rpc.py drives a node of each package with
the same requests and compares the decoded JSON answers;
tests/test_torch_isolation.py runs the port's node alone in a process
that refuses jax, jaxlib and coreth_tpu.

This module imports neither package at import time: Node imports the
one it is given, so the port's half runs where the reference cannot be
imported. Transactions arrive as raw bytes, signed once by the caller.
"""

import dataclasses
import importlib
import json

KEY = b"\x11" * 32
DEST = b"\xbb" * 20
EMITTER_ADDR = b"\xee" * 20
X_CHAIN = b"\x58" * 32
C_CHAIN = b"\x02" * 32
AVAX = b"\x41" * 32
FUND = 10**24
CHAIN_ID = 43112
# KEY's address (priv_to_address of either package)
ADDR = bytes.fromhex("19e7e376e7c213b7e7e7e46cc70a5dd086daff2a")

# a contract that emits LOG1(data=0x42.., topic=0x1234) (tests/test_api.py)
EMITTER = (bytes([0x60, 0x42, 0x60, 0x00, 0x52, 0x7F])
           + (0x1234).to_bytes(32, "big")
           + bytes([0x60, 0x20, 0x60, 0x00, 0xA1, 0x00]))

# the knobs both twins boot with: debug and txpool opted in as a node
# would (they are off in the reference's default eth-apis list)
ETH_APIS = ["eth", "eth-filter", "net", "web3", "internal-eth",
            "internal-blockchain", "internal-transaction", "debug",
            "txpool"]


class Node:
    """`pkg` is "coreth_tpu" or "coreth_tpu_torch"; `config` the VM's
    JSON knobs; `precompile` enables the keccak256Batch precompile from
    genesis. The port's VM runs on device="cpu" (the plain versions of
    its kernels)."""

    def __init__(self, pkg, config=None, utxos=(), precompile=False):
        self.pkg = pkg

        def m(name):
            return importlib.import_module(f"{pkg}.{name}")

        self.m = m
        g = m("core.genesis")
        sm = m("vm.shared_memory")
        vmm = m("vm.vm")
        self.mem = sm.Memory()
        for utxo in utxos:
            self.put_utxo(**utxo)
        chain_config = m("params").TEST_CHAIN_CONFIG
        if precompile:
            chain_config = dataclasses.replace(
                chain_config, precompile_upgrades=(
                    m("precompile").TpuKeccakConfig(timestamp=0),))
        genesis = g.Genesis(
            config=chain_config,
            gas_limit=m("params").CORTINA_GAS_LIMIT,
            alloc={m("crypto.secp256k1").priv_to_address(KEY):
                   g.GenesisAccount(balance=FUND),
                   EMITTER_ADDR: g.GenesisAccount(code=EMITTER, balance=0)})
        vm = vmm.VM()
        kw = {"device": "cpu"} if pkg == "coreth_tpu_torch" else {}
        cfg = dict(config or {})
        cfg.setdefault("eth-apis", ETH_APIS)
        vm.initialize(
            vmm.SnowContext(chain_id=C_CHAIN, x_chain_id=X_CHAIN,
                            avax_asset_id=AVAX, shared_memory=self.mem),
            m("ethdb").MemoryDB(), genesis,
            config_bytes=json.dumps(cfg).encode(), **kw)
        # a block every 2 s of chain time, whatever the wall clock says
        vm.miner.clock = lambda: vm.blockchain.current_block.time + 2
        self.vm = vm
        self.server = m("vm.api").create_handlers(vm)

    def put_utxo(self, tx_id, amount, address):
        """The X chain exports a UTXO to this chain's shared memory."""
        atx = self.m("vm.atomic_tx")
        sm = self.m("vm.shared_memory")
        utxo = atx.UTXO(tx_id=tx_id, output_index=0, asset_id=AVAX,
                        amount=amount, address=address)
        self.mem.new_shared_memory(X_CHAIN).apply({C_CHAIN: sm.Requests(
            put_requests=[sm.Element(key=utxo.utxo_id(), value=utxo.encode(),
                                     traits=[utxo.address])])})

    def raw(self, payload):
        return json.loads(self.server.handle_raw(json.dumps(payload).encode()))

    def rpc(self, method, *params):
        """The decoded response object (result or error) of one request."""
        return self.raw({"jsonrpc": "2.0", "id": 1, "method": method,
                         "params": list(params)})

    def result(self, method, *params):
        out = self.rpc(method, *params)
        assert "error" not in out, (self.pkg, method, out)
        return out["result"]

    def submit(self, raw_txs=(), raw_atomic=()):
        """Transactions in by eth_sendRawTransaction and avax.issueTx;
        the answers."""
        return ([self.result("eth_sendRawTransaction", "0x" + r.hex())
                 for r in raw_txs]
                + [self.result("avax_issueTx", "0x" + r.hex())
                   for r in raw_atomic])

    def build_and_accept(self):
        blk = self.vm.build_block()
        blk.verify()
        self.vm.set_preference(blk.id())
        blk.accept()
        self.vm.blockchain.drain_acceptor_queue()
        return blk

    def answer(self, requests):
        """[(method, params)] -> the decoded responses."""
        return [self.rpc(method, *params) for method, params in requests]

    def shutdown(self):
        self.vm.shutdown()


def read_requests(t1, t2, b1, b2):
    """The read-only requests of tests/test_api.py's eth, tracer, dump,
    parity-sweep and misc cases over the twin's first two blocks (t1 a
    transfer in block 1, t2 the emitter's call in block 2; hashes as
    bytes) plus the eth methods those cases leave out."""
    addr = "0x" + ADDR.hex()
    emitter = "0x" + EMITTER_ADDR.hex()
    dest = "0x" + DEST.hex()
    h1, h2 = "0x" + t1.hex(), "0x" + t2.hex()
    bh1, bh2 = "0x" + b1.hex(), "0x" + b2.hex()
    call = {"to": emitter, "gas": hex(200000)}
    dsl = ("stats = {\"steps\": 0, \"codeSize\": 0, \"bal\": 0}\n"
           "def enter(frame):\n"
           "    stats[\"codeSize\"] = code_size(frame[\"to\"])\n"
           "    stats[\"bal\"] = balance(frame[\"from\"])\n"
           "def step(log):\n"
           "    stats[\"steps\"] = stats[\"steps\"] + 1\n"
           "def result():\n    return stats\n")
    return [
        ("eth_chainId", []), ("eth_blockNumber", []), ("eth_syncing", []),
        ("eth_getBalance", [dest, "latest"]),
        ("eth_getBalance", [addr, "0x1"]),
        ("eth_getAssetBalance", [addr, "latest", "0x" + AVAX.hex()]),
        ("eth_getTransactionCount", [addr, "latest"]),
        ("eth_getCode", [emitter, "latest"]),
        ("eth_getStorageAt", [emitter, "0x0", "latest"]),
        ("eth_getBlockByNumber", ["0x1", True]),
        ("eth_getBlockByNumber", ["latest", False]),
        ("eth_getBlockByHash", [bh2, True]),
        ("eth_getBlockByHash", [bh1, False]),
        ("eth_getBlockByNumber", ["0x64", False]),
        ("eth_getBlockTransactionCountByNumber", ["0x2"]),
        ("eth_getTransactionByHash", [h1]),
        ("eth_getTransactionReceipt", [h1]),
        ("eth_getTransactionReceipt", [h2]),
        ("eth_call", [{"to": emitter, "from": addr}, "latest"]),
        ("eth_estimateGas", [{"to": dest, "from": addr, "value": "0x1"}]),
        ("eth_estimateGas", [{"to": emitter, "from": addr}]),
        ("eth_getLogs", [{"fromBlock": "0x0", "toBlock": "0x2",
                          "address": emitter}]),
        ("eth_getLogs", [{"fromBlock": "0x0", "toBlock": "0x2",
                          "topics": ["0x" + (0x9999).to_bytes(32, "big")
                                     .hex()]}]),
        ("eth_getLogs", [{"blockHash": bh2}]),
        ("eth_gasPrice", []), ("eth_maxPriorityFeePerGas", []),
        ("eth_feeHistory", [2, "latest", [50]]),
        ("eth_feeHistory", [3, "0x2", [10, 90]]),
        ("eth_getHeaderByNumber", ["0x2"]), ("eth_getHeaderByHash", [bh2]),
        ("eth_getBlockTransactionCountByHash", [bh2]), ("eth_baseFee", []),
        ("eth_getUncleCountByBlockNumber", ["0x2"]),
        ("eth_getUncleCountByBlockHash", [bh2]),
        ("eth_getUncleByBlockNumberAndIndex", ["0x2", "0x0"]),
        ("eth_getUncleByBlockHashAndIndex", [bh2, "0x0"]),
        ("eth_getTransactionByBlockNumberAndIndex", ["0x2", "0x0"]),
        ("eth_getTransactionByBlockHashAndIndex", [bh2, "0x0"]),
        ("eth_getTransactionByBlockNumberAndIndex", ["0x2", "0x5"]),
        ("eth_getRawTransactionByHash", [h2]),
        ("eth_getRawTransactionByBlockNumberAndIndex", ["0x2", "0x0"]),
        ("eth_getRawTransactionByBlockHashAndIndex", [bh2, "0x0"]),
        ("eth_callDetailed", [{"to": emitter}, "latest"]),
        ("eth_createAccessList", [{"from": addr, "to": emitter}, "latest"]),
        ("eth_fillTransaction", [{"from": addr, "to": dest,
                                  "value": hex(1)}]),
        ("eth_pendingTransactions", []), ("eth_coinbase", []),
        ("eth_etherbase", []),
        ("eth_getProof", [addr, ["0x0"], "0x1"]),
        ("eth_getProof", [emitter, ["0x0", "0x1"], "latest"]),
        ("debug_getProof", [dest, [], "latest"]),
        ("debug_traceTransaction", [h2]),
        ("debug_traceTransaction", [h2, {"tracer": "callTracer"}]),
        ("debug_traceTransaction", [h2, {"tracer": "4byteTracer"}]),
        ("debug_traceTransaction", [h2, {"tracer": "prestateTracer"}]),
        ("debug_traceTransaction", [h2, {"tracer": "jsTracer9000"}]),
        ("debug_traceTransaction", [h2, {"tracer": OPCOUNT_TRACER}]),
        ("debug_traceTransaction", [h2, {"tracer": CALLSTATS_TRACER}]),
        ("debug_traceTransaction",
         [h2, {"tracer": "seen = {\"bal\": -1}\ndef enter(frame):\n"
                         "    seen[\"bal\"] = balance(frame[\"from\"])\n"
                         "def result():\n    return seen\n"}]),
        ("debug_traceTransaction",
         [h2, {"tracer": "def step(log):\n    import os\n"}]),
        ("debug_traceBlockByNumber", ["0x2"]),
        ("debug_traceBlockByHash", [bh2]),
        ("debug_traceCall", [call, "latest"]),
        ("debug_traceCall", [dict(call, **{"from": addr}), "latest",
                             {"tracer": dsl}]),
        ("debug_dumpBlock", ["latest"]),
        ("debug_dumpBlock", ["latest", {"includeCode": True}]),
        ("debug_accountRange", ["latest", None, 2]),
        ("debug_storageRangeAt", [bh2, 0, emitter, "0x", 10]),
        ("debug_storageRangeAt", [bh2, 1, emitter, "0x", 10]),
        ("debug_storageRangeAt", [bh2, 2, emitter, "0x", 10]),
        ("debug_getModifiedAccountsByNumber", [1]),
        ("debug_getModifiedAccountsByHash", [bh2]),
        ("debug_getAccessibleState", [0, 2]),
        ("debug_getAccessibleState", [2, 0]),
        ("debug_getAccessibleState", [-1, 0]),
        ("debug_getAccessibleState", [2, 2]),
        ("debug_getAccessibleState", [52, 62]),
        ("debug_preimage", ["0x" + "00" * 32]),
        ("debug_getBadBlocks", []),
        ("debug_stateWitness", [addr, "latest"]),
        ("txpool_status", []), ("txpool_content", []),
        ("txpool_contentFrom", [addr]), ("txpool_inspect", []),
        ("net_version", []), ("net_listening", []), ("net_peerCount", []),
        ("web3_sha3", ["0x"]), ("web3_clientVersion", []),
        ("health_check", []),
        ("avax_version", []),
        ("avax_getUTXOs", [[addr]]),
        ("eth_nope", []),
        # keystore-backed: the reference's answer on a node without one
        ("eth_accounts", []),
        ("eth_sign", [addr, "0x00"]),
        ("eth_signTransaction", [{"from": addr, "to": dest}]),
        ("eth_sendTransaction", [{"from": addr, "to": dest}]),
        ("avax_importKey", ["pw", "0x" + "11" * 32]),
        ("avax_importKey", ["pw", "0x11"]),
        ("avax_exportKey", ["pw", addr]),
        ("avax_import", ["pw", addr]),
        ("avax_export", ["pw", "0x10", addr]),
    ]



OPCOUNT_TRACER = """\
counts = {}
def step(log):
    op = log["op"]
    counts[op] = get(counts, op, 0) + 1
def result():
    return counts
"""

CALLSTATS_TRACER = """\
stats = {"maxDepth": 0, "frames": 0, "maxValue": 0}
depth = {"d": 0}
def enter(frame):
    depth["d"] = depth["d"] + 1
    stats["frames"] = stats["frames"] + 1
    stats["maxDepth"] = max(stats["maxDepth"], depth["d"])
    stats["maxValue"] = max(stats["maxValue"], frame["value"])
def exit(res):
    depth["d"] = depth["d"] - 1
def result():
    return stats
"""
