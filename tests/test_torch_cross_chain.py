"""The cross-chain eth_call both ways (coreth_tpu_torch/vm/vm.py:
handle_cross_chain_request and cross_chain_eth_call) against the JAX
package's, on the CPU: twin of tests/test_peer_transport.py's
TestCrossChainEthCall.

Two VMs of each package on their own chain ids; chain B asks chain A over
a peer.Network's cross-chain registry. The EthCallResponse bytes chain A
answers equal the reference's for a success, an in-band execution error,
an argument that is not JSON and a keccak256Batch call of the precompile
(64 messages: the port's K2 seam, on its plain version here); an unknown
chain fails at the transport with the same NetworkError, a request that
is not an EthCallRequest with the same VMError.
"""

import dataclasses
import importlib
import json

import pytest

from coreth_tpu_torch.native import keccak256
from test_torch_precompile import batch_call, messages

PKGS = ("coreth_tpu", "coreth_tpu_torch")
RICH = b"\xaa" * 20
CHAIN_A = b"\x0a" * 32
CHAIN_B = b"\x0b" * 32


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def boot(pkg, chain_id, alloc):
    g = mod(pkg, "core.genesis")
    params = mod(pkg, "params")
    tk = mod(pkg, "precompile.tpu_keccak")
    cfg = dataclasses.replace(
        params.TEST_CHAIN_CONFIG,
        precompile_upgrades=(tk.TpuKeccakConfig(timestamp=0),))
    genesis = g.Genesis(config=cfg, gas_limit=params.CORTINA_GAS_LIMIT,
                        alloc={a: g.GenesisAccount(balance=b)
                               for a, b in alloc.items()})
    vm = mod(pkg, "vm.vm").VM()
    # the reference hashes on its native keccak; the port's VM on the CPU
    # takes its default seams (K2's plain version)
    knobs = {"device-hasher": "off"} if pkg == "coreth_tpu" else {}
    kw = {"device": "cpu"} if pkg == "coreth_tpu_torch" else {}
    vm.initialize(mod(pkg, "vm.vm").SnowContext(
        chain_id=chain_id, shared_memory=mod(pkg, "vm.shared_memory").Memory()),
        mod(pkg, "ethdb").MemoryDB(), genesis,
        config_bytes=json.dumps(knobs).encode(), **kw)
    return vm


@pytest.fixture(scope="module")
def chains():
    """{pkg: (vm_a, vm_b, net)}: chain A registered on net."""
    out = {}
    for pkg in PKGS:
        vm_a = boot(pkg, CHAIN_A, {RICH: 123456})
        vm_b = boot(pkg, CHAIN_B, {})
        net = mod(pkg, "peer.network").Network()
        net.register_cross_chain_handler(vm_a.chain_id_bytes,
                                         vm_a.handle_cross_chain_request)
        out[pkg] = (vm_a, vm_b, net)
    yield out
    for pkg, (vm_a, vm_b, net) in out.items():
        vm_a.shutdown()
        vm_b.shutdown()
        if hasattr(net, "close"):
            net.close()
        elif net._pool is not None:  # the reference's Network has no close()
            net._pool.shutdown(wait=True)


def _request(pkg, call_obj=None, raw_args=None):
    m = mod(pkg, "sync.messages")
    args = raw_args if raw_args is not None else json.dumps(
        call_obj).encode()
    return m.EthCallRequest(request_args=args).encode()


CALLS = {
    "success": {"to": "0x" + RICH.hex(), "from": "0x" + RICH.hex()},
    "execution-error": {"to": "0x" + RICH.hex(), "from": "0x" + RICH.hex(),
                        "value": hex(10**30)},  # more than the balance
    "keccak256Batch": {
        "to": "0x0100000000000000000000000000000000000010",
        "data": "0x" + batch_call(messages(7, 64)).hex(), "gas": hex(10**7)},
}


@pytest.mark.parametrize("case", sorted(CALLS) + ["not-json"])
def test_eth_call_response_bytes_equal_the_reference(chains, case):
    got = {}
    for pkg, (vm_a, _b, _n) in chains.items():
        req = (_request(pkg, raw_args=b"{not json") if case == "not-json"
               else _request(pkg, CALLS[case]))
        got[pkg] = vm_a.handle_cross_chain_request(req)
    assert got["coreth_tpu_torch"] == got["coreth_tpu"]
    resp = mod(PKGS[1], "sync.messages").decode_message(got[PKGS[1]])
    assert bool(resp.error) == (case in ("execution-error", "not-json"))
    if case == "keccak256Batch":
        for m in messages(7, 64):
            assert keccak256(m) in resp.result


def test_cross_chain_call_and_error(chains):
    """Twin of TestCrossChainEthCall.test_cross_chain_call_and_error: the
    client side over the registry, its errors the reference's."""
    outs = {}
    for pkg, (vm_a, vm_b, net) in chains.items():
        VMError = mod(pkg, "vm.vm").VMError
        NetworkError = mod(pkg, "peer.network").NetworkError
        out = [vm_b.cross_chain_eth_call(net, vm_a.chain_id_bytes,
                                         CALLS["success"]),
               vm_b.cross_chain_eth_call(net, vm_a.chain_id_bytes,
                                         CALLS["keccak256Batch"])]
        with pytest.raises(VMError, match="cross-chain eth_call failed") \
                as e1:
            vm_b.cross_chain_eth_call(net, vm_a.chain_id_bytes,
                                      CALLS["execution-error"])
        with pytest.raises(NetworkError, match="unknown chain") as e2:
            vm_b.cross_chain_eth_call(net, b"\x0c" * 32, {})
        with pytest.raises(VMError, match="unsupported cross-chain") as e3:
            vm_a.handle_cross_chain_request(
                mod(pkg, "sync.messages").EthCallResponse(
                    result=b"", error=b"x").encode())
        outs[pkg] = out + [str(e.value).replace(pkg + ".", "")
                           for e in (e1, e2, e3)]
    assert outs["coreth_tpu_torch"] == outs["coreth_tpu"]
    assert outs["coreth_tpu_torch"][0] == b""
