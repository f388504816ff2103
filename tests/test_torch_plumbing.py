"""The VM plumbing the plugin brought to the port (coreth_tpu_torch/vm/
plumbing.py: StaticService, the ext-data-hash repair table and
factory_new) against the JAX package's, on the CPU: twins of
tests/test_plumbing.py:59-79."""

import json

import pytest

from coreth_tpu.vm import plumbing as jplumbing
from coreth_tpu_torch.vm import plumbing
from coreth_tpu_torch.vm.vm import VM


@pytest.mark.parametrize("spec", [
    {"config": {"chainId": 43112}, "alloc": {}},
    {"config": {"chainId": 43114, "apricotPhase3BlockTimestamp": 0},
     "gasLimit": "0x7a1200", "alloc": {"0x" + "aa" * 20: {"balance": "0x1"}},
     "timestamp": "0x0", "extraData": "0x"},
], ids=["minimal", "funded"])
def test_static_service_build_genesis_roundtrip(spec):
    out = plumbing.StaticService().buildGenesis(spec)
    assert out == jplumbing.StaticService().buildGenesis(spec)
    assert out["encoding"] == "hex"
    assert json.loads(bytes.fromhex(out["bytes"][2:])) == spec


def test_ext_data_hash_repair_table():
    h = "0x" + "ab" * 32
    repaired = "0x" + "cd" * 32
    raw = json.dumps({h: repaired, "ef" * 32: "01" * 32}).encode()
    for mod in (jplumbing, plumbing):
        mod.load_ext_data_hashes(5, raw)
    probes = [(5, bytes.fromhex("ab" * 32)), (5, bytes.fromhex("ef" * 32)),
              (5, b"\x00" * 32), (1, bytes.fromhex("ab" * 32))]
    got = [plumbing.repaired_ext_data_hash(n, x) for n, x in probes]
    assert got == [jplumbing.repaired_ext_data_hash(n, x)
                   for n, x in probes]
    assert got == [bytes.fromhex("cd" * 32), bytes.fromhex("01" * 32),
                   None, None]


def test_factory_new_returns_uninitialized_vm():
    vm = plumbing.factory_new()
    assert isinstance(vm, VM)
    assert vm.initialized is False is jplumbing.factory_new().initialized
