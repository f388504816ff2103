"""The archive cell (archive-100k.blocks) end to end at a tiny size on the
CPU, through the harness's internals (the port's kernels run their plain
versions): a sound run, a traced one, the control, planted faults of
the served path, each of which must come out not correct, and the
store's directory, which no run leaves behind."""

import json
import os
import tempfile

import pytest
import torch

from portbench.lib import harness, signer, vm_traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CPU = torch.device("cpu")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELL = "archive-100k.blocks"
CONFIG = {"accounts": 2000, "contracts": 10, "keyed_senders": 50}
# one warm-up block and one window block of 24 transactions (2 calls)
TRAFFIC = {"calls_per_block": 2, "transfers_per_block": 22,
           "warmup_blocks": 1, "window_blocks_per_s_max": 1,
           "prepare_margin_blocks": 0, "profile_skip_blocks": 0,
           "profile_blocks": 1, "control_blocks": 2}
CHECKS = {"root_mismatches", "receipt_mismatches", "lost_txs",
          "readback_mismatches"}


def run_tiny(trace=False, control=False, seed=2**31 + 77, seconds=1.0,
             **traffic):
    return harness.execute(ROOT, CELL, seed, seconds, trace, CPU,
                           control=control, bench=BENCH, log=lambda m: None,
                           config_overrides=dict(CONFIG),
                           traffic_overrides=dict(TRAFFIC, **traffic))


def test_blocks_cell_runs_correct():
    out = run_tiny()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == CHECKS
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if harness.applies(m, CELL)}
    assert set(out["metrics"]) == want == {"commit_rate", "setup_s"}


def test_blocks_cell_traced():
    """A traced run reads every host-side per-layer metric (the device's
    need a card), and the profiled interval's gaps are named by the VM's
    phases. Blocks 1 and 2 of the window give the samples (block 0 has
    no reading before it); block 3 is profiled. The window's 4 blocks
    take well under its 8 s, so the profiled block is reached on a busy
    host too."""
    out = run_tiny(trace=True, seed=12345, seconds=8.0,
                   window_blocks_per_s_max=0.5, profile_skip_blocks=3)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in ("issue_ms", "build_ms", "verify_ms", "accept_ms",
                 "execute_ms", "validate_ms"):
        assert got[name]["unit"] == "ms" and got[name]["value"] > 0, name
    # the verify insert runs the EVM and the root inside the phase
    assert got["execute_ms"]["value"] + got["validate_ms"]["value"] < \
        got["verify_ms"]["value"]
    assert "gc_pause_ms.blocks" in got
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert any(k.startswith("vm/phase/") for k in gaps), gaps


def test_blocks_control_is_not_correct():
    out = run_tiny(control=True)
    assert not out["correct"]
    assert out["checks"]["root_mismatches"]["value"] > 0
    assert out["checks"]["lost_txs"]["value"] > 0


def _writes_undone(monkeypatch):
    """Every SSTORE of a block fails (the call reverts, its writes undone,
    its gas all used); the genesis commit's writes stay."""
    from coreth_tpu_torch import vmerrs
    from coreth_tpu_torch.state.statedb import StateDB
    from coreth_tpu_torch.trie.node import EMPTY_ROOT

    orig = StateDB.set_state

    def set_state(self, addr, key, value):
        if self.original_root != EMPTY_ROOT:
            raise vmerrs.ErrOutOfGas
        return orig(self, addr, key, value)
    monkeypatch.setattr(StateDB, "set_state", set_state)


def _half_dropped(monkeypatch):
    """Every other transaction issued is dropped by the VM."""
    from coreth_tpu_torch.vm.vm import VM

    orig, seen = VM.issue_tx, [0]

    def issue_tx(self, tx):
        seen[0] += 1
        if seen[0] % 2:
            return orig(self, tx)
    monkeypatch.setattr(VM, "issue_tx", issue_tx)


def _receipt_gas(monkeypatch):
    """The chain hands out receipts whose gas is one more than used."""
    import dataclasses

    from coreth_tpu_torch.core.blockchain import BlockChain

    orig = BlockChain.get_receipts

    def get_receipts(self, h):
        rs = orig(self, h)
        return None if rs is None else [
            dataclasses.replace(r, gas_used=r.gas_used + 1) for r in rs]
    monkeypatch.setattr(BlockChain, "get_receipts", get_receipts)


def _node_corrupt(monkeypatch):
    """Every trie node's stored bytes gain a byte as the store closes."""
    from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB

    orig = SQLiteDB.close

    def close(self):
        if not self._closed:
            self._conn.execute(
                "UPDATE kv SET v = v || X'00' WHERE length(k) = 32")
        return orig(self)
    monkeypatch.setattr(SQLiteDB, "close", close)


FAULTS = {
    "writes_undone": (_writes_undone, ("root_mismatches",
                                       "receipt_mismatches",
                                       "readback_mismatches")),
    "half_dropped": (_half_dropped, ("lost_txs",)),
    "receipt_gas": (_receipt_gas, ("receipt_mismatches",)),
    "node_corrupt": (_node_corrupt, ("readback_mismatches",)),
}


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_blocks_faults_are_not_correct(kind, monkeypatch):
    """The served path broken underneath: each fault reads > 0 on the
    numbers that hold the guarantee it breaks."""
    plant, reads = FAULTS[kind]
    plant(monkeypatch)
    out = run_tiny()
    assert not out["correct"]
    for name in reads:
        assert out["checks"][name]["value"] > 0, (name, out["checks"])


@pytest.mark.parametrize("fail", [False, True])
def test_blocks_store_is_removed(fail, tmp_path, monkeypatch):
    """The store's directory, made under the temporary directory, is gone
    when the run ends, also when the run fails."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    if fail:
        from coreth_tpu_torch.vm.vm import VM

        def build_block(self):
            raise RuntimeError("a planted build failure")
        monkeypatch.setattr(VM, "build_block", build_block)
        with pytest.raises(RuntimeError, match="planted"):
            run_tiny()
    else:
        assert run_tiny()["correct"]
    assert os.listdir(tmp_path) == []


def test_signer_recovers_in_the_port():
    """The harness's plain signer: the port's sender recovery finds the
    signing account's address, and the port's hash is the harness's."""
    from coreth_tpu_torch.core.types import Signer, Transaction

    traffic = dict(json.load(open(os.path.join(
        ROOT, "portbench", "traffic", "blocks.json"))), **TRAFFIC)
    config = dict(json.load(open(os.path.join(
        ROOT, "portbench", "configs", "cchain-archive-100k.json"))),
        **CONFIG)
    world = vm_traffic.World(config, traffic, 5)
    gen = vm_traffic.Blocks(world, traffic, 5)
    blocks = [gen.next_block()]
    gen.sign(blocks)
    port = Signer(world.chain_id)
    for tx in blocks[0]:
        got = Transaction.decode(tx.raw)
        assert got.hash() == tx.hash
        assert port.sender(got) == world.addrs[tx.sender]
        assert got.nonce == tx.nonce and got.gas == tx.gas
    # k * G against the textbook double-and-add
    k = 0xC0FFEE ** 7 % signer.N
    acc, add = None, (signer.GX, signer.GY)
    while k:
        if k & 1:
            acc = signer._affine_add(acc, add)
        add = signer._affine_add(add, add)
        k >>= 1
    assert signer.base_mul(0xC0FFEE ** 7 % signer.N) == acc


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): the cells run on the "
                    "card through portbench/run.py")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_blocks_cell_on_the_card(card):
    """The command as a check runs it, short, on the card."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", CELL, "--seed", str(2**31 + 5), "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
