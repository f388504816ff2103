"""Each cell end to end at a tiny size on the CPU, through the harness's
internals (the port's kernels run their plain versions); the controls
and planted faults of the timed path, which must come out not correct;
and the card-only run, which skips here."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.lib import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CPU = torch.device("cpu")


BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

TINY = {
    "validator-1m.replay": dict(
        config_overrides={"accounts": 2000, "contracts": 10},
        traffic_overrides={"transfers_per_block": 20, "warmup_blocks": 3,
                           "window_blocks_per_s_max": 400,
                           "prepare_margin_blocks": 4,
                           "profile_skip_blocks": 0, "profile_blocks": 1,
                           "control_blocks": 4}),
}
SECONDS = 1.0


def run_tiny(cell, trace=False, control=False, seed=2**31 + 99):
    return harness.execute(ROOT, cell, seed, SECONDS, trace, CPU,
                           control=control, bench=BENCH, log=lambda m: None,
                           **TINY[cell])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_correct(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if harness.applies(m, cell)}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_traced(cell):
    """A traced run reads the host-side per-layer metrics (the device's
    need a card) and keeps its breakdown."""
    out = run_tiny(cell, trace=True, seed=12345)
    assert out["correct"], out["checks"]
    names = {m["name"] for m in BENCH["per_layer"] if harness.applies(m, cell)}
    assert set(out["metrics"]) <= names
    assert any(n.startswith("gc_pause_ms") for n in out["metrics"])
    assert "breakdown" in out and "window_s" in out["device"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    out = run_tiny(cell, control=True)
    assert not out["correct"]
    assert out["checks"]["root_mismatches"]["value"] > 0


def _verify_fault(kind):
    from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror

    orig = ResidentAccountMirror.verify

    def verify(self, parent, h, updates, *a, **kw):
        updates = list(updates)
        if kind == "unchanged":
            return orig(self, parent, h, [], *a, **kw)
        if kind == "half":
            return orig(self, parent, h, updates[:len(updates) // 2], *a,
                        **kw)
        root = orig(self, parent, h, updates, *a, **kw)
        return bytes([root[0] ^ 1]) + root[1:]
    return verify


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_replay_faults_are_not_correct(kind, monkeypatch):
    """The timed path broken underneath: a commit that leaves the state
    as it was, one that drops half of the block's leaves, and a root
    altered where the mirror returns it."""
    from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror

    monkeypatch.setattr(ResidentAccountMirror, "verify", _verify_fault(kind))
    out = run_tiny("validator-1m.replay")
    assert not out["correct"]
    assert out["checks"]["root_mismatches"]["value"] > 0


def test_a_reader_that_loads_jax_gives_no_result(tmp_path, monkeypatch):
    """sys.modules is looked at again once every reader has run: a
    per-layer reader that loads a module named jax (a stand-in here)
    stops the run before it gives a result."""
    import shutil

    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(root, "portbench", "metrics", "plan_ms.py"),
              "a") as f:
        f.write("\n\n_read = read\n\n\ndef read(run):\n"
                "    import sys\n    import types\n"
                "    sys.modules['jax'] = types.ModuleType('jax')\n"
                "    return _read(run)\n")
    bench = json.loads(json.dumps(BENCH))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        with pytest.raises(harness.BenchmarkError, match="jax"):
            harness.execute(root, "validator-1m.replay", 11, SECONDS, True,
                            CPU, bench=bench, log=lambda m: None,
                            **TINY["validator-1m.replay"])
    finally:
        sys.modules.pop("jax", None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): the cells run on the "
                    "card through portbench/run.py")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_on_the_card(cell, card):
    """The command as a check runs it, short, on the card (a cell of
    BENCHMARK.json)."""
    if cell not in {w["name"] for w in json.load(open(os.path.join(
            ROOT, "BENCHMARK.json")))["workloads"]}:
        pytest.skip(f"{cell} is not listed in BENCHMARK.json yet")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", cell, "--seed", str(2**31 + 5), "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "validator-1m.replay", "--seed", "1", "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout
