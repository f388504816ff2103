"""The port's chaos conductor (coreth_tpu_torch/fault/chaos.py) against
the JAX package's, on the CPU (device="cpu": the resident mirror and the
storage programs run K1's plain version, the ladder's probes K2's).

A run of the same seed and steps must give the reference's JSON, apart
from the fields that the port's device rule changes (ROADMAP Queue 3:
only a caller demotes, and a failed dispatch reaches it, with no retry),
each pinned here: an armed ops/device/dispatch fires once per raising
device drill where the reference's retry fires it twice; and apart from
the final height and root where the insert tail's timing decides them in
both packages (Queue 3). The same seed gives byte-identical JSON twice
(seed 9, whose schedule has no such race); the SIGKILL drill repairs the
child's SQLite store to the head it reported; the CLI keeps the
reference's arguments and exit codes.
"""

import ast
import copy
import json

import pytest

from coreth_tpu.fault import chaos as jchaos
from coreth_tpu_torch.fault import chaos
from coreth_tpu_torch.ops.device import default_ladder


def canonical(result):
    return json.dumps(result, sort_keys=True)


@pytest.fixture(autouse=True)
def _fresh_ladders():
    from coreth_tpu.ops.device import default_ladder as j_ladder

    yield
    default_ladder().reset()
    j_ladder().reset()


def test_catalogue_is_the_reference_catalogue_and_registered():
    """The same 19 failpoints, subsystems, actions and bounded specs; every
    name is registered by the port's modules once they are imported."""
    from coreth_tpu_torch import fault
    from coreth_tpu_torch.core import blockchain, exec_shards, \
        insert_pipeline, shard_worker  # noqa: F401
    from coreth_tpu_torch.ethdb import faultdb  # noqa: F401
    from coreth_tpu_torch.ops import device  # noqa: F401
    from coreth_tpu_torch.rpc import server  # noqa: F401
    from coreth_tpu_torch.trie import resident_mirror  # noqa: F401

    assert chaos.CATALOGUE == jchaos.CATALOGUE
    assert len(chaos.CATALOGUE) == 19
    assert {e[1] for e in chaos.CATALOGUE} == {
        "ethdb", "insert", "rpc", "device", "shard"}
    assert not {e[0] for e in chaos.CATALOGUE} - set(fault.registered())


def _pin_departures(ref: dict, port: dict) -> dict:
    """The reference's result with the port's departures applied (module
    docstring): returns the expected port result."""
    want = copy.deepcopy(ref)
    raising = sum(1 for s in ref["step_log"]
                  if s["armed"] == "ops/device/dispatch"
                  and s["spec"].startswith("raise"))
    if raising:
        assert ref["fired"]["ops/device/dispatch"] == 2 * raising
        want["fired"]["ops/device/dispatch"] = raising
    return want


# the fields that the insert tail's timing decides in both packages
# (ROADMAP Queue 3): a `chain/tail/*` raise armed over a two-block burst
# (seed 5, step 23) lands the burst's second block or not, run to run
TIMED = ("height", "accepted", "root")


def _untimed(result: dict) -> dict:
    out = copy.deepcopy(result)
    for k in TIMED:
        out["final"].pop(k)
    return out


def test_seed5_matches_the_reference_but_the_pinned_fields():
    ref = jchaos.run_chaos(seed=5, steps=24, kill_drill=False)
    port = chaos.run_chaos(seed=5, steps=24, kill_drill=False, device="cpu")
    assert port["violations"] == [] and ref["violations"] == []
    want = _pin_departures(ref, port)
    assert canonical(_untimed(port)) == canonical(_untimed(want))
    # the timed fields: the same block when the burst raced alike, else
    # one block apart (the reference itself gives either)
    pf, rf = port["final"], ref["final"]
    assert abs(pf["height"] - rf["height"]) <= 1
    assert pf["root"] == rf["root"] or pf["height"] != rf["height"]
    # the pinned field did move: seed 5 runs a raising device drill
    assert port["fired"]["ops/device/dispatch"] == 1
    assert ref["fired"]["ops/device/dispatch"] == 2
    assert port["final"]["device_demotions"] == 1
    assert port["coverage"]["subsystems"] == [
        "device", "ethdb", "insert", "rpc", "shard"]
    assert port["final"]["accepted"] == port["final"]["height"] > 0
    assert default_ladder().healthy


def test_same_seed_is_byte_identical():
    a = chaos.run_chaos(seed=9, steps=10, kill_drill=False, device="cpu")
    b = chaos.run_chaos(seed=9, steps=10, kill_drill=False, device="cpu")
    assert a["violations"] == []
    assert canonical(a) == canonical(b)


def test_kill_drill_repairs_to_the_reported_head():
    """seed 3, steps 8: the child (on the CPU, named explicitly) is
    SIGKILLed with a torn tail and its SQLite store reboots on the port's
    chain to exactly block 2."""
    result = chaos.run_chaos(seed=3, steps=8, kill_drill=True, device="cpu")
    assert result["violations"] == []
    kd = result["kill_drill"]
    assert kd["ok"] and kd["torn_on_disk"]
    assert kd["repaired_head"] == kd["expected_head"]
    assert kd["repaired_number"] == 2
    assert any(s["action"] == "kill-drill" for s in result["step_log"])


def test_kill_child_imports_only_the_port():
    """The child is source text the AST scan of the package cannot see:
    parse it and check every import, and that it names its device."""
    tree = ast.parse(chaos._KILL_CHILD)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    roots = {m.split(".")[0] for m in mods}
    assert roots == {"sys", "threading", "coreth_tpu_torch"}
    assert "device=DEVICE" in chaos._KILL_CHILD


def test_cli_exit_codes_and_device(capsys, monkeypatch):
    assert chaos.main(["--seed", "5", "--steps", "6", "--no-kill-drill",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("chaos seed=5 steps=6: 0 violation(s)")
    monkeypatch.setattr(chaos, "run_chaos", lambda *a, **k: {
        "violations": [{"step": 1, "what": "x", "detail": "y"}],
        "coverage": {"failpoints_fired": 0, "subsystems": []},
        "final": {"height": 0}})
    assert chaos.main(["--seed", "1", "--steps", "1", "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["violations"]


def test_cuda_is_the_default_device(monkeypatch):
    """Without CUDA the conductor refuses to boot when no device is
    named: it never drifts to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chaos.Conductor(1, 1)
