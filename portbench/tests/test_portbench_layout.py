"""BENCHMARK.json's shape and names; that a cell, a configuration, a
traffic mix and a metric added as new files are found by name with no
file edited; and that nothing a run loads is JAX or the JAX package."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.lib import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    bench = BENCH
    names = []
    for c in bench["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        names.append(w["name"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)


def test_metrics_are_wired():
    bench = BENCH
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for w in m["workloads"]:
            assert w in cells and harness.applies(e2e[m["moves"]], w)
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
    for w in cells:
        got = [m for m in e2e.values() if harness.applies(m, w)]
        assert len(got) >= 2
        assert any(harness.applies(m, w) for m in bench["per_layer"])


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    out["BENCHMARK.json"] = hashlib.sha256(
        open(os.path.join(root, "BENCHMARK.json"), "rb").read()).hexdigest()
    return out


def test_new_cell_config_mix_and_metric_are_files(tmp_path):
    """A later PR's additions: a configuration, a traffic mix, a metric
    reader and a cell, each a new file or entry, found by name; every
    file that was there is unchanged."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    cfg = json.load(open(os.path.join(root, "portbench", "configs",
                                      "cchain-validator-1m.json")))
    cfg.update(name="cchain-validator-3k", accounts=3000, contracts=5)
    json.dump(cfg, open(os.path.join(root, "portbench", "configs",
                                     "cchain-validator-3k.json"), "w"))
    mix = json.load(open(os.path.join(root, "portbench", "traffic",
                                      "replay.json")))
    mix.update(transfers_per_block=10, warmup_blocks=2,
               prepare_margin_blocks=2, profile_skip_blocks=0,
               profile_blocks=1)
    json.dump(mix, open(os.path.join(root, "portbench", "traffic",
                                     "replay-small.json"), "w"))
    with open(os.path.join(root, "portbench", "metrics",
                           "blocks_seen.py"), "w") as f:
        f.write("def read(run):\n"
                "    return len(run.series.get('verify_ms', []))\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append(dict(
        name="cchain-validator-3k", source="a test", why="a test",
        file="portbench/configs/cchain-validator-3k.json", reduced=[]))
    bench["workloads"].append(dict(
        name="validator-3k.small", config="cchain-validator-3k",
        traffic="replay-small", chips=1, why="a test"))
    for m in bench["end_to_end"]:
        if "validator-1m.replay" in m.get("workloads", ()):
            m["workloads"].append("validator-3k.small")
    bench["per_layer"].append(dict(
        name="blocks_seen", unit="blocks", better="higher",
        source="host_clock", layer="resident mirror", moves="commit_rate",
        workloads=["validator-3k.small"]))
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    after = _digests(root)
    changed = [p for p in before if before[p] != after.get(p)]
    assert changed == ["BENCHMARK.json"]
    out = harness.execute(root, "validator-3k.small", 7, 1.0, True,
                          torch.device("cpu"), log=lambda m: None)
    assert out["correct"]
    assert out["metrics"]["blocks_seen"]["value"] > 0


GUARD = r"""
import sys, torch
sys.path.insert(0, {root!r})
from portbench.lib import harness
mods = ["portbench.lib.accounts", "portbench.lib.replay_traffic",
        "portbench.lib.hostprobe", "portbench.lib.profile",
        "portbench.lib.kernels"]
for m in mods:
    __import__(m)
harness.execute({root!r}, "validator-1m.replay", 3, 0.5, False,
                torch.device("cpu"), log=lambda m: None,
                config_overrides={{"accounts": 1000, "contracts": 5}},
                traffic_overrides={{"transfers_per_block": 10,
                                    "warmup_blocks": 2,
                                    "prepare_margin_blocks": 2}})
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REF_GUARD = r"""
import sys
sys.path.insert(0, {root!r})
import portbench.reference.keccak, portbench.reference.mpt
import portbench.reference.rlp, portbench.reference.simple_trie
portbench.reference.mpt.root_of_items([(b"\x01" * 32, b"x" * 40)])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _tops(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """The harness, the traffic and a cell's whole run (the port
    included) load no module whose top-level name is jax, jaxlib, flax or
    coreth_tpu, compared whole: coreth_tpu_torch is the port."""
    tops = _tops(GUARD)
    assert "coreth_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "coreth_tpu"}


def test_reference_loads_nothing_of_the_port():
    tops = _tops(REF_GUARD)
    assert not tops & {"jax", "jaxlib", "flax", "coreth_tpu",
                       "coreth_tpu_torch"}


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "coreth_tpu"])
def test_forbidden_names_compare_whole(name):
    assert name in harness.FORBIDDEN
    assert "coreth_tpu_torch".split(".")[0] not in harness.FORBIDDEN
