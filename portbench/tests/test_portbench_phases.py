"""The replay cell traced at the cell tests' tiny size on the CPU: each
reader of the resident commit's phase timers (portbench/lib/phases.py)
reads a number, and the gaps of the profiled interval are named by them."""

import json
import os

import torch

from portbench.lib import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
PHASE_READERS = ("update_ms", "stage_ms", "enqueue_ms", "patch_enqueue_ms",
                 "handoff_ms", "readback_ms")


def test_phase_readers_read_a_number():
    out = harness.execute(
        ROOT, "validator-1m.replay", 2**31 + 7, 1.0, True,
        torch.device("cpu"), bench=BENCH, log=lambda m: None,
        config_overrides={"accounts": 2000, "contracts": 10},
        # blocks 1 and 2 give the samples (block 0 has no reading before
        # it), block 3 is profiled
        traffic_overrides={"transfers_per_block": 10, "warmup_blocks": 3,
                           "window_blocks_per_s_max": 400,
                           "prepare_margin_blocks": 4,
                           "profile_skip_blocks": 3, "profile_blocks": 1})
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in PHASE_READERS:
        assert got[name]["unit"] == "ms" and got[name]["value"] >= 0, name
    # the same blocks' readings: the patch is a part of the enqueue
    assert 0 < got["patch_enqueue_ms"]["value"] <= got["enqueue_ms"]["value"]
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert any(k.startswith("resident/phase/") for k in gaps), gaps
