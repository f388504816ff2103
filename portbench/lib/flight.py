"""The chain's flight records (coreth_tpu_torch/metrics/flight.py) read
per block of the blocks loop's window: a phase of the block's record
from its verify run, the insert that commits (the record's `run` key
says which of a built block's three runs it is). A program whose
records carry no `run` key gives nothing."""

from __future__ import annotations

import statistics


def sample(run, phase: str) -> float | None:
    """Milliseconds of `phase` in the verify run of the block just done,
    noted with the block's index."""
    chain = run.objects.get("chain")
    h = run.notes.get("last_block")
    if chain is None or h is None:
        return None
    recs = [r for r in chain.flight_recorder.last()
            if r.get("hash") == h and r.get("run") == "verify"]
    if not recs or phase not in recs[-1]["phases"]:
        return None
    n = len(run.series["block_ms"]) - 1
    run.notes.setdefault("flight_blocks." + phase, []).append(n)
    return recs[-1]["phases"][phase] * 1e3


def read(run, phase: str) -> float | None:
    a, b = run.notes.get("profiled_blocks", (0, 0))
    blocks = run.notes.get("flight_blocks." + phase, [])
    xs = [x for k, x in zip(blocks, run.samples.get(phase + "_ms") or [])
          if not a <= k < b]
    return statistics.median(xs) if xs else None
