"""What the resident commit's phase clocks cost with tracing off: the
bookkeeping of one depth-0 verify's phases (coreth_tpu_torch/metrics
phase_timer, PhaseSeq, PhaseRelay's check, phase_add; 19 segments, as a
block of the validator-1m.replay cell), without the work, less the same
loop and resident/commit span check bare. Least of 40 batches of 300, in
microseconds per commit, on this host's CPU.

    python tools/phase_clock_cost.py [checkout]

`checkout` (default: this one) is the root whose coreth_tpu_torch is
timed; one whose metrics have no PhaseSeq (a checkout from before the
phase clocks) is timed on what it had, its one resident/phase/commit
timer.
"""

import os
import sys
import time
import timeit

ROOT = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch.autograd.profiler  # noqa: E402,F401  (loaded, as in a run)

from coreth_tpu_torch import metrics  # noqa: E402
from coreth_tpu_torch.metrics import phase_timer, spans  # noqa: E402

P = "resident/phase/"
SEGMENTS = 19
N = 300


def commit():
    with phase_timer(P + "update"):
        pass
    with spans.span("resident/commit"), phase_timer(P + "commit"):
        with phase_timer(P + "plan"):
            pass
        with phase_timer(P + "export"):
            pass
        # native/mpt.py _run_with_watchdog, less the thread
        t_call = time.monotonic()
        if metrics.PhaseRelay.for_caller(P + "handoff") is not None:
            raise SystemExit("a profiler session runs: nothing to time")
        parent = spans.tracer.current() if spans.enabled else None
        t0 = time.monotonic()
        with spans.handed_over(parent):
            with metrics.PhaseSeq() as ph:
                ph.to(P + "stage")
                ph.to(P + "scatter")
                for _ in range(SEGMENTS):
                    ph.to(P + "patch")
                    ph.to(P + "hash")
                ph.to(P + "store")
            with phase_timer(P + "readback"):
                pass
            t1 = time.monotonic()
        metrics.phase_add(P + "handoff",
                          (t0 - t_call) + (time.monotonic() - t1))
    with phase_timer(P + "record"):
        pass


def commit_before_phase_clocks():
    with spans.span("resident/commit"), phase_timer(P + "commit"):
        for _ in range(SEGMENTS):
            pass


def bare():
    with spans.span("resident/commit"):
        for _ in range(SEGMENTS):
            pass


def per_commit_us(fn) -> float:
    return min(timeit.repeat(fn, number=N, repeat=40)) / N * 1e6


def main() -> None:
    phased = hasattr(metrics, "PhaseSeq")
    with_ = per_commit_us(commit if phased else commit_before_phase_clocks)
    without = per_commit_us(bare)
    what = "phase clocks" if phased else "the one commit timer"
    print(f"{ROOT}: {what}, {SEGMENTS} segments: {with_ - without:.2f} us "
          f"per commit (least of 40 batches of {N}: {with_:.2f} with, "
          f"{without:.2f} without)")
    if phased:
        check = min(timeit.repeat(metrics._profiling, number=20000,
                                  repeat=20)) / 20000 * 1e6
        print(f"the profiler check (module flag): {check:.3f} us")


if __name__ == "__main__":
    main()
