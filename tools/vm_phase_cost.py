"""What a VM block's phase clocks and run-keyed flight records cost with
tracing off: the bookkeeping one block of the archive-100k.blocks cell
adds (coreth_tpu_torch/vm/vm.py and vm/block.py: a vm/phase/issue clock
for each of TXS transactions issued, then vm/phase/build, /verify and
/accept; core/blockchain.py and miner/worker.py: the build's flight
record and the check insert's, which now enter the ring), without the
work, less the same loop bare. Least of 40 batches of N, in microseconds
per block, on this host's CPU.

    python tools/vm_phase_cost.py
"""

import os
import sys
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch.autograd.profiler  # noqa: E402,F401  (loaded, as in a run)

from coreth_tpu_torch.metrics import phase_timer  # noqa: E402
from coreth_tpu_torch.metrics.flight import FlightRecorder  # noqa: E402

P = "vm/phase/"
TXS = 368
N = 50
RECORDER = FlightRecorder()


def block():
    for _ in range(TXS):
        with phase_timer(P + "issue"):
            pass
    with phase_timer(P + "build"):
        t0 = time.monotonic()
        t1 = time.monotonic()
        t2 = time.monotonic()
        RECORDER.record({
            "number": 1, "hash": b"\x00" * 32, "txs": TXS, "gas_used": 0,
            "phases": {"execute": t1 - t0, "finalize": t2 - t1,
                       "commit": time.monotonic() - t2},
            "parallel": {}, "writes": False, "run": "build",
            "trace_id": None})
        RECORDER.record({"run": "insert"})
    with phase_timer(P + "verify"):
        pass
    with phase_timer(P + "accept"):
        pass


def bare():
    for _ in range(TXS):
        pass


def per_block_us(fn) -> float:
    return min(timeit.repeat(fn, number=N, repeat=40)) / N * 1e6


def main() -> None:
    with_ = per_block_us(block)
    without = per_block_us(bare)
    print(f"VM block phase clocks and run-keyed records, {TXS} "
          f"transactions: {with_ - without:.2f} us per block (least of 40 "
          f"batches of {N}: {with_:.2f} with, {without:.2f} without)")


if __name__ == "__main__":
    main()
