"""95th percentile over the window's blocks of the time from the
ResidentAccountMirror.verify call to the root it returns (the harness's
clock), the profiled interval's blocks left out (the profiler slows
them). A per-layer metric: across runs its spread on the card is wider
than an end-to-end bound may be (PERF.md §2)."""

import numpy as np


def read(run):
    xs = run.series.get("verify_ms")
    if not xs:
        return None
    a, b = run.notes.get("profiled_blocks", (0, 0))
    xs = xs[:a] + xs[b:]
    return float(np.percentile(xs, 95)) if xs else None
