"""K1 launches per commit over the window: the change in
ops/keccak_cuda.launches across each verify, averaged."""


def read(run):
    xs = run.series.get("k1_launches")
    return sum(xs) / len(xs) if xs else None
