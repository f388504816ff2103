"""K1 launches per block over the blocks loop's window: the change in
ops/keccak_cuda.launches across each block (its build, verify and
accept: the planned commits of the miner, the check insert and the
verify insert), averaged. Nothing without a device (the CPU's plain
version launches no kernel)."""


def read(run):
    xs = run.series.get("k1_launches")
    if not xs or not run.cuda():
        return None
    return sum(xs) / len(xs)
