"""K1's share of its roofline on the planned path, over the blocks
loop's profiled interval: the sum over its launches of each launch's
least time (portbench/lib/kernels.py k1_bound_s, from the shapes the
loop recorded at the planned commit's segment Keccak) over the sum of
K1's kernel time in the device trace, by kernel name. Nothing when the
trace holds another number of K1 records than the launches counted, or
no device; never 0."""

from portbench.lib.kernels import K1_KERNELS, k1_bound_s


def read(run):
    p, shapes = run.profile, run.notes.get("k1_shapes")
    if p is None or not p.done or shapes is None or not run.cuda():
        return None
    records, us = 0, 0.0
    for name in K1_KERNELS:
        n, t = p.kernel_us(name)
        records += n
        us += t
    launches = run.notes.get("k1_launches_profiled")
    run.log(f"k1_roofline.blocks: the trace holds {records} K1 records "
            f"against {launches} launches counted in the interval "
            f"({len(shapes)} shapes recorded)")
    if not shapes or launches != len(shapes) or records != launches \
            or us <= 0:
        return None
    bound = sum(k1_bound_s(lanes, blocks) for lanes, blocks in shapes)
    return 100.0 * bound / (us / 1e6)
