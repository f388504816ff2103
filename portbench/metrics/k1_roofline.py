"""K1's share of its roofline over the profiled interval: the sum over
its launches of each launch's least time (portbench/lib/kernels.py
k1_bound_s, from the shapes the harness recorded) over the sum of K1's
kernel time in the device trace, by kernel name. Nothing when the trace
holds another number of K1 records than the launches counted, or no
device."""

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
    run.log(f"k1_roofline: the trace holds {records} K1 records against "
            f"{launches} launches counted in the interval "
            f"({len(shapes)} shapes recorded)")
    if launches != len(shapes):
        return None
    if records != launches or us <= 0:
        return None
    bound = sum(k1_bound_s(lanes, blocks) for lanes, blocks in shapes)
    return 100.0 * bound / (us / 1e6)
