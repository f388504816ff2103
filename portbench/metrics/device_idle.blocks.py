"""Share of the blocks cell's profiled interval in which no operation
ran on the card: 100 x (1 - busy / interval), from the device trace
(portbench/lib/profile.py). Nothing without a device."""

from portbench.lib.kernels import K1_KERNELS


def read(run):
    p = run.profile
    if p is None or not p.done or not run.cuda() or p.window_s <= 0:
        return None
    k1 = sum(p.kernel_us(name)[0] for name in K1_KERNELS)
    run.log(f"device_idle.blocks: {len(p.device_spans)} device records in "
            f"{p.window_s:.6f} s ({p.records_cut} before the interval); "
            f"K1 {k1} against {run.notes.get('k1_launches_profiled')} "
            f"launches counted")
    return 100.0 * (1.0 - p.busy_s / p.window_s)
