"""The profiled interval of a traced run: torch.profiler (CUPTI) over a
bounded run of steady blocks, reduced to device busy time, kernel time by
name and the host's activity in the device's idle gaps.

The card's trace drops a prefix of a session's kernel records. So the
session opens with a lead-in (kernels launched only to be dropped), then
LEAD_GAP_S of idle card, then a host span (MARK) that bounds the
interval on the trace's own clock: the device records that start inside
it are the interval's. The readers print how many records they hold
against the launches the program counted.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

LEAD_GAP_S = 0.05
MARK = "portbench.interval"  # host span that bounds the interval


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters
    (which run to a thousand characters for torch's elementwise kernels),
    keeping the functor it applies."""
    if len(name) <= 80:
        return name
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    head = re.split(r"[<(]", n, maxsplit=1)[0]
    rest = n[len(head):]
    inner = [f for f in re.findall(
        r"(\w+(?:Functor|_kernel_cuda|_kernel|_op))", rest)
        if f not in ("AUnaryFunctor", "BUnaryFunctor", "BinaryFunctor")]
    return (head + (f"<{inner[0]}>" if inner else ""))[:120]


def _union_us(spans):
    """Total length of the union of (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Interval:
    def __init__(self, device, lead_in, log):
        self.device = device
        self.lead_in = lead_in
        self.log = log
        self.prof = None
        self.stopped = False
        self.done = False
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels = {}      # name -> [count, device us]
        self.device_spans = []  # (start us, end us, name), after the cut
        self.gaps = []          # (us, host activity)
        self.records_cut = 0

    def begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.lead_in()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        time.sleep(LEAD_GAP_S)
        self._mark = record_function(MARK)
        self._mark.__enter__()

    def end(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.stopped = True

    def reduce(self) -> None:
        """Read the trace (after the window: this takes a while)."""
        from torch.autograd import DeviceType

        if not self.stopped or self.done:
            return
        self.done = True
        dev_ev, cpu_ev = [], []
        m0 = m1 = None
        events = self.prof.events()
        # a host range (record_function) is mirrored on the device's
        # timeline under its own name: that is no device work
        host_names = {e.name for e in events
                      if e.device_type == DeviceType.CPU}
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if e.name in host_names or getattr(e, "is_user_annotation",
                                                   False):
                    continue
                dev_ev.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CPU:
                if e.name == MARK:
                    m0, m1 = tr.start, tr.end
                else:
                    cpu_ev.append((tr.start, tr.end, e.name))
        if m0 is None:
            self.log("profiler: the interval's marker is not in the trace")
            return
        dev_ev.sort()
        cpu_ev.sort()
        self.records_cut = sum(1 for s, _, _ in dev_ev if s < m0)
        spans = [(max(s, m0), min(e, m1), n) for s, e, n in dev_ev
                 if s >= m0 and s < m1]
        self.device_spans = spans
        self.window_s = (m1 - m0) / 1e6
        for s, e, name in spans:
            k = self.kernels.setdefault(short_name(name), [0, 0.0])
            k[0] += 1
            k[1] += e - s
        self.busy_s = _union_us([(s, e) for s, e, _ in spans]) / 1e6
        # idle gaps between device activity inside the interval, named by
        # the innermost host event that covers the gap's middle
        starts = [s for s, _, _ in cpu_ev]
        gaps = []
        end = m0
        for s, e, _ in spans:
            if s > end:
                gaps.append((s - end, (s + end) / 2))
            end = max(end, e)
        if m1 > end:
            gaps.append((m1 - end, (m1 + end) / 2))
        gaps.sort(reverse=True)
        for us, mid in gaps:
            j = bisect.bisect_right(starts, mid) - 1
            name = "host outside any recorded op"
            for k in range(j, max(j - 2000, -1), -1):
                if cpu_ev[k][1] >= mid:
                    name = cpu_ev[k][2]
                    break
            self.gaps.append((us, name))
        self.prof = None

    def kernel_us(self, pattern: str):
        """(records, device us) of the kernels whose name holds
        `pattern`."""
        n = t = 0
        for name, (c, us) in self.kernels.items():
            if pattern in name:
                n += c
                t += us
        return n, t

    def top_ops(self, k: int):
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name, us / 1e6] for name, (_, us) in ops]

    def top_gaps(self, k: int):
        """Idle seconds summed by what the host was doing, largest first."""
        by = defaultdict(float)
        for us, name in self.gaps:
            by[name] += us
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, us / 1e6] for name, us in top]
