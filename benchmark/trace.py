"""The traced run's device record: torch.profiler over a bounded slice of
a cell's traffic, device activity only, events kept in memory (no chrome
trace is written).

`DeviceTrace` holds one rank's device operations as (name, start_us,
end_us) and the traced window's length on the host clock; the per-layer
metrics (benchmark/metrics/) read it.
"""

from __future__ import annotations

import dataclasses
import re
import time


@dataclasses.dataclass
class DeviceTrace:
    events: list        # (name, start_us, end_us), sorted by start
    window_s: float     # host clock from the synchronised start to the synchronised end

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of them)."""
        busy, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.events:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def op_seconds(self, match) -> float:
        """Summed device seconds of the operations whose name match(name)."""
        return sum(e - s for n, s, e in self.events if match(n)) / 1e6

    def op_count(self, match) -> int:
        return sum(1 for n, _, _ in self.events if match(n))

    def top_ops(self, k: int = 10) -> list:
        """The k device operations that took most time, by short name."""
        tot = {}
        for n, s, e in self.events:
            tot[short(n)] = tot.get(short(n), 0.0) + (e - s) / 1e6
        return sorted(([n, v] for n, v in tot.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The idle gaps between device operations, summed by the pair of
        operations around them ("before -> after"): what the host was
        launching while the device waited. The window's time before the
        first and after the last operation is "host: window edges"."""
        gaps, last_e, last_n = {}, 0.0, None
        for n, s, e in self.events:
            if last_n is not None and s > last_e:
                key = f"{short(last_n)} -> {short(n)}"
                gaps[key] = gaps.get(key, 0.0) + (s - last_e) / 1e6
            if last_n is None or e > last_e:
                last_e, last_n = e, n
        edges = self.window_s - last_e / 1e6
        if edges > 0:
            gaps["host: window edges"] = edges
        return sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:k]


def short(name: str) -> str:
    """A device operation's name without its C++ signature: the program's
    own kernels as pt::<kernel>, PyTorch's as <kernel>[<functor>] (for
    "void at::native::vectorized_elementwise_kernel<4, ...MulFunctor<float>
    >(...)", vectorized_elementwise_kernel[MulFunctor])."""
    own = re.search(r"pt::\w+", name)
    if own:
        return own.group(0)
    kernel = re.search(r"\w*(?:kernel|Kernel)\w*", name)
    functors = re.findall(r"\w*(?:Functor|functor)\w*", name)
    if kernel:
        return kernel.group(0) + (f"[{functors[-1]}]" if functors else "")
    return name if len(name) <= 60 else name[:57] + "..."


def profile(fn, device):
    """(fn's result, DeviceTrace) of fn() under torch.profiler, device
    activity only. The window runs from a synchronised start to a
    synchronised end; event times are microseconds from the window's start.
    Raises when the profiler recorded no device operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    evs = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
    if not evs:
        raise RuntimeError("the profiler recorded no device operation")
    evs.sort(key=lambda x: x[1])
    base = evs[0][1]  # device times from the first operation's start
    evs = [(n, s - base, e - base) for n, s, e in evs]
    return out, DeviceTrace(evs, window_s)
