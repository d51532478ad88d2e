"""What a traced run records, and the arithmetic every per-layer reader
shares.

A ``Trace`` holds plain lists, so a reader can be tested on a recorded
profile without a card:

  * ``device``: (name, start_us, end_us) of every operation the device ran
    in the traced window (kernels, copies, fills), from ``torch.profiler``;
  * ``host``: (name, start_us, end_us) of the harness's labelled host
    ranges in that window (``torch.profiler.record_function``);
  * ``window_s``: the traced window's length on the host clock;
  * ``calls``: per kernel, the work model's bound in ms of each call the
    window made (recorded around the program's kernel entry points);
  * ``spans``: per span name, the ms of each synchronised span;
  * ``info``: counts a reader needs (steps traced, FLOPs a step, ...).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Trace:
    device: list = dataclasses.field(default_factory=list)
    host: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    calls: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of their
        intervals)."""
        total, end = 0.0, None
        for s, e in sorted((s, e) for _, s, e in self.device):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def idle_pct(self) -> float | None:
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_s(self, name: str) -> float:
        """Device seconds of the operations whose name holds ``name``."""
        return sum(e - s for n, s, e in self.device if name in n) / 1e6

    def kernel_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.device if name in n)

    def roofline_pct(self, kernel: str, name: str) -> float | None:
        """The kernel's share of its roofline: the work model's least time
        a call over the device time a launch, both averaged over the
        window (a trace may lose a few device events at its start).  None
        where no call was recorded or fewer than nine tenths of the
        launches were traced."""
        bounds = self.calls.get(kernel, [])
        n = self.kernel_count(name)
        if not bounds or n < 0.9 * len(bounds) or n > len(bounds):
            return None
        per_launch_s = self.kernel_s(name) / n
        return 100.0 * sum(bounds) / len(bounds) / 1e3 / per_launch_s

    def span_mean_ms(self, name: str) -> float | None:
        vals = self.spans.get(name)
        return sum(vals) / len(vals) if vals else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the host range that was open across them."""
        ops: dict[str, float] = {}
        for n, s, e in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
        gaps: dict[str, float] = {}
        ivs = sorted((s, e) for _, s, e in self.device)
        end = ivs[0][1] if ivs else None
        for s, e in ivs[1:]:
            if s > end:
                mid = (s + end) / 2
                owner = [(hs, n) for n, hs, he in self.host if hs <= mid <= he]
                label = max(owner)[1] if owner else "host"
                gaps[label] = gaps.get(label, 0.0) + (s - end) / 1e6
            end = max(end, e)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in order(ops)],
                "idle_gaps": [[n, v] for n, v in order(gaps)]}


def profiler(dev):
    """A ``torch.profiler.profile`` of the host, and of the card where
    ``dev`` is one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def from_profiler(prof, window_s: float) -> Trace:
    """The device operations and labelled host ranges of a finished
    ``profiler``."""
    import torch
    dev, host = [], []
    for ev in prof.events():
        r = ev.time_range
        if ev.name.startswith("bench:"):
            # a labelled range is also mirrored on the device's timeline
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                host.append((ev.name[len("bench:"):], float(r.start),
                             float(r.end)))
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((ev.name, float(r.start), float(r.end)))
    return Trace(device=dev, host=host, window_s=window_s)
