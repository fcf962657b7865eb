"""The device trace of a traced run, reduced in memory.

:class:`Capture` runs ``torch.profiler`` with device activity only (the
kernels, copies and fills the card ran, from CUPTI) over whole queries or
batches of the window, and keeps of each activity its name, start and end.
A few hundred thousand launches reduce here in seconds; no trace file is
written.  The readers under ``bench/metrics/`` take their numbers from the
:class:`DeviceTrace` this leaves in the run's record.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, data sheet


@dataclasses.dataclass
class DeviceTrace:
    """Device activities of the traced window: (name, start_ns, end_ns) on
    the device's clock, and the window's length on the host's clock (both
    ends after a device synchronize)."""

    events: List[Tuple[str, int, int]]
    window_s: float

    def busy_s(self) -> float:
        """Seconds in which some activity ran: the union of the intervals."""
        busy, end = 0, None
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def idle_share(self) -> float:
        """% of the window in which no activity ran."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def by_kernel(self, names: Sequence[str]) -> Dict[str, Tuple[int, float]]:
        """(launches, device seconds) of each kernel in ``names``, matched as
        a whole identifier (``minplus_resident_kernel`` does not match
        ``minplus_resident_lanes_kernel``); kernels not seen are left out."""
        pats = {k: re.compile(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])") for k in names}
        out: Dict[str, Tuple[int, float]] = {}
        for name, s, e in self.events:
            for k, pat in pats.items():
                if pat.search(name):
                    n, t = out.get(k, (0, 0.0))
                    out[k] = (n + 1, t + (e - s) / 1e9)
        return out

    def top_ops(self, k: int = 10) -> List[list]:
        """The ``k`` activities (by name) that took most device time."""
        tot: Dict[str, float] = {}
        for name, s, e in self.events:
            key = name[:120]
            tot[key] = tot.get(key, 0.0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle device time between activities, summed by what ran last
        before the gap (``after <name>``): where the host held the card."""
        tot: Dict[str, float] = {}
        end, last = None, None
        for name, s, e in sorted(self.events, key=lambda x: x[1]):
            if end is not None and s > end:
                key = f"after {last[:100]}"
                tot[key] = tot.get(key, 0.0) + (s - end) / 1e9
            if end is None or e > end:
                end, last = e, name
        return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


class Capture:
    """Profiles the card from :meth:`start` to :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self.trace: Optional[DeviceTrace] = None
        self.stop_s = 0.0  # what stopping and reading the profiler took

    @staticmethod
    def warm():
        """One empty profile, so the profiler's own start-up (CUPTI) is paid
        in set-up and not inside the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._prof is not None

    def stop(self):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        events = [(e.name(), e.start_ns(), e.end_ns())
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        self._prof = None
        self.trace = DeviceTrace(events=events, window_s=window)
        self.stop_s = time.perf_counter() - self._t0 - window
