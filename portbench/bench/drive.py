"""What every traffic driver shares: the measured window, its profiled
stretch in a traced run, and the stretch the host-clock readings cover.

A traffic mix (``traffic/<mix>.json``) names its driver by ``kind``; the
driver is ``drivers/<kind>.py`` (``spec.driver``), so a new kind of
traffic is a new file there and a mix of a known kind is data alone.

A traced run profiles ``[PROFILE_AT, PROFILE_AT + profile_s]`` of the
window. Stopping the profiler holds the event loop for seconds, so the
host-clock readings of a traced run (latencies, spans, timers, coalescer
counts, the work the whole-step share counts) cover only the requests sent
from ``SETTLE_S`` after the stop returned to the window's end
(``host_from``); an untraced run's cover the whole window."""

from __future__ import annotations

import asyncio
import gc
import time

import torch

from . import probe

PROFILE_AT = 1.0  # seconds into the window that the traced stretch starts
SETTLE_S = 1.0  # after the profiler's stop, before the host readings start


class Window:
    """Start and end of the window, its profiled stretch, and where the
    host readings start (``host_from``)."""

    def __init__(self, seconds: float, profile_s: float):
        self.seconds, self.profile_s = seconds, min(profile_s, seconds)
        self.start = self.end = self.host_from = 0.0
        self.prof = None
        self.on_host_from = None  # called when the host readings start

    @property
    def host_s(self) -> float:
        return max(self.end - self.host_from, 0.0)

    def open(self, rec: probe.Record) -> list:
        """Starts the window now; returns the tasks that close it (and
        profile it in a traced run), to await after the traffic."""
        # set-up's objects (the KB's million chunk records) out of the
        # collector's way, so that no full collection falls in the window
        gc.collect()
        gc.freeze()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        self.start = time.perf_counter()
        self.end = self.start + self.seconds
        self.host_from = self.start
        rec.in_window = True
        tasks = [asyncio.ensure_future(self._close(rec))]
        if rec.traced:
            tasks.append(asyncio.ensure_future(self._profile(rec)))
        return tasks

    async def _close(self, rec: probe.Record) -> None:
        await asyncio.sleep(max(self.end - time.perf_counter(), 0.0))
        rec.in_window = False

    async def _profile(self, rec: probe.Record) -> None:
        from torch.profiler import ProfilerActivity, profile

        await asyncio.sleep(max(self.start + PROFILE_AT - time.perf_counter(), 0.0))
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        with torch.profiler.record_function("portbench/begin"):
            rec.in_profile = True
        await asyncio.sleep(self.profile_s)
        with torch.profiler.record_function("portbench/end"):
            rec.in_profile = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.host_from = min(time.perf_counter() + SETTLE_S, self.end)
        await asyncio.sleep(max(self.host_from - time.perf_counter(), 0.0))
        if self.on_host_from is not None:
            self.on_host_from()
