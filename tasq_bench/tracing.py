"""What a traced run records beside the program: a device profile of a
few seconds of the window, and wrappers around the program's functions.

``DeviceProfile`` runs ``torch.profiler`` (host and card) for ``seconds``
(a closed-loop window's first, an open-loop window's last) and reads
from its trace the device's busy time (the union of kernel, copy and set
intervals), each kernel's time by name, the operations that took most
device time and the longest idle gaps, named by the host call under way
in each (or the launch that ended it).

``patch`` replaces a function of the program, wherever a module of the
port holds it, by a wrapper, and ``undo`` puts the originals back: the
benchmark observes the program's calls without editing it.
"""
from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events the profiler makes for itself, which name no work of the run
PROFILER_OWN = ("PyTorch Profiler", "Activity Buffer")
TOP = 10


class DeviceProfile:
    """``torch.profiler`` over the host and the card. ``stall_s`` is the
    host time its ``stop`` took (the profiler processes its events
    there), which a caller that stops it inside a window leaves out of
    that window."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.prof = None
        self.active = False
        self.t0 = 0.0
        self.window_s = 0.0
        self.stall_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        self.active = True

    def poll(self) -> None:
        """Stop once the profiled seconds have passed (call it often)."""
        if self.active and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        import torch
        if not self.active:
            return
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.window_s = t - self.t0
        self.active = False
        self.prof.stop()
        self.stall_s = time.perf_counter() - t

    def summary(self) -> Dict:
        """busy_s, window_s, kernel seconds by name, device op count and
        the breakdown (top device ops; longest idle gaps by host op)."""
        self.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        dev = [e for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in dev)
        busy_us, end, gaps = 0.0, float("-inf"), []
        for lo, hi in spans:
            if end != float("-inf") and lo > end:
                gaps.append((lo - end, end, lo))
            if hi > end:
                busy_us += hi - max(lo, end)
                end = hi
        by_name: Dict[str, float] = {}
        for e in dev:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("ph") == "X" and e.get("cat") not in
                      DEVICE_CATS and "ts" in e and "dur" in e
                      and not e["name"].startswith(PROFILER_OWN))
        starts = [h[0] for h in host]
        gaps.sort(reverse=True)
        idle = []
        for dur, lo, hi in gaps[:TOP]:
            # the host call under way at the gap's middle, else the one
            # that ended it (the launch of the next device operation)
            mid = 0.5 * (lo + hi)
            under = [h for h in host if h[0] <= mid <= h[1]]
            if under:
                name = min(under, key=lambda h: h[1] - h[0])[2]
            else:
                j = bisect.bisect_left(starts, mid)
                name = ("host, then " + host[j][2] if j < len(host)
                        else "host")
            idle.append([name[:120], dur / 1e6])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"busy_s": busy_us / 1e6, "window_s": self.window_s,
                "kernel_s": {k: v / 1e6 for k, v in by_name.items()},
                "device_ops": len(dev),
                "breakdown": {"device_ops": [[n[:120], us / 1e6]
                                             for n, us in top],
                              "idle_gaps": idle}}


def kernel_seconds(kernel_s: Dict[str, float], fragment: str) -> float:
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(v for k, v in kernel_s.items() if fragment in k)


def patch(original: Callable, wrapper: Callable,
          prefix: str = "repro_torch") -> List[Tuple[object, str, Callable]]:
    """Put ``wrapper`` in place of ``original`` in every loaded module of
    the port that holds it; returns what ``undo`` needs."""
    done = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == prefix or name.startswith(prefix + ".")):
            continue
        for attr, value in list(vars(mod).items()):
            if value is original:
                setattr(mod, attr, wrapper)
                done.append((mod, attr, original))
    return done


def undo(patched: List[Tuple[object, str, Callable]]) -> None:
    for mod, attr, original in patched:
        setattr(mod, attr, original)


class Sampler:
    """A seeded, thread-safe choice of which calls to keep for the check:
    each call is kept with probability ``p``, at most ``cap`` of them."""

    def __init__(self, seed: int, p: float, cap: int):
        import random
        import threading
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.p, self.cap, self.kept = float(p), int(cap), 0

    def take(self) -> bool:
        with self._lock:
            if self.kept >= self.cap or self._rng.random() >= self.p:
                return False
            self.kept += 1
            return True
