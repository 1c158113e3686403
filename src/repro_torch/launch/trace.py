"""A traced window of a driver's loop (``--profile N`` of ``launch/serve.py``
and ``launch/train.py``)."""

from __future__ import annotations

import json
import time


def profiled(step, n: int, dev, more=lambda: True, unit="ticks") -> int:
    """Run ``step()`` up to ``n`` times, while ``more()``, under
    ``torch.profiler``; print the operators by device time and one JSON
    line with the count (``"profile_<unit>"``), the window's wall time,
    the summed device time and the device's idle share.  Returns the
    steps run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    done = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while done < n and more():
            step()
            done += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device time is counted once, on the kernels themselves: an operator's
    # self device time repeats the time of the kernels it launched
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(events.table(sort_by="self_device_time_total"
                       if hasattr(events[0], "self_device_time_total")
                       else "self_cuda_time_total", row_limit=15))
    aten_events = sum(e.count for e in events if e.key.startswith("aten::"))
    print(json.dumps({f"profile_{unit}": done, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "device_idle_share": 1 - busy_ms / wall_ms,
                      "kernel_launches": sum(e.count for e in kernels),
                      "aten_events": aten_events,
                      "top_kernels": [
                          {"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
                           "count": e.count}
                          for e in sorted(kernels, key=dev_us,
                                          reverse=True)[:8]]}))
    return done
