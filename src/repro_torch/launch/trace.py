"""A traced window of a driver's loop (``--profile N`` of ``launch/serve.py``
and ``launch/train.py``)."""

from __future__ import annotations

import json
import time


def _busy_ms(intervals) -> float:
    """ms in which at least one of [(start_ns, end_ns)] ran: overlapping
    kernels count once."""
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


def profiled(step, n: int, dev, more=lambda: True, unit="ticks") -> int:
    """Run ``step()`` up to ``n`` times, while ``more()``, under
    ``torch.profiler``; print the operators by device time, the table of
    the program's spans (``repro_torch.telemetry``: calls, host ms, device
    ms, self device ms), its counters with the MoE's drop share, and one
    JSON line with the count (``"profile_<unit>"``), the window's wall
    time, the device's busy time (the union of its operations' intervals)
    and idle share.  Returns the steps run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry

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
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = _busy_ms((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA)
    print(events.table(sort_by="self_device_time_total"
                       if hasattr(events[0], "self_device_time_total")
                       else "self_cuda_time_total", row_limit=15))
    trees = telemetry.steps(done, name=None)
    print(f"{'span':<24} {'calls':>6} {'host ms':>10} {'device ms':>10} "
          f"{'self dev ms':>11}")
    for name, calls, host, device, own in telemetry.table(trees):
        print(f"{name:<24} {calls:>6} {host:>10.3f} "
              + " ".join(f"{v:>10.3f}" if v is not None else f"{'-':>10}"
                         for v in (device, own)))
    counts: dict = {}
    for t in trees:
        for k, v in t.get("counts", {}).items():
            counts[k] = counts.get(k, 0) + v
    routed = counts.get("moe/routed_pairs")
    aten_events = sum(e.count for e in events if e.key.startswith("aten::"))
    print(json.dumps({f"profile_{unit}": done, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "device_idle_share": 1 - busy_ms / wall_ms,
                      "kernel_launches": sum(e.count for e in kernels),
                      "aten_events": aten_events,
                      "counters": counts,
                      "moe_drop_share": 100 * (
                          1 - counts["moe/kept_pairs"] / routed)
                      if routed else None,
                      "top_kernels": [
                          {"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
                           "count": e.count}
                          for e in sorted(kernels, key=dev_us,
                                          reverse=True)[:8]]}))
    return done
