"""The arithmetic every ``<kernel>_roofline`` reader shares: the frozen
bound of the calls the program made in the window over the device time
of those calls' CUDA launches, in percent."""

from perfbench import counts, trace


def share(window, calls: str, pattern: str, bound_a_call: float):
    n = window.launches.get(calls, 0)
    ops = trace.matching(window.device_ops, pattern)
    t = trace.device_s(ops)
    if not n or not ops or t <= 0:
        return None
    return 100.0 * n * bound_a_call / t


def shape(window):
    m, tr = window.model, window.traffic
    return tr["batch"], tr["seq_len"], m


def bound(flops_bytes) -> float:
    return counts.bound_s(*flops_bytes)
