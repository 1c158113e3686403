"""The share of the traced window in which no operation ran on the card:
one minus the union of the device operations' intervals (overlapping
operations count once) over the window's wall time."""

from perfbench import trace


def read(window):
    if not window.device_ops or window.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(window.device_ops) / window.window_s)
