"""What the span readers share: the program's step trees of the traced
window (``repro_torch.telemetry``), and the device ms a step of the
spans of one name.  A program without the telemetry module, or a window
whose trees hold no device time, gives None."""


def window_steps(window):
    """The last ``window.steps`` step trees, or None where there are none
    or none has a device time."""
    if not window.steps:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    trees = telemetry.steps(window.steps)
    if not any(t["device_ms"] is not None for t in trees):
        return None
    return trees


def _nodes(tree):
    yield tree
    for c in tree["children"]:
        yield from _nodes(c)


def phase_ms(window, name: str):
    """Device ms a step of the spans ``repro_torch/<name>``, summed over
    each step's calls (microbatches), averaged over the steps."""
    trees = window_steps(window)
    if trees is None:
        return None
    span = f"repro_torch/{name}"
    return sum(n["device_ms"] or 0.0 for t in trees for n in _nodes(t)
               if n["name"] == span) / len(trees)
