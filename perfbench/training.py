"""A training cell: the port's ``TrainState.step`` over ``loss_fn`` at the
configuration's widths, driven back to back through the window.

Set-up makes the weights on the device from the seed, builds the train
state, and runs the first ``setup_steps`` steps through the window's own
call on batches of their own (the kernels load and every shape of the
cell warms up); it reads from them what ``correct`` compares, then runs
one more step, so that the allocator settles after that reading's work
before the window opens.  The window then runs fresh batches, made in
set-up and kept on the device, with no host read inside it, and ends at
the first step boundary after ``seconds``, after a synchronise.  Then the
program's state is freed and the reference runs the first steps again on
the same weights and batches.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time

from . import compare, traffic, weights

TRACE_STEPS = 6                 # steps a traced window holds at most


def port_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file: the port's
    entry for ``arch`` with the file's ``model`` values.  Raises on a key
    the port has no field for, and where the port fixes a value the file
    states otherwise."""
    from repro_torch import configs
    from repro_torch.models import rwkv
    from repro_torch.models.config import ModelConfig
    model = config["model"]
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    fixed = {"aux_coef": 0.01, "lora_r": rwkv.LORA_R,
             "decay_scale": rwkv.DECAY_SCALE}
    unknown = sorted(set(model) - fields - set(fixed))
    if unknown:
        raise ValueError(f"the port has no {unknown} (the configuration "
                         f"{config['name']!r} states them)")
    cfg = dataclasses.replace(configs.get(config["arch"]),
                              **{k: v for k, v in model.items()
                                 if k in fields})
    for key, value in fixed.items():
        if key in model and model[key] != value:
            raise ValueError(f"the port fixes {key} = {value}, the "
                             f"configuration states {model[key]}")
    return cfg


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grad_readings(config: dict, params: dict, state: dict) -> tuple:
    """The first step's clipped gradient as the optimizer got it, worked
    out from its state after that step: AdamW's first moment is (1 - b1)
    g; Adafactor's row means (decay 0 at step 1) hold the mean of g^2
    over each row's last dim (the whole g^2 of a leaf it does not
    factor).  Returns ({path: norm}, {path: ``weights.row_means_sq``})."""
    opt = config["optimizer"]
    flat_p = weights.flat_program(params)
    norms, rows = {}, {}
    if opt["name"] == "adamw":
        mu = weights.layer_slices(config, state["mu"])
        for k, ts in mu.items():
            norms[k] = math.sqrt(sum(float(t.double().square().sum())
                                     for t in ts)) / (1 - opt["b1"])
        return norms, weights.row_means_sq(mu, 1 / (1 - opt["b1"]))
    for k, vr in weights.flat_program(state["vr"]).items():
        p = flat_p[k]
        cols = p.shape[-1] if p.dim() >= 2 else 1
        norms[k] = math.sqrt(max(float(vr.double().sum()) * cols
                                 - 1e-30 * p.numel(), 0.0))
        r = vr.reshape(-1) if p.dim() >= 2 else vr.mean(-1, keepdim=True)
        rows[k] = r.double().cpu()
    return norms, rows


def plain(readings: dict) -> dict:
    """The readings without their row vectors, for a log line."""
    return {k: v for k, v in readings.items() if k != "rows"}


def train_state(config: dict, seed: int, device):
    """The port's train state at the seed's weights, made on the
    device."""
    from repro_torch.train import OptConfig, TrainState
    return TrainState(port_config(config), OptConfig(**config["optimizer"]),
                      weights.program_params(config, seed, device))


def program_readings(config: dict, seed: int, batches, device) -> dict:
    """The program's readings of a run's set-up steps over ``batches``
    from a fresh train state, which is freed before this returns."""
    import torch
    ts = train_state(config, seed, device)
    prog, _, _ = first_steps(ts, batches, config, seed, device)
    del ts
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return prog


def first_steps(ts, batches, config: dict, seed: int, device):
    """The set-up steps through the window's own call, and the readings
    ``correct`` compares: each step's loss, the first step's gradient
    norms and row means (from the optimizer's state) and the change of
    the parameters over the steps.  Returns (the readings, the seconds
    of a step after the first, the seconds of the first)."""
    prog = {"loss": []}
    ends = [time.perf_counter()]
    for i, batch in enumerate(batches):
        prog["loss"].append(ts.step(batch)["loss"])
        if i == 0:
            prog["grad"], prog["rows"] = grad_readings(config,
                                                       *ts.state.read())
        _sync(device)
        ends.append(time.perf_counter())
    prog["change"] = weights.change_norms(
        config, seed, weights.layer_slices(config, ts.params()))
    prog["loss"] = [float(x) for x in prog["loss"]]
    return prog, (ends[-1] - ends[1]) / max(len(ends) - 2, 1), \
        ends[1] - ends[0]


def window(ts, pool: list, seconds: float, max_steps: int | None, device,
           log) -> tuple:
    """Steps back to back, a fresh batch each, until the first step
    boundary after ``seconds`` (or ``max_steps``), then a synchronise.
    Returns (start, end, the steps' losses on the device)."""
    from repro_torch.kernels import ops
    losses = []
    ops.reset_launch_counts()
    _sync(device)
    w0 = time.perf_counter()
    while True:
        if len(losses) == len(pool):
            log("the window outran its batches: the pool starts again",
                file=sys.stderr)
        losses.append(ts.step(pool[len(losses) % len(pool)])["loss"])
        if time.perf_counter() - w0 >= seconds or len(losses) == max_steps:
            break
    _sync(device)
    return w0, time.perf_counter(), losses


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        log=print):
    """One run of a training cell; returns the result line's dict."""
    import torch
    from repro_torch.kernels import ops

    log(f"imports done: {time.perf_counter() - t0:.4f} s", file=sys.stderr)
    conf, traf = cell.config, cell.traffic
    model = conf["model"]
    on_card = device.type == "cuda"
    n_setup = traf["setup_steps"]

    ts = train_state(conf, seed, device)
    first = traffic.device_batches(traf, model["vocab"], n_setup, seed,
                                   device)
    prog, step_s, first_s = first_steps(ts, first, conf, seed, device)
    log(f"set-up steps done: {time.perf_counter() - t0:.4f} s (the first "
        f"{first_s:.4f} s)", file=sys.stderr)
    n_pool = (TRACE_STEPS if trace else math.ceil(seconds / max(step_s, 1e-3) * 2)) + 8
    pool = traffic.device_batches(traf, model["vocab"], n_setup + 1 + n_pool,
                                  seed, device)[n_setup:]
    ts.step(pool.pop(0))
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            w0, w1, losses = window(ts, pool, seconds, TRACE_STEPS, device,
                                    log)
    else:
        w0, w1, losses = window(ts, pool, seconds, None, device, log)
    steps = len(losses)
    launches = ops.launch_counts()
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())

    result = {"correct": False, "attempted": steps, "failed": failed}
    if trace:
        from . import trace as tr
        win = tr.from_profiler(prof, window_s=w1 - w0, steps=steps,
                               launches=launches, model=model,
                               traffic=traf, reference=conf["reference"])
        result["metrics"] = tr.read_metrics(win, cell.per_layer)
        result["breakdown"] = {"device_ops": tr.top_ops(win.device_ops),
                               "idle_gaps": tr.idle_gaps(win)}
        extra = {"busy_s": tr.busy_s(win.device_ops), "window_s": w1 - w0}
        del win, prof
    else:
        result["metrics"] = {
            "train_tokens_per_s": {
                "value": steps * traf["batch"] * traf["seq_len"] / (w1 - w0),
                "unit": "tokens/s"},
            "peak_mem_gib": {"value": window_peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        extra = {}
    result["device"] = device_info(device, cell.chips,
                                   max(setup_peak, window_peak), extra)
    log(f"window: {steps} steps in {w1 - w0:.4f} s; set-up {setup_s:.4f} s "
        f"(steps of {step_s:.4f} s); launches {launches}", file=sys.stderr)

    # the program's state goes before the reference runs
    del ts, pool, losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    from .reference import train as reference
    ref = reference.train(conf, seed, first, device)
    log(f"reference: {time.perf_counter() - t_ref:.4f} s; losses "
        f"{ref['loss']} against {prog['loss']}", file=sys.stderr)
    log("readings: " + json.dumps({"program": plain(prog),
                                   "reference": plain(ref)}),
        file=sys.stderr)
    ok, shown = compare.verdict(
        compare.gaps(prog, ref, cell.limits.get("leaves")), cell.limits)
    result["correct"] = ok and failed == 0
    result["compared"] = shown
    return result


def device_info(device, chips: int, peak: int, extra: dict) -> dict:
    """The result's ``device``: the card's name, the cards used and the
    peak of allocated memory (``platform`` "cpu" only in the CPU
    tests)."""
    import torch
    on_card = device.type == "cuda"
    return {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": chips, "memory_peak_bytes": peak, **extra}
