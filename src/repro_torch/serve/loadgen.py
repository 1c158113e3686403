"""Open-loop load generation for the serving plane.

A *closed-loop* driver (submit, wait, submit) can never observe queueing
collapse: the offered load adapts to the engine.  Production traffic does
not — arrivals keep coming whether or not the server kept up, which is
what makes tail latency (p99) the honest SLO.  This module generates
open-loop arrival *traces* in virtual microseconds and replays them
against a ``ServeEngine``/``ServeFleet`` on the simulator's clock:

  * ``poisson_trace`` — memoryless arrivals at a target rate
    (exponential inter-arrival gaps), the standard serving-bench model;
  * ``bursty_trace`` — an on/off modulated Poisson process: ``duty`` of
    the time the instantaneous rate is ``burst_factor`` times the
    off-phase rate, mean rate preserved.  Bursts are where open-loop and
    closed-loop measurements diverge most.

Everything is seeded and replayed on virtual clocks, so a trace is
byte-reproducible across runs and cluster sizes — which is what lets
``BENCH_protocol.json`` pin the resulting p50/p99/goodput trajectory and
``check_regression.py`` gate it.

``OpenLoopDriver`` owns the replay loop: submit every arrival whose
timestamp has passed, step the engine, and — when the engine goes idle
with arrivals still pending — advance the virtual clock to the next
arrival (an open-loop server really does sit idle between bursts).
Request latency is ``t_done - t_arrive`` and therefore *includes queue
wait*, the component closed-loop numbers hide.
"""

from __future__ import annotations

import random
from dataclasses import dataclass


def poisson_trace(rate_per_s: float, n: int, seed: int = 0,
                  t0_us: float = 0.0) -> list[float]:
    """``n`` arrival times (virtual us) of a Poisson process at
    ``rate_per_s`` requests per virtual second."""
    rng = random.Random(seed)
    t, out = t0_us, []
    gap_mean_us = 1e6 / rate_per_s
    for _ in range(n):
        t += rng.expovariate(1.0) * gap_mean_us
        out.append(t)
    return out


def bursty_trace(rate_per_s: float, n: int, seed: int = 0,
                 burst_factor: float = 4.0, duty: float = 0.25,
                 period_us: float = 200_000.0,
                 t0_us: float = 0.0) -> list[float]:
    """On/off modulated Poisson arrivals with the same *mean* rate as
    ``poisson_trace(rate_per_s)``.

    Each ``period_us`` window spends ``duty`` of its length in the *on*
    phase at ``burst_factor`` times the off-phase rate.  Solving
    ``duty*hi + (1-duty)*lo == rate`` with ``hi = burst_factor*lo`` gives
    the two phase rates; arrivals are thinned-Poisson within each phase.
    """
    lo = rate_per_s / (duty * burst_factor + (1.0 - duty))
    hi = burst_factor * lo
    rng = random.Random(seed)
    t, out = t0_us, []
    on_us = duty * period_us
    while len(out) < n:
        phase_off = (t - t0_us) % period_us
        rate = hi if phase_off < on_us else lo
        t += rng.expovariate(1.0) * (1e6 / rate)
        out.append(t)
    return out[:n]


def synth_prompts(n: int, seed: int = 0, vocab: int = 256,
                  shared_prefix: int = 8, unique_len: int = 4,
                  n_personas: int = 4) -> list[list[int]]:
    """Deterministic prompts with real prefix structure: each request
    picks one of ``n_personas`` shared system prefixes (the page-aligned
    part the KV cache deduplicates) and appends a unique user suffix."""
    rng = random.Random(seed)
    personas = [[rng.randrange(vocab) for _ in range(shared_prefix)]
                for _ in range(n_personas)]
    return [personas[rng.randrange(n_personas)]
            + [rng.randrange(vocab) for _ in range(unique_len)]
            for _ in range(n)]


@dataclass
class LoadResult:
    completed: int
    p50_us: float
    p99_us: float
    mean_us: float
    makespan_us: float
    goodput_tok_s: float       # SLO-met generated tokens per virtual second
    slo_met: int
    steps: int


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile — no interpolation, so the gated value
    is an actual observed latency."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals) + 0.5) - 1))
    return sorted_vals[k]


class OpenLoopDriver:
    """Replay an arrival trace against an engine on virtual time.

    ``weight_push_every`` emulates the trainer publishing a new weight
    epoch every N engine steps (``weights.write`` — a color bump), so the
    replicas' colored caches actually miss and refresh mid-load instead
    of hitting forever on epoch 0.
    """

    def __init__(self, engine, trace: list[float],
                 prompts: list[list[int]], max_new: int = 8,
                 weight_push_every: int = 0):
        assert len(trace) == len(prompts)
        self.engine = engine
        self.trace = trace
        self.prompts = prompts
        self.max_new = max_new
        self.weight_push_every = weight_push_every
        self.steps = 0

    def _submit_due(self, idx: int) -> int:
        now = self.engine.now_us()
        while idx < len(self.trace) and self.trace[idx] <= now:
            self.engine.submit(self.prompts[idx], self.max_new,
                               t_arrive=self.trace[idx])
            idx += 1
        return idx

    def run(self, max_steps: int = 100_000) -> list:
        idx = 0
        eng = self.engine
        for _ in range(max_steps):
            idx = self._submit_due(idx)
            if not eng.queue and not eng.active:
                if idx >= len(self.trace):
                    break                          # trace drained, all done
                eng.advance_to(self.trace[idx])    # idle until next arrival
                continue
            eng.step()
            self.steps += 1
            if (self.weight_push_every and eng.weights is not None
                    and self.steps % self.weight_push_every == 0):
                # Trainer publishes an epoch: color bump, replicas refetch.
                eng.weights.write(eng.weights.read())
        return eng.finished

    def result(self, slo_us: float) -> LoadResult:
        done = self.engine.finished
        lats = sorted(r.latency_us for r in done)
        t_end = max((r.t_done for r in done), default=0.0)
        t_start = min((r.t_arrive for r in done), default=0.0)
        span = max(1e-9, t_end - t_start)
        met = [r for r in done if r.latency_us <= slo_us]
        good_toks = sum(len(r.generated) for r in met)
        return LoadResult(
            completed=len(done),
            p50_us=round(_percentile(lats, 0.50), 3),
            p99_us=round(_percentile(lats, 0.99), 3),
            mean_us=round(sum(lats) / len(lats), 3) if lats else 0.0,
            makespan_us=round(span, 3),
            goodput_tok_s=round(good_toks / (span / 1e6), 3),
            slo_met=len(met),
            steps=self.steps)
