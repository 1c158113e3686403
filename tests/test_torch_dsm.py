"""The carried-over DSM simulator and serving control plane, held to the JAX
package exactly: stub-step digests, engine stats and ``NetStats`` at 1, 2,
4 and 8 servers, and the four gated rows of ``BENCH_protocol.json["serve"]``
reproduced by a port-side run of ``benchmarks/protocol_micro.py::_serve_run``.
Everything runs on virtual clocks, so equality is exact."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore                                   # noqa: E402
import repro.serve as jserve                                 # noqa: E402
from repro.core.jaxstate import OwnedState as JOwnedState    # noqa: E402

import repro_torch.core as tcore                             # noqa: E402
import repro_torch.serve as tserve                           # noqa: E402
from repro_torch.core.torchstate import OwnedState           # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# benchmarks/protocol_micro.py: SERVE_SLO_US, SERVE_DECODE_CYCLES, SERVE_POINTS
SERVE_SLO_US = 5000.0
SERVE_DECODE_CYCLES = 390_000.0
SERVE_POINTS = (("poisson_1srv", 1, "poisson"),
                ("poisson_4srv", 4, "poisson"),
                ("poisson_8srv", 8, "poisson"),
                ("bursty_4srv", 4, "bursty"))


def stub_step(params, cache, tokens):
    return (tokens * 7 + 3) % 256, cache


def _drain(eng, prompts, max_new=6):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    for _ in range(5000):
        if not eng.queue and not eng.active:
            break
        eng.step()
    return eng


def _net(cluster):
    return dataclasses.asdict(cluster.sim.net)


@pytest.mark.parametrize("n", [None, 1, 2, 4, 8])
def test_stub_engine_matches_jax(n):
    prompts = jserve.synth_prompts(24, seed=5)
    assert prompts == tserve.synth_prompts(24, seed=5)
    runs = []
    for core, serve in ((jcore, jserve), (tcore, tserve)):
        cl = core.Cluster(n) if n else None
        eng = _drain(serve.ServeEngine(step_fn=stub_step, cluster=cl,
                                       page_size=4, slots=4, max_len=64),
                     prompts)
        runs.append((eng.digest(), eng.stats(),
                     _net(cl) if cl else None, eng.now_us()))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_stub_fleet_matches_jax(n):
    prompts = jserve.synth_prompts(24, seed=5)
    local = _drain(tserve.ServeEngine(step_fn=stub_step, page_size=4,
                                      slots=4, max_len=64), prompts)
    runs = []
    for core, serve in ((jcore, jserve), (tcore, tserve)):
        cl = core.Cluster(n)
        fleet = _drain(serve.ServeFleet(cl, step_fn=stub_step, page_size=4,
                                        slots=4, max_len=64), prompts)
        runs.append((fleet.digest(), fleet.stats(), _net(cl),
                     cl.makespan_us()))
    assert runs[0] == runs[1]
    assert runs[1][0] == local.digest()       # protocol moves costs only


def _serve_run(core, serve, owned_state, n_servers, trace):
    """``protocol_micro._serve_run`` with its defaults, on either package."""
    cl = core.Cluster(n_servers, backend="drust", ooo=True, qps_per_thread=2)
    weights = owned_state("bench_w", {"w": np.ones((128, 128), np.float32)})

    def step(params, cache, tokens):
        return (tokens * 13 + 7) % 997, cache

    fleet = serve.ServeFleet(cl, step_fn=step, page_size=8, slots=4,
                             max_len=64, weights=weights, wire="int8",
                             weights_server=0,
                             decode_cycles=SERVE_DECODE_CYCLES)
    prompts = serve.synth_prompts(72, seed=11)
    mk = serve.poisson_trace if trace == "poisson" else serve.bursty_trace
    drv = serve.OpenLoopDriver(fleet, mk(2500.0, 72, seed=12), prompts,
                               max_new=8, weight_push_every=8)
    drv.run()
    r = drv.result(SERVE_SLO_US)
    st = fleet.stats()
    row = {"p50_us": r.p50_us, "p99_us": r.p99_us,
           "goodput_tok_s": r.goodput_tok_s, "completed": r.completed,
           "slo_met": r.slo_met, "steps": st["steps"],
           "round_trips": cl.sim.net.round_trips,
           "kv_hits": st["kv"]["hits"], "kv_misses": st["kv"]["misses"],
           "wire_bytes": st["wire_bytes"],
           "weight_refreshes": st["weight_refreshes"]}
    return row, fleet.digest(), _net(cl)


@pytest.mark.parametrize("name,n,trace", SERVE_POINTS)
def test_serve_bench_rows_reproduced_exactly(name, n, trace):
    baseline = json.loads((ROOT / "BENCH_protocol.json").read_text())
    mine, digest, net = _serve_run(tcore, tserve, OwnedState, n, trace)
    assert mine == baseline["serve"][name]
    ref, jdigest, jnet = _serve_run(jcore, jserve, JOwnedState, n, trace)
    assert (mine, digest, net) == (ref, jdigest, jnet)


def test_poisson_8srv_pinned_numbers():
    row, _, _ = _serve_run(tcore, tserve, OwnedState, 8, "poisson")
    assert row["p99_us"] == 1212.516
    assert row["wire_bytes"] == 1179936


def test_owned_state_borrow_rules():
    st = OwnedState("w", {"w": np.zeros(4, np.float32)})
    ref = st.borrow()
    with pytest.raises(tcore.BorrowError):
        st.borrow_mut()
    ref.drop()
    c0 = st.color
    st.write({"w": np.ones(4, np.float32)})
    assert st.color == c0 + 1
    with st.borrow() as tree:
        assert tree["w"].sum() == 4
    with pytest.raises(tcore.BorrowError):
        ref.deref()                            # use after drop


def test_state_cache_zero_comm_on_color_hit_and_replica_clones():
    import torch

    st = OwnedState("w", {"w": torch.ones((8, 8))})
    calls = []
    cache = tcore.StateCache(transfer=lambda t: calls.append(1) or t)
    cache.fetch(st)
    cache.fetch(st)
    assert (cache.refreshes, cache.hits, len(calls)) == (1, 1, 1)
    assert cache.bytes_transferred == 8 * 8 * 4
    slot = tcore.ReplicaSlot(st)
    st.write({"w": torch.full((8, 8), 2.0)})
    cache.fetch(st)
    assert cache.refreshes == 2
    backup = slot.backup[1]["w"]
    assert backup.data_ptr() != st.read()["w"].data_ptr()   # a real copy
    st.read()["w"].add_(1.0)                   # in-place step after epoch
    assert float(backup[0, 0]) == 2.0
    assert slot.promote()["w"] is backup


def test_sanitizer_runs_on_the_port(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    cl = tcore.Cluster(2)
    assert cl.sanitizer is not None
    eng = _drain(tserve.ServeEngine(step_fn=stub_step, cluster=cl,
                                    page_size=4, slots=2, max_len=32),
                 tserve.synth_prompts(6, seed=1), max_new=3)
    assert len(eng.finished) == 6
