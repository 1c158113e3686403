"""Real-model serving parity: the smoke ``qwen3_0_6b`` engine in float32,
with parameters converted from the JAX package, gives the JAX engine's
token digest on the local plane and on ``Cluster(4)`` with the raw wire
(the counterpart of ``tests/test_serve_dsm.py``'s real-model test).  If a
token differs, the failure reports the port's argmax margin at that step."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore                                   # noqa: E402
import repro.serve as jserve                                 # noqa: E402
from repro import configs as jconfigs                        # noqa: E402
from repro.core.jaxstate import OwnedState as JOwnedState    # noqa: E402
from repro.models import init_params as j_init_params        # noqa: E402

import repro_torch.core as tcore                             # noqa: E402
import repro_torch.serve as tserve                           # noqa: E402
from repro_torch import configs                              # noqa: E402
from repro_torch.convert import params_from_jax              # noqa: E402
from repro_torch.core.torchstate import OwnedState           # noqa: E402
from repro_torch.serve import serve_step                     # noqa: E402


def _drain(eng, prompts, max_new=4):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    for _ in range(5000):
        if not eng.queue and not eng.active:
            break
        eng.step()
    return eng


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.smoke("qwen3_0_6b"), dtype="float32")
    cfg = dataclasses.replace(configs.smoke("qwen3_0_6b"), dtype="float32")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab, cfg.attn_chunk + 3))
               for _ in range(3)]
    return jcfg, cfg, jp, p, prompts


@pytest.mark.parametrize("servers", [None, 4])
def test_real_model_digest_matches_jax(setup, servers, monkeypatch):
    jcfg, cfg, jp, p, prompts = setup
    ticks_j, ticks_t = [], []

    jeng = jserve.ServeEngine(jcfg, JOwnedState("w", jp), slots=2,
                              max_len=128, wire="raw",
                              cluster=jcore.Cluster(servers) if servers
                              else None)
    jstep = jeng._step

    def j_recording(params, cache, tokens):
        nxt, cache = jstep(params, cache, tokens)
        ticks_j.append(np.asarray(nxt)[:, 0].tolist())
        return nxt, cache
    jeng._step = j_recording

    real_decode = serve_step.decode_step

    def t_recording(cfg_, params, cache, tokens):
        logits, cache = real_decode(cfg_, params, cache, tokens)
        top2 = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        ticks_t.append({"tokens": logits[:, -1].argmax(-1).tolist(),
                        "margin": (top2[:, 0] - top2[:, 1]).tolist()})
        return logits, cache
    monkeypatch.setattr(serve_step, "decode_step", t_recording)

    teng = tserve.ServeEngine(cfg, OwnedState("w", p), slots=2, max_len=128,
                              wire="raw", device="cpu",
                              cluster=tcore.Cluster(servers) if servers
                              else None)
    want = _drain(jeng, prompts).digest()
    got = _drain(teng, prompts).digest()
    if got != want:
        for step, (a, b) in enumerate(zip(ticks_j, ticks_t)):
            if a != b["tokens"]:
                pytest.fail(f"tick {step}: JAX tokens {a}, port tokens "
                            f"{b['tokens']}; port argmax margins "
                            f"{b['margin']}")
        pytest.fail("digests differ with identical per-tick tokens")
    assert teng.steps == jeng.steps == len(ticks_t)
    assert teng.stats()["kv"] == jeng.stats()["kv"]
    if servers:
        assert teng.wire_bytes == jeng.wire_bytes > 0
        assert (dataclasses.asdict(teng.cluster.sim.net)
                == dataclasses.asdict(jeng.cluster.sim.net))


def test_real_model_int8_wire_refresh(setup):
    """int8 refreshes ship the reference's wire bytes (one scale per
    stacked leaf) and serve every request."""
    jcfg, cfg, jp, p, prompts = setup
    jeng = jserve.ServeEngine(jcfg, JOwnedState("w", jp), slots=2,
                              max_len=128, wire="int8",
                              cluster=jcore.Cluster(2), weights_server=1)
    teng = tserve.ServeEngine(cfg, OwnedState("w", p), slots=2, max_len=128,
                              wire="int8", device="cpu",
                              cluster=tcore.Cluster(2), weights_server=1)
    _drain(jeng, prompts[:2], max_new=2)
    _drain(teng, prompts[:2], max_new=2)
    assert teng.wire_bytes == jeng.wire_bytes
    assert teng.stats()["weight_refreshes"] == 1
    assert all(r.done for r in teng.finished) and len(teng.finished) == 2


def test_engine_cache_is_updated_in_place(setup):
    jcfg, cfg, jp, p, prompts = setup
    eng = tserve.ServeEngine(cfg, OwnedState("w", p), slots=2, max_len=128,
                             device="cpu")
    k = eng.cache["layers"]["k"]
    _drain(eng, prompts[:1], max_new=3)
    assert eng.cache["layers"]["k"] is k       # same buffer, written in place
    assert eng.cache["length"] == 3
    assert float(k[:, :, :3].abs().sum()) > 0


def test_serve_driver_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    st = launch_serve.main(["--device", "cpu", "--requests", "3",
                            "--max-new", "2", "--cluster", "2", "--wire",
                            "int8", "--profile", "1"])
    assert st["completed"] == 3 and st["weight_refreshes"] == 1
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out and '"profile_ticks": 1' in out
