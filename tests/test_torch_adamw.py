"""AdamW's kernels on the CPU: the walk of ``csrc/adamw.cu`` over a leaf
(the kernels' vector, tail and grid indexing, mirrored here) covers each
element once at the leaf sizes of
rwkv6-3b and qwen3-0.6b; the wrapper refuses what the kernels do not take;
the CPU path launches nothing, and its plain passes are the optimizer's
float32 chain as it stood before the kernels, to the bit.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``, ``-m
cuda``)."""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.torchstate import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import adamw, cost, ops                # noqa: E402
from repro_torch.train import (OptConfig, apply_updates,        # noqa: E402
                               init_opt_state)
from repro_torch.train.optimizer import _zip, schedule          # noqa: E402

CSRC = Path(adamw.__file__).resolve().parent / "csrc" / "adamw.cu"
H100_SMS = 132
# The elements of each distinct leaf of rwkv6-3b (32 layers, d 2560, ff
# 8960, vocab 65,536) and of qwen3-0.6b (28 layers, d 1024, vocab 151,936)
RWKV6_LEAVES = [167772160, 2560, 81920, 409600, 209715200, 2621440, 163840,
                734003200]
QWEN3_LEAVES = [155582464, 1024, 28672, 58720256, 29360128, 3584, 88080384]


def _split(n, vec):
    """(vectors, tail): the kernels walk a leaf of ``n`` elements as ``n //
    vec`` vectors of ``vec`` elements, then the last ``n % vec`` one at a
    time."""
    return n // vec, n % vec


def _grid(n, vec, resident, cap=1 << 30):
    """``csrc/adamw.cu::grid_of``: the resident blocks, no more than the
    vectors (or the tail's elements) need at 256 a block, at most cap."""
    need = -(-max(n // vec, n % vec) // adamw.THREADS)
    return max(1, min(resident, need, cap))


def _takes(n, vec, blocks):
    """The kernels' walk, thread by thread, as closed forms: thread t of
    the T = 256 blocks threads takes vectors t, t + T, ... below n // vec,
    then the tail's elements n // vec * vec + t, + T, ...  Returns (the
    vectors each thread takes, the tail elements each takes)."""
    nv, tail = _split(n, vec)
    T = blocks * adamw.THREADS
    t = np.arange(T, dtype=np.int64)
    return (np.maximum(0, -(-(nv - t) // T)),
            np.maximum(0, -(-(tail - t) // T)))


@pytest.mark.parametrize("n", RWKV6_LEAVES + QWEN3_LEAVES,
                         ids=[str(n) for n in RWKV6_LEAVES + QWEN3_LEAVES])
@pytest.mark.parametrize("vec", [8, 1])
def test_the_walk_covers_each_element_once_at_the_model_leaves(n, vec):
    """Thread t's vectors are t + k T for k below its count: distinct
    residues mod T, so no two threads share a vector, and all lie below n
    // vec; counts adding up to n // vec then mean every vector once.  The
    vectors' elements [vec i, vec i + vec) and the tail's [n // vec vec, n)
    cut the leaf.  So for the grids an H100 would pick (1 to 8 blocks an
    SM) and for a one-block grid."""
    nv, tail = _split(n, vec)
    assert nv * vec + tail == n and 0 <= tail < vec
    for resident in (H100_SMS, 4 * H100_SMS, 8 * H100_SMS, 1):
        blocks = _grid(n, vec, resident)
        vecs, tails = _takes(n, vec, blocks)
        assert vecs.sum() == nv and tails.sum() == tail
        assert vecs.max() - vecs.min() <= 1            # an even spread


@pytest.mark.parametrize("n,vec,resident", [
    (1, 8, 1056), (7, 8, 1056), (8, 8, 1056), (9, 8, 3), (2047, 8, 1),
    (2048 * 8 + 5, 8, 2), (100_003, 8, 1056), (100_003, 1, 7),
    (2560, 1, 1056), (81920, 8, 132)])
def test_the_walk_enumerated(n, vec, resident):
    """The same walk element by element at small sizes: every element is
    taken once, by the vector loop or the tail loop."""
    blocks = _grid(n, vec, resident)
    T = blocks * adamw.THREADS
    nv, _ = _split(n, vec)
    hits = np.zeros(n, np.int64)
    for t in range(min(T, max(nv, n - nv * vec))):
        for i in range(t, nv, T):
            hits[i * vec:(i + 1) * vec] += 1
        hits[nv * vec + t::T][:max(0, -(-(n - nv * vec - t) // T))] += 1
    assert (hits == 1).all()


def test_offsets_past_2_31_bytes_take_64_bits():
    """rwkv6-3b's stacked channel-mix leaf (32, 2560, 8960): its float32
    moments hold 2.9 GB, so a 32-bit byte offset of the last element
    wraps.  The kernels take n and walk every index as ``long long``; the
    products i * VEC and the pointer arithmetic follow."""
    n = 32 * 2560 * 8960
    assert 4 * (n - 1) >= 2 ** 31 and n < 2 ** 31
    src = CSRC.read_text()
    walks = re.findall(r"for \((\w+(?: \w+)?) i = ([^;]+);", src)
    elem = [ty for ty, start in walks if start.endswith("t")]  # the walks
    assert len(elem) == 4 and all(ty == "long long" for ty in elem)
    assert "long long n" in src and not re.search(r"\bint n\b", src)
    assert "const long long at = i * VEC;" in src


def _leaf(shape=(3, 16, 8), dtype=torch.bfloat16, mdt=torch.float32):
    p = torch.zeros(shape, dtype=dtype)
    return p, p.clone(), torch.zeros(shape, dtype=mdt), \
        torch.zeros(shape, dtype=mdt)


@pytest.mark.parametrize("case", ["shape", "dtype", "moments", "stride",
                                  "empty", "device"])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(case):
    p, g, mu, nu = _leaf()
    if case == "shape":
        g = torch.zeros((3, 16, 9), dtype=torch.bfloat16)
    elif case == "dtype":
        p, g = p.half(), g.half()
    elif case == "moments":
        nu = nu.bfloat16()
    elif case == "stride":
        p = torch.zeros((3, 8, 16), dtype=torch.bfloat16).transpose(1, 2)
    elif case == "empty":
        p, g, mu, nu = _leaf((0, 8))
    with pytest.raises(ValueError):
        adamw.check(p, g, mu, nu)           # "device": all on the CPU


def test_the_wrapper_refuses_host_scalars():
    p = torch.zeros(4)
    with pytest.raises(ValueError):
        adamw._check_scalars(p, torch.tensor(1.0, dtype=torch.float64))
    with pytest.raises(ValueError):
        adamw._check_scalars(p, torch.ones(2))


def test_the_bound_counts_22_bytes_a_parameter_and_2_for_the_norm():
    bf, f32 = torch.bfloat16, torch.float32
    assert cost.adamw(10, bf, bf, f32, norm=False).bytes == 220
    assert cost.adamw(10, bf, bf, f32).bytes == 240
    assert cost.adamw(10, f32, f32, bf).bytes == 4 * 10 * 4 + 8 * 10
    assert cost.adamw(10, bf, bf, f32).flops == 190


def _tree(gen, dtype):
    """A stacked matrix, a stacked vector and an unrolled tail in
    ``dtype`` but for one float32 leaf (rwkv6's ``w0`` and ``u``)."""
    return {"w": (torch.randn((3, 16, 8), generator=gen) * 0.1).to(dtype),
            "layers": {"norm": torch.randn((3, 16), generator=gen)
                       .to(dtype),
                       "u": torch.randn((3, 5, 7), generator=gen)},
            "tail": [{"b": torch.randn(9, generator=gen).to(dtype)}]}


def test_cpu_update_takes_the_plain_path_and_launches_nothing():
    cfg = OptConfig(lr=1e-2, warmup=1)
    gen = torch.Generator().manual_seed(0)
    params, grads = _tree(gen, torch.bfloat16), _tree(gen, torch.bfloat16)
    before = tree_map(torch.clone, params)
    ops.reset_launch_counts()
    _, state, metrics = apply_updates(cfg, params, grads,
                                      init_opt_state(cfg, params))
    assert ops.launch_counts()["adamw"] == 0
    want = math.sqrt(sum(float(v.double().square().sum())
                         for v in tree_leaves(grads)))
    assert float(metrics["grad_norm"]) == pytest.approx(want, rel=1e-6)
    assert all(not torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(before)))
    # step 1: mu holds (1 - b1) times the clipped gradient
    scale = min(1.0, cfg.clip_norm / want)
    for m, g in zip(tree_leaves(state["mu"]), tree_leaves(grads)):
        np.testing.assert_allclose(m.numpy(), (1 - cfg.b1) * scale
                                   * g.double().numpy(), rtol=1e-5)


# The optimizer's AdamW as it stood before the kernels, kept here as the
# yardstick of the plain path: global_norm's float32 copies, then each
# leaf's float32 chain on g.float() * scale
def _old_adamw(cfg, p, g, m, v, lr, bc1, bc2):
    m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v2 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
    step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
    step = step + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * step)
    m.copy_(m2)
    v.copy_(v2)


def _old_apply_updates(cfg, params, grads, state):
    gnorm = torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                           for leaf in tree_leaves(grads)))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    state["count"] += 1
    count = state["count"].to(torch.float32)
    lr = schedule(cfg, count)
    bc1 = 1 - cfg.b1 ** count
    bc2 = 1 - cfg.b2 ** count
    for p, g, m, v in _zip(params, grads, state["mu"], state["nu"]):
        _old_adamw(cfg, p, g.float() * scale, m, v, lr, bc1, bc2)
    return {"grad_norm": gnorm, "lr": lr}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_the_plain_path_is_the_old_chain_to_the_bit(dtype, moment_dtype):
    """Three steps (the second above the clipping norm) through
    ``apply_updates`` on the CPU and through the chain it ran before:
    parameters, moments, count, norm and learning rate equal."""
    cfg = OptConfig(lr=1e-2, warmup=2, decay_steps=5,
                    moment_dtype=moment_dtype)
    gen = torch.Generator().manual_seed(1)
    params = _tree(gen, getattr(torch, dtype))
    old = tree_map(torch.clone, params)
    state, ostate = init_opt_state(cfg, params), init_opt_state(cfg, old)
    for gscale in (0.1, 30.0, 0.5):
        grads = tree_map(lambda t: t * gscale, _tree(gen,
                                                     getattr(torch, dtype)))
        _, _, m = apply_updates(cfg, params, grads, state)
        om = _old_apply_updates(cfg, old, grads, ostate)
        for key in ("grad_norm", "lr"):
            assert torch.equal(m[key], om[key])
        for a, b in zip(tree_leaves((params, state)),
                        tree_leaves((old, ostate))):
            assert a.dtype == b.dtype and torch.equal(a, b)
