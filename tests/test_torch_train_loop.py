"""The port's training-loop pieces against the JAX package, on the CPU:
``train/data.py:prefetch_to_device``, the step-time histogram of
``telemetry.py`` and its observation by ``make_train_step``, and the
optimizer's in-place update (the counterpart of the JAX step's donation).

Tolerances: none. Order, errors and exposition text are compared
exactly, and the in-place update against the functional one bit for bit
(the same ops per leaf, written into the old leaf).
"""

import numpy as np
import pytest
import torch

from kubetorch_tpu import telemetry as jax_tel
from kubetorch_tpu.train import data as jax_data
from kubetorch_tpu_torch import telemetry as pt_tel
from kubetorch_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                              llama_loss_chunked)
from kubetorch_tpu_torch.train import data as pt_data
from kubetorch_tpu_torch.train import optim as pt_optim
from kubetorch_tpu_torch.train import train_step as pt_ts

pytestmark = pytest.mark.level("unit")


def _batches(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 100, (2, 8)).astype(np.int64),
             "targets": rng.integers(0, 100, (2, 8)).astype(np.int64)}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# prefetch_to_device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 2, 7])
def test_prefetch_keeps_order_and_values(size):
    src = _batches()
    want = list(jax_data.prefetch_to_device(iter(src), size=size))
    got = list(pt_data.prefetch_to_device(iter(src), size=size, device="cpu"))
    assert len(got) == len(want) == len(src)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_prefetch_reads_ahead_by_size():
    """With ``size`` copies in flight, the first batch is handed over once
    ``size + 1`` batches were read, as in JAX."""
    for mod, kw in ((jax_data, {}), (pt_data, {"device": "cpu"})):
        read = []

        def source():
            for i, b in enumerate(_batches()):
                read.append(i)
                yield b

        it = mod.prefetch_to_device(source(), size=2, **kw)
        next(it)
        assert read == [0, 1, 2], mod


@pytest.mark.parametrize("size", [0, -1])
def test_prefetch_size_validation_as_in_jax(size):
    with pytest.raises(ValueError) as want:
        next(jax_data.prefetch_to_device(iter(_batches()), size=size))
    with pytest.raises(ValueError) as got:
        next(pt_data.prefetch_to_device(iter(_batches()), size=size,
                                        device="cpu"))
    assert str(got.value) == str(want.value)


def test_prefetch_refuses_sharding_and_defaults_to_cuda():
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        next(pt_data.prefetch_to_device(iter(_batches()), sharding=object(),
                                        device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(pt_data.prefetch_to_device(iter(_batches())))


# ---------------------------------------------------------------------------
# the histogram
# ---------------------------------------------------------------------------

OBSERVATIONS = [(0.0004, "compute"), (0.003, "compute"), (0.07, "grad_sync"),
                (1.0, "compute"), (2.5, 'snap"shot\\stall\n'), (75.0, "compute"),
                (0.01, "compute")]


@pytest.mark.parametrize("buckets", [None, (0.5, 0.01, 2.0)])
def test_histogram_renders_as_jax(buckets):
    kw = {} if buckets is None else {"buckets": buckets}
    want = jax_tel.Histogram("kt_test_seconds", "Help text", ("phase",), **kw)
    got = pt_tel.Histogram("kt_test_seconds", "Help text", ("phase",), **kw)
    assert got.render() == want.render()        # headers only
    for value, phase in OBSERVATIONS:
        want.observe(value, phase=phase)
        got.observe(value, phase=phase)
    assert got.render() == want.render()
    assert got.count(phase="compute") == want.count(phase="compute") == 5
    with pytest.raises(ValueError):
        got.observe(1.0, stage="x")


def test_timed_and_registry():
    hist = pt_tel.histogram("kt_test_timed_seconds", "t", labels=("phase",))
    assert pt_tel.histogram("kt_test_timed_seconds") is hist
    with pt_tel.timed(hist, phase="a"):
        pass
    assert hist.count(phase="a") == 1 and hist.count(phase="b") == 0
    with pytest.raises(ValueError, match="already registered as histogram"):
        pt_tel.gauge("kt_test_timed_seconds")
    m = pt_tel.train_metrics()
    assert m["step_seconds"].name == "kt_train_step_seconds"
    assert m["step_seconds"].labelnames == ("phase",)
    assert m["mfu"].name == "kt_train_mfu"
    assert pt_tel.train_metrics() is m


def _tiny_step(donate=True, **kw):
    cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl="xla")
    params = llama_init(cfg, seed=0, device="cpu")
    opt = pt_ts.default_optimizer(warmup_steps=1)
    step = pt_ts.make_train_step(
        lambda p, t, y: llama_loss_chunked(p, t, y, cfg, chunk=8),
        optimizer=opt, donate=donate, **kw)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, seed=3)[0].items()}
    return step, pt_ts.init_train_state(params, opt), batch


def test_make_train_step_observes_one_compute_sample_per_call():
    hist = pt_tel.train_metrics()["step_seconds"]
    step, state, batch = _tiny_step()
    before = hist.count(phase="compute")
    for i in range(3):
        state, _ = step(state, batch)
        assert hist.count(phase="compute") == before + i + 1
    # the bare accumulation path is not a step
    step.loss_and_grads(state.params, batch)
    assert hist.count(phase="compute") == before + 3


# ---------------------------------------------------------------------------
# the in-place update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inplace_update_equals_the_functional_one_bitwise(dtype):
    """``inplace=True`` writes each new leaf over its old one and returns
    the same bits as the functional update, over three updates of
    default_optimizer (clip, Adam with fp32 mu, decay, schedule); the
    functional update leaves its inputs as they were."""
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(4, 5, generator=gen).to(dtype),
              "b": {"c": torch.randn(7, generator=gen).to(dtype)}}
    opt = pt_ts.default_optimizer(warmup_steps=1)
    s_fun = opt.init(params)
    s_inp = pt_optim.tree_map(torch.clone, s_fun)
    for i in range(3):
        grads = pt_optim.tree_map(
            lambda p: (torch.randn(p.shape, generator=gen) * (3.0 if i else 0.1)
                       ).to(dtype), params)
        g_copy = pt_optim.tree_map(torch.clone, grads)
        old, snapshot = s_fun, pt_optim.tree_map(torch.clone, s_fun)
        u_fun, s_fun = opt.update(grads, old, params)
        for a, b in zip(pt_optim.tree_leaves((grads, old)),
                        pt_optim.tree_leaves((g_copy, snapshot))):
            assert torch.equal(a, b)
        u_inp, s_new = opt.update(g_copy, s_inp, params, inplace=True)
        for a, b in zip(pt_optim.tree_leaves(u_inp), pt_optim.tree_leaves(u_fun)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        mu_new, mu_old = s_new[1][0].mu, s_inp[1][0].mu
        assert mu_new["a"] is mu_old["a"]
        for a, b in zip(pt_optim.tree_leaves(s_new), pt_optim.tree_leaves(s_fun)):
            assert torch.equal(a, b)
        s_inp = s_new


def test_donated_step_equals_the_undonated_one_bitwise():
    step_d, state_d, batch = _tiny_step(donate=True)
    step_k, state_k, _ = _tiny_step(donate=False)
    params_d = state_d.params
    for _ in range(3):
        state_d, m_d = step_d(state_d, batch)
        state_k, m_k = step_k(state_k, batch)
        assert float(m_d["loss"]) == float(m_k["loss"])
    assert state_d.params["layers"]["wq"] is params_d["layers"]["wq"]
    for a, b in zip(pt_optim.tree_leaves(state_d), pt_optim.tree_leaves(state_k)):
        assert torch.equal(a, b)
