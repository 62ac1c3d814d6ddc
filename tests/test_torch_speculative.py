"""The port's standalone speculative decoding
(kubetorch_tpu_torch/serve/speculative.py) against the JAX package's, on
``tiny`` configs in fp32 on the CPU. Weights come from numpy with a seed
(``np_params``) or from JAX's ``moe_init``, carried across with
``params_from_numpy``.

Tolerances:

- ``_ingest``: fp32 logits within 1e-5 relative L2 per row (a row is one
  position's logits over the vocab), and the K/V rows it writes within
  1e-5 per row: both sides run the same fp32 math and differ only in the
  order of its sums.
- ``speculative_generate``: greedy tokens equal, not close, to JAX's
  ``generate`` of the target alone, for any draft; the acceptance
  statistics equal to JAX's ``speculative_generate`` on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import moe as jm
from kubetorch_tpu.models.generate import generate as jax_generate
from kubetorch_tpu.models.generate import init_cache as jax_init_cache
from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.serve import speculative as jax_spec
from kubetorch_tpu_torch.models import moe as pm
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.generate import init_cache
from kubetorch_tpu_torch.models.llama import LlamaConfig
from kubetorch_tpu_torch.ops.tolerance import row_rel_err
from kubetorch_tpu_torch.serve import SpecStats, speculative_generate
from kubetorch_tpu_torch.serve import speculative as pt_spec

from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

RTOL = 1e-5
# the JAX package's own draft: same vocabulary, narrower, one layer
DRAFT = dict(dim=32, n_layers=1, n_heads=2, n_kv_heads=1, ffn_dim=64)
VOCAB = JaxConfig.tiny().vocab_size


class Model:
    """One model on both sides: JAX params and config, the port's."""

    def __init__(self, tree, jcfg, pcfg):
        self.j = jax.tree_util.tree_map(jnp.asarray, tree)
        self.p = params_from_numpy(tree, device="cpu")
        self.jcfg, self.pcfg = jcfg, pcfg
        self.solo = {}          # (prompt, n) → JAX generate's tokens


def dense(seed, **kw):
    jcfg = JaxConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla",
                          **kw)
    return Model(np_params(jcfg, seed=seed), jcfg,
                 LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash",
                                  **kw))


def moe(seed=1):
    """MoE ``tiny`` at the dense models' vocabulary, which draft and
    target must share."""
    jcfg = jm.MoeConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla",
                             vocab_size=VOCAB)
    tree = jax.tree_util.tree_map(
        np.asarray, jm.moe_init(jax.random.PRNGKey(seed), jcfg))
    return Model(tree, jcfg, pm.MoeConfig.tiny(
        dtype=torch.float32, attn_impl="flash", vocab_size=VOCAB))


def solo(m: Model, prompt, n):
    """JAX ``generate`` of ``prompt`` alone, greedy (memoized on ``m``)."""
    key = (tuple(prompt), n)
    if key not in m.solo:
        out = jax_generate(m.j, jnp.asarray([prompt], jnp.int32), m.jcfg,
                           max_new_tokens=n)
        m.solo[key] = np.asarray(out)[0, len(prompt):].tolist()
    return m.solo[key]


@pytest.fixture(scope="module")
def target():
    return dense(11)


@pytest.fixture(scope="module")
def draft():
    return dense(12, **DRAFT)


@pytest.fixture(scope="module")
def moe_target():
    return moe()


# ---------------------------------------------------------------------------
# _ingest
# ---------------------------------------------------------------------------


def _close_rows(got: torch.Tensor, want) -> float:
    return row_rel_err(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_ingest_matches_jax(target, moe_target, kind):
    """The three window kinds on one cache: the prompt prefill at a padded
    bucket ("last", with the real length's MoE capacity), a draft prompt
    ingest ("none"), then a verify window with padding ("all", no_drop),
    each against JAX's ``_ingest`` on the same cache state."""
    m = target if kind == "dense" else moe_target
    rng = np.random.default_rng(3)
    s_max = 32
    jc = jax_init_cache(m.jcfg, 1, s_max)
    pc = init_cache(m.pcfg, 1, s_max, device="cpu")
    prompt = rng.integers(0, m.jcfg.vocab_size, (1, 8)).astype(np.int32)
    keep = pm.moe_prefill_keep_capacity(m.pcfg, 5)
    assert (keep is None) == (kind == "dense")
    jl, jc = jax_spec._ingest(m.j, jc, jnp.asarray(prompt), jnp.int32(0),
                              jnp.int32(5), m.jcfg, logits="last",
                              keep_capacity=keep)
    pl = pt_spec._ingest(m.p, pc, torch.from_numpy(prompt).long(), 0, 5,
                         m.pcfg, logits="last", keep_capacity=keep)
    assert pl.shape == (1, m.jcfg.vocab_size)
    assert _close_rows(pl, jl) <= RTOL

    window = rng.integers(0, m.jcfg.vocab_size, (1, 5)).astype(np.int32)
    jl, jc = jax_spec._ingest(m.j, jc, jnp.asarray(window), jnp.int32(5),
                              jnp.int32(3), m.jcfg, no_drop=True)
    pl = pt_spec._ingest(m.p, pc, torch.from_numpy(window).long(), 5, 3,
                         m.pcfg, no_drop=True)
    assert pl.shape == (1, 5, m.jcfg.vocab_size)
    assert _close_rows(pl, jl) <= RTOL
    for got, want in ((pc.k, jc.k), (pc.v, jc.v)):
        assert _close_rows(got, want) <= RTOL

    none, jc = jax_spec._ingest(m.j, jc, jnp.asarray(window), jnp.int32(10),
                                jnp.int32(5), m.jcfg, logits="none")
    assert none is None
    assert pt_spec._ingest(m.p, pc, torch.from_numpy(window).long(), 10, 5,
                           m.pcfg, logits="none") is None
    for got, want in ((pc.k, jc.k), (pc.v, jc.v)):
        assert _close_rows(got, want) <= RTOL


def test_draft_propose_matches_jax(target, draft):
    """k=3 proposals after a 2-token pending block, on a cache that holds
    a prompt's rows on both sides."""
    prompt = np.zeros((1, 8), np.int32)
    prompt[0, :6] = [5, 17, 42, 99, 7, 3]
    jc = jax_init_cache(draft.jcfg, 1, 32)
    pc = init_cache(draft.pcfg, 1, 32, device="cpu")
    _, jc = jax_spec._ingest(draft.j, jc, jnp.asarray(prompt), jnp.int32(0),
                             jnp.int32(6), draft.jcfg, logits="none")
    pt_spec._ingest(draft.p, pc, torch.from_numpy(prompt).long(), 0, 6,
                    draft.pcfg, logits="none")
    block = np.array([[11, 12, 0, 0]], np.int32)
    want, jc = jax_spec._draft_propose(draft.j, jc, jnp.asarray(block),
                                       jnp.int32(6), jnp.int32(2),
                                       draft.jcfg, 3)
    got = pt_spec._draft_propose(draft.p, pc, torch.from_numpy(block).long(),
                                 6, 2, draft.pcfg, 3)
    assert got == np.asarray(want).tolist()
    for g, w in ((pc.k, jc.k), (pc.v, jc.v)):
        assert _close_rows(g, w) <= RTOL


# ---------------------------------------------------------------------------
# speculative_generate
# ---------------------------------------------------------------------------


def _spec(tm, dm, prompt, n, k, **kw):
    stats = SpecStats()
    got = speculative_generate(tm.p, tm.pcfg, dm.p, dm.pcfg, prompt,
                               max_new_tokens=n, k=k, stats=stats,
                               device="cpu", **kw)
    return got, stats


def _jax_spec_stats(tm, dm, prompt, n, k):
    stats = jax_spec.SpecStats()
    toks = jax_spec.speculative_generate(tm.j, tm.jcfg, dm.j, dm.jcfg,
                                         prompt, max_new_tokens=n, k=k,
                                         stats=stats)
    return toks, (stats.rounds, stats.proposed, stats.accepted)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_matches_jax_generate_for_any_draft(target, draft, k):
    prompt = [5, 17, 42, 99]
    got, stats = _spec(target, draft, prompt, 12, k)
    assert got == solo(target, prompt, 12)
    want_toks, want_stats = _jax_spec_stats(target, draft, prompt, 12, k)
    assert got == want_toks
    assert (stats.rounds, stats.proposed, stats.accepted) == want_stats
    assert stats.rounds >= 1 and 0 <= stats.acceptance_rate <= 1


def test_self_draft_accepts_everything(target):
    """Draft == target: every proposal matches, and rounds collapse to
    about max_new / (k+1)."""
    got, stats = _spec(target, target, [3, 4, 5], 12, 3)
    assert got == solo(target, [3, 4, 5], 12)
    assert stats.acceptance_rate == 1.0
    assert stats.rounds <= -(-12 // 4) + 1


@pytest.mark.parametrize("prompt,n", [([1], 7), ([9, 8, 7, 6, 5], 5),
                                      ([100] * 9, 10)])
def test_various_prompts_and_lengths(target, draft, prompt, n):
    got, _ = _spec(target, draft, prompt, n, 3)
    assert got == solo(target, prompt, n)


def test_max_len_pins_the_cache_and_buckets_pad(target, draft):
    """A pinned max_len wider than the request, and a prompt padded to a
    bucket: the same tokens."""
    prompt = [7, 1, 2, 3, 4]
    got, _ = _spec(target, draft, prompt, 9, 2, max_len=64,
                   prompt_buckets=(8,))
    assert got == solo(target, prompt, 9)


def test_validation_raises_as_jax(target, draft):
    cases = [dict(prompt=[], max_new_tokens=4),
             dict(prompt=[1, 2], max_new_tokens=8, k=2, max_len=4)]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            jax_spec.speculative_generate(target.j, target.jcfg, draft.j,
                                          draft.jcfg, **kw)
        with pytest.raises(ValueError) as got:
            speculative_generate(target.p, target.pcfg, draft.p, draft.pcfg,
                                 device="cpu", **kw)
        assert str(got.value).split()[0] == str(want.value).split()[0]


def test_vocab_mismatch_refused(target):
    """The port refuses what JAX serves by clamping out-of-range ids into
    the embedding: a draft over another vocabulary."""
    small = dense(13, vocab_size=256, **DRAFT)
    with pytest.raises(ValueError, match="vocab_size"):
        speculative_generate(target.p, target.pcfg, small.p, small.pcfg,
                             [1, 2], max_new_tokens=3, device="cpu")


def test_params_on_another_device_refused(target, draft):
    meta = {**draft.p, "embed": draft.p["embed"].to("meta")}
    with pytest.raises(ValueError, match="params are on"):
        speculative_generate(target.p, target.pcfg, meta, draft.pcfg, [1, 2],
                             max_new_tokens=3, device="cpu")


# ---------------------------------------------------------------------------
# MoE: drop-free windows, the real length's capacity at the prompt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_moe_target_dense_draft(moe_target, draft, k):
    for prompt, n in [([5, 17, 42, 99], 10), ([7] * 9, 8)]:
        got, stats = _spec(moe_target, draft, prompt, n, k)
        assert got == solo(moe_target, prompt, n), (prompt, n, k)
        assert stats.rounds >= 1


def test_moe_self_draft_accepts_everything(moe_target):
    """Any draft/verify routing mismatch shows as an acceptance rate below
    1.0 before it breaks exactness."""
    got, stats = _spec(moe_target, moe_target, [3, 4, 5], 10, 3)
    assert got == solo(moe_target, [3, 4, 5], 10)
    assert stats.acceptance_rate == 1.0


def test_moe_draft_dense_target(target, moe_target):
    got, _ = _spec(target, moe_target, [9, 8, 7], 8, 3)
    assert got == solo(target, [9, 8, 7], 8)
