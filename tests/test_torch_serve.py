"""The port's serving path against ``repro.serve`` (greedy, f32, CPU).

Parameters come from ``test_torch_lm.np_params`` (numpy, seeded) and go
to both frameworks; ``reduced(get_config("microllama-300m"))``.  Greedy
tokens must match the JAX package's token for token, and the
tick-deterministic ``ServeReport`` fields must be equal.  Sampled
(temperature) output cannot match JAX's bits — the port has its own
counter-based streams — so it is held to being reproducible from a seed
and independent of scheduling.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import serve as jserve
from repro.serve import scheduler as jsched
from repro.serve import traffic as jtraffic
from repro_torch import convert, serve
from repro_torch.serve import scheduler, traffic
from test_torch_lm import CFG, JCFG, np_params, one_torch_thread  # noqa: F401

N_SLOTS, CACHE_LEN, BLOCK, CHUNK = 3, 32, 4, 4


@pytest.fixture(scope="module")
def params():
    tree = np_params(CFG, seed=0)
    return (jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, CFG, device="cpu"))


def test_generate_greedy_matches_jax(params):
    jp, tp = params
    prompts = np.random.default_rng(1).integers(0, CFG.vocab_size, (3, 9))
    want = jserve.generate(jp, JCFG, jnp.asarray(prompts, jnp.int32),
                           max_new_tokens=8)
    got = serve.generate(tp, CFG, prompts, max_new_tokens=8)
    assert got.tokens == want.tokens
    assert got.steps == want.steps == 8


def _arms(jp, tp, arm):
    if arm == "dense":
        return (jsched.DenseBatcher(jp, JCFG, n_slots=N_SLOTS,
                                    cache_len=CACHE_LEN),
                scheduler.DenseBatcher(tp, CFG, n_slots=N_SLOTS,
                                       cache_len=CACHE_LEN))
    # a pool of 7 blocks for 3 lanes of up to 8 blocks: both traces
    # preempt (7 times each), so resume is compared too
    kw = dict(n_slots=N_SLOTS, cache_len=CACHE_LEN, block_size=BLOCK,
              num_blocks=7, chunk_size=CHUNK)
    return (jsched.ContinuousBatcher(jp, JCFG, **kw),
            scheduler.ContinuousBatcher(tp, CFG, **kw))


@pytest.mark.parametrize("trace", ["steady", "bursty"])
@pytest.mark.parametrize("arm", ["dense", "paged"])
def test_run_trace_matches_jax(params, trace, arm):
    jp, tp = params
    spec = dict(n_requests=8, prompt_lo=4, prompt_hi=14, new_lo=3,
                new_hi=10)
    jarr = jtraffic.materialize(jtraffic.make_arrivals(trace, **spec),
                                JCFG.vocab_size)
    tarr = traffic.materialize(traffic.make_arrivals(trace, **spec),
                               CFG.vocab_size)
    jb, tb = _arms(jp, tp, arm)
    jrep = jb.run_trace(jarr)
    trep = tb.run_trace(tarr)
    assert {r.rid: r.generated for _, r in tarr} \
        == {r.rid: r.generated for _, r in jarr}
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert tb._admit_seq == jb._admit_seq          # same FIFO admissions
    assert trep.requests_finished == 8
    if arm == "paged":
        assert tb.pool.no_leak()
        assert trep.preemptions > 0


def _sampled(tp, batcher_kw, seed):
    kind = batcher_kw.pop("kind")
    cls = (scheduler.DenseBatcher if kind == "dense"
           else scheduler.ContinuousBatcher)
    b = cls(tp, CFG, seed=seed, **batcher_kw)
    arr = traffic.materialize(
        traffic.make_arrivals("bursty", n_requests=6, prompt_lo=4,
                              prompt_hi=12, new_lo=4, new_hi=8),
        CFG.vocab_size, temperature=0.9, top_k=40)
    b.run_trace(arr)
    return {r.rid: r.generated for _, r in arr}


def test_sampling_reproducible_and_independent_of_scheduling(params):
    _, tp = params
    layouts = [dict(kind="dense", n_slots=3, cache_len=CACHE_LEN),
               dict(kind="paged", n_slots=1, cache_len=CACHE_LEN,
                    block_size=BLOCK),
               dict(kind="paged", n_slots=3, cache_len=CACHE_LEN,
                    block_size=BLOCK, num_blocks=7, chunk_size=CHUNK)]
    runs = [_sampled(tp, dict(kw), seed=5) for kw in layouts]
    assert runs[0] == runs[1] == runs[2]
    assert _sampled(tp, dict(layouts[0]), seed=6) != runs[0]
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6]]
    a = serve.generate(tp, CFG, prompts, max_new_tokens=6, temperature=1.0,
                       seed=3)
    b = serve.generate(tp, CFG, prompts, max_new_tokens=6, temperature=1.0,
                       seed=3)
    assert a.tokens == b.tokens
    # row b of a batch draws from stream (seed, b, n): row 0 alone agrees
    c = serve.generate(tp, CFG, prompts[:1], max_new_tokens=6,
                       temperature=1.0, seed=3)
    assert c.tokens[0] == a.tokens[0]


def test_generate_short_cache_len_raises(params):
    _, tp = params
    with pytest.raises(ValueError, match="ring=True"):
        serve.generate(tp, CFG, [[1, 2, 3, 4, 5, 6]], max_new_tokens=8,
                       cache_len=10)
    r = serve.generate(tp, CFG, [[1, 2, 3, 4, 5, 6]], max_new_tokens=8,
                       cache_len=10, ring=True)
    assert len(r.tokens[0]) == 8
