"""The port's serving path against ``repro.serve`` (greedy, f32, CPU).

Parameters come from ``test_torch_lm.np_params`` (numpy, seeded) and go
to both frameworks; ``reduced(get_config("microllama-300m"))``, and for
the SSM and hybrid families ``test_torch_ssm.np_params`` on reduced
falcon-mamba-7b and hymba-1.5b.  Greedy
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


# ------------------------------------------------------------------
# the SSM and hybrid families (reduced falcon-mamba-7b, hymba-1.5b)
# ------------------------------------------------------------------

SSM_ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]


@pytest.fixture(scope="module")
def ssm_params():
    """{arch: (cfg, jax cfg, jax params, port params)} from
    ``test_torch_ssm.np_params``."""
    from test_torch_ssm import cfgs, np_params as np_ssm_params
    out = {}
    for arch in SSM_ARCHS:
        cfg, jcfg = cfgs(arch)
        tree = np_ssm_params(cfg, seed=0)
        out[arch] = (cfg, jcfg, jax.tree.map(jnp.asarray, tree),
                     convert.params_from_numpy(tree, cfg, device="cpu"))
    return out


def _ssm_arms(cfg, jcfg, jp, tp, arm, jax_side=True):
    if arm == "dense":
        kw = dict(n_slots=N_SLOTS, cache_len=CACHE_LEN)
        return ((jsched.DenseBatcher(jp, jcfg, **kw) if jax_side else None),
                scheduler.DenseBatcher(tp, cfg, **kw))
    # 7 blocks for 3 lanes: the trace preempts, so resume (re-prefill
    # from a zeroed lane state) is compared too
    kw = dict(n_slots=N_SLOTS, cache_len=CACHE_LEN, block_size=BLOCK,
              num_blocks=7, chunk_size=CHUNK)
    return ((jsched.ContinuousBatcher(jp, jcfg, **kw) if jax_side else None),
            scheduler.ContinuousBatcher(tp, cfg, **kw))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_generate_greedy_matches_jax(ssm_params, arch):
    cfg, jcfg, jp, tp = ssm_params[arch]
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 7))
    want = jserve.generate(jp, jcfg, jnp.asarray(prompts, jnp.int32),
                           max_new_tokens=6)
    got = serve.generate(tp, cfg, prompts, max_new_tokens=6)
    assert got.tokens == want.tokens


@pytest.mark.parametrize("arm", ["dense", "paged"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_run_trace_matches_jax(ssm_params, arch, arm):
    """One bursty trace (prompts of 3..9 tokens, so none is shorter
    than the conv state) through both batchers: tokens and the
    tick-based ServeReport equal to the JAX package's."""
    cfg, jcfg, jp, tp = ssm_params[arch]
    spec = dict(n_requests=6, prompt_lo=3, prompt_hi=9, new_lo=3, new_hi=7)
    jarr = jtraffic.materialize(jtraffic.make_arrivals("bursty", **spec),
                                jcfg.vocab_size)
    tarr = traffic.materialize(traffic.make_arrivals("bursty", **spec),
                               cfg.vocab_size)
    jb, tb = _ssm_arms(cfg, jcfg, jp, tp, arm)
    jrep = jb.run_trace(jarr)
    trep = tb.run_trace(tarr)
    assert {r.rid: r.generated for _, r in tarr} \
        == {r.rid: r.generated for _, r in jarr}
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.requests_finished == 6
    if arm == "paged":
        assert tb.pool.no_leak()
        assert trep.preemptions > 0


def test_ssm_reused_lane_starts_from_zero_state(ssm_params):
    """One lane serves two requests in turn: the second one's tokens
    equal a fresh batcher's (the lane's conv and ssm state is zeroed at
    admission, not carried over from the first occupant)."""
    cfg, _, _, tp = ssm_params["falcon-mamba-7b"]
    rng = np.random.default_rng(2)
    first, second = (list(rng.integers(0, cfg.vocab_size, s)) for s in (9, 6))
    kw = dict(n_slots=1, cache_len=CACHE_LEN, block_size=BLOCK,
              chunk_size=CHUNK)
    reused = scheduler.ContinuousBatcher(tp, cfg, **kw)
    reused.submit(scheduler.Request(0, first, max_new_tokens=5))
    reused.submit(scheduler.Request(1, second, max_new_tokens=5))
    done = reused.run()
    fresh = scheduler.ContinuousBatcher(tp, cfg, **kw)
    fresh.submit(scheduler.Request(1, second, max_new_tokens=5))
    assert done[1].generated == fresh.run()[1].generated
    assert reused.pool.no_leak()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_short_prompts_agree_across_paths(ssm_params, arch):
    """Prompts of 1 and 2 tokens, shorter than the conv state (cw-1 =
    3): the port's DenseBatcher (one-shot prefill), ContinuousBatcher
    (chunked prefill) and generate give the same tokens, and so does
    the JAX package's chunk path (its ContinuousBatcher).  JAX's
    one-shot prefill returns a short conv state there (ROADMAP §3)."""
    cfg, jcfg, jp, tp = ssm_params[arch]
    prompts = {0: [5], 1: [7, 11]}
    want = {}
    jb, _ = _ssm_arms(cfg, jcfg, jp, tp, "paged")
    for rid, p in prompts.items():
        jb.submit(jsched.Request(rid, list(p), max_new_tokens=6))
    for rid, r in jb.run().items():
        want[rid] = r.generated
    for arm in ("dense", "paged"):
        _, tb = _ssm_arms(cfg, jcfg, jp, tp, arm, jax_side=False)
        for rid, p in prompts.items():
            tb.submit(scheduler.Request(rid, list(p), max_new_tokens=6))
        got = {rid: r.generated for rid, r in tb.run().items()}
        assert got == want, arm
    for rid, p in prompts.items():
        assert serve.generate(tp, cfg, [p], max_new_tokens=6).tokens[0] \
            == want[rid]
