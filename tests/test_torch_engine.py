"""The port's decode engine (`repro_torch.serve.engine`) against the JAX
package's, on the CPU.

On the same weights (JAX-initialised, f32 SMOKE tinyllama, carried by
`convert.lm_params_from_numpy`) and the same requests, the JAX scenarios
(EOS truncation, ragged finish with continuous joins, ``max_len``
truncation, several batch sizes) give the same tokens and the same
`BatchStats` at temperature 0. At temperature > 0 the port keeps the JAX
contract, not the JAX stream (torch cannot draw threefry streams): a
request's t-th token depends only on (seed, rid, t), which its own tests
hold (`tests/test_lm_decode.py::TestSamplingReproducibility`, ported).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Engine, Request


@pytest.fixture(scope="module")
def stacks():
    jcfg = dataclasses.replace(jconfigs.get("tinyllama-1.1b", smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get("tinyllama-1.1b", smoke=True),
                               dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _both(stacks, specs, **kw):
    """Serve the same requests through both engines -> (port, jax) reqs
    and stats."""
    (jcfg, jp), (tcfg, tp) = stacks
    je, te = JEngine(jcfg, jp, **kw), Engine(tcfg, tp, **kw)
    jr = je.generate([JRequest(**s) for s in specs])
    tr = te.generate([Request(**s) for s in specs])
    return tr, te.stats, jr, je.stats


def _equal(tr, ts, jr, js):
    assert [r.out for r in tr] == [[int(t) for t in r.out] for r in jr]
    assert [r.done for r in tr] == [r.done for r in jr]
    assert [r.rid for r in tr] == [r.rid for r in jr]
    assert ts.as_dict() == js.as_dict()
    assert ts.occupancy == js.occupancy


def test_eos_truncates_like_jax(stacks):
    prompt = np.arange(6, dtype=np.int32)
    tr, ts, jr, js = _both(stacks, [dict(prompt=prompt, max_new_tokens=8)],
                           batch_size=2, max_len=64)
    _equal(tr, ts, jr, js)
    eos = tr[0].out[3]
    tr, ts, jr, js = _both(stacks, [dict(prompt=prompt, max_new_tokens=8,
                                         eos_id=eos)],
                           batch_size=2, max_len=64)
    _equal(tr, ts, jr, js)
    assert tr[0].out[-1] == eos and len(tr[0].out) <= 4


@pytest.mark.parametrize("batch,max_len", [(3, 64), (2, 40), (4, 20),
                                           (1, 64)])
def test_ragged_finish_and_joins_like_jax(stacks, batch, max_len):
    rng = np.random.RandomState(2)
    specs = [dict(prompt=rng.randint(0, 512, size=5 + i),
                  max_new_tokens=3 + 2 * i) for i in range(6)]
    tr, ts, jr, js = _both(stacks, specs, batch_size=batch,
                           max_len=max_len)
    _equal(tr, ts, jr, js)
    assert ts.requests == 6
    if (batch, max_len) == (3, 64):
        assert ts.joins >= 1  # continuous batching happened


@pytest.fixture(scope="module", params=["mamba2-2.7b", "deepseek-v3-671b"])
def family_stacks(request):
    """f32 SMOKE stacks of the families whose caches hold more than k / v:
    mamba2 (conv, ssm) and deepseek-v3 (MLA's c_kv, k_rope)."""
    jcfg = dataclasses.replace(jconfigs.get(request.param, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get(request.param, smoke=True),
                               dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      device="cpu")
    return (jcfg, jp), (tcfg, tp)


def test_joins_splice_every_cache_field_like_jax(family_stacks):
    """Ragged requests with mid-flight joins: a joining request decodes
    from its own prefilled state in every cache field (the JAX engine
    splices every array leaf), so the tokens equal the JAX engine's."""
    rng = np.random.RandomState(3)
    specs = [dict(prompt=rng.randint(0, 512, size=4 + 3 * i),
                  max_new_tokens=2 + 3 * (i % 3)) for i in range(7)]
    tr, ts, jr, js = _both(family_stacks, specs, batch_size=3, max_len=48)
    _equal(tr, ts, jr, js)
    assert ts.joins >= 2


def test_max_len_truncates_mid_flight_like_jax(stacks):
    prompt = np.arange(8, dtype=np.int32)
    tr, ts, jr, js = _both(stacks, [dict(prompt=prompt, max_new_tokens=16)],
                           batch_size=1, max_len=10)
    _equal(tr, ts, jr, js)
    assert tr[0].done and len(tr[0].out) == 3  # ran out of cache room


def test_encoder_only_is_rejected():
    cfg = tconfigs.get("hubert-xlarge", smoke=True)
    with pytest.raises(ValueError, match="encoder-only"):
        Engine(cfg, tlm.init_params(0, cfg, device="cpu"))


# ---------------------------------------------------------------------------
# the sampling contract (temperature > 0), on the port alone
# ---------------------------------------------------------------------------

PLEN, MAX_NEW = 5, 6


@pytest.fixture(scope="module")
def tiny():
    cfg = tconfigs.get("tinyllama-1.1b", smoke=True)
    return cfg, tlm.init_params(0, cfg, device="cpu")


def _reqs(cfg, n):
    rng = np.random.RandomState(7)
    return [Request(prompt=rng.randint(0, cfg.vocab, size=PLEN),
                    max_new_tokens=MAX_NEW) for _ in range(n)]


def _sampler(cfg, params, batch_size):
    # max_len = PLEN + MAX_NEW - 1 makes every join fail: each request runs
    # in a fresh same-shape group, so the logits see no pad variation
    return Engine(cfg, params, batch_size=batch_size,
                  max_len=PLEN + MAX_NEW - 1, temperature=0.7, seed=0)


def test_samples_invariant_across_batch_sizes(tiny):
    cfg, params = tiny
    outs = {}
    for b in (1, 2, 4):
        reqs = _reqs(cfg, 4)
        _sampler(cfg, params, b).generate(reqs)
        outs[b] = [r.out for r in reqs]
    assert outs[1] == outs[2] == outs[4]
    greedy = _reqs(cfg, 4)
    Engine(cfg, params, batch_size=4, max_len=PLEN + MAX_NEW - 1
           ).generate(greedy)
    assert outs[1] != [r.out for r in greedy]  # the draw does sample


def test_stream_keyed_by_rid_not_slot(tiny):
    cfg, params = tiny
    reqs = _reqs(cfg, 3)
    _sampler(cfg, params, 4).generate(reqs)
    solo = _reqs(cfg, 3)[1]
    solo.rid = 1  # replay request 1's stream, alone in the batch
    _sampler(cfg, params, 1).generate([solo])
    assert solo.out == reqs[1].out
    other = _reqs(cfg, 3)[1]
    other.rid = 2  # the same prompt on another stream
    _sampler(cfg, params, 1).generate([other])
    assert other.out != reqs[1].out


def test_seed_selects_the_stream(tiny):
    cfg, params = tiny
    a, b = _reqs(cfg, 2), _reqs(cfg, 2)
    _sampler(cfg, params, 2).generate(a)
    Engine(cfg, params, batch_size=2, max_len=PLEN + MAX_NEW - 1,
           temperature=0.7, seed=1).generate(b)
    assert [r.out for r in a] != [r.out for r in b]


def test_greedy_ignores_temperature_machinery(tiny):
    cfg, params = tiny
    reqs, again = _reqs(cfg, 2), _reqs(cfg, 2)
    Engine(cfg, params, batch_size=2, max_len=32).generate(reqs)
    Engine(cfg, params, batch_size=2, max_len=32, seed=5).generate(again)
    assert [r.out for r in reqs] == [r.out for r in again]
