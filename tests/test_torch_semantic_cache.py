"""The port's ACAM semantic cache (`repro_torch.serve.semantic_cache`)
against the JAX package's, on the CPU.

Both packages route the same prompt traces through `SemanticCacheService`
with decode engines on the same weights (JAX-initialised, f32 SMOKE
tinyllama) at temperature 0: the same hits, misses, template rows, margins,
scores, tokens and energies, the energy ledger bit for bit. The JAX
package's router scenarios are carried across (miss -> admit -> hit replay,
a disabled cache equal to the bare engine, template churn, a cold tenant
that never fabricates a hit, the cnn <-> lm backend swap), a snapshot
written by either package restores in the other with the same hits, and
the launcher's ``lm`` / ``lm-cached`` workloads and ``lm_cache_bench`` give
the JAX counts.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import serving_bench as jbench  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.checkpointer import Checkpointer as JCkpt  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import acam_service as jsvc_lib  # noqa: E402
from repro.serve import semantic_cache as jsc  # noqa: E402
from repro.serve import spec as jspec  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.benchmarks import serving_bench as tbench  # noqa: E402
from repro_torch.checkpoint.checkpointer import \
    Checkpointer as TCkpt  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve import acam_service as tsvc_lib  # noqa: E402
from repro_torch.serve import semantic_cache as tsc  # noqa: E402
from repro_torch.serve import spec as tspec  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

N_FEATURES = 64


def make_spec(m, **router_kw):
    router_kw.setdefault("max_templates", 8)
    router_kw.setdefault("response_capacity", 16)
    return m.ServiceSpec(
        registry=m.RegistrySpec(num_features=N_FEATURES),
        scheduler=m.SchedulerSpec(slots=8),
        cascade=m.CascadeSpec(backend="lm", tau=8.0, tau_units="count"),
        router=m.RouterSpec(**router_kw),
        mesh=m.MeshSpec(install=False))


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


def _services(stacks, *, batch_size=4, **router_kw):
    (jcfg, jp), (tcfg, tp) = stacks
    js = jsc.SemanticCacheService.from_spec(
        make_spec(jspec, **router_kw),
        engine=JEngine(jcfg, jp, batch_size=batch_size, max_len=64))
    ts = tsc.SemanticCacheService.from_spec(
        make_spec(tspec, **router_kw),
        engine=Engine(tcfg, tp, batch_size=batch_size, max_len=64),
        device="cpu")
    js.add_tenant("edge-0")
    ts.add_tenant("edge-0")
    return ts, js


def _routed(out):
    return [(r.request_id, r.tenant_id, tuple(int(t) for t in r.tokens),
             r.cache_hit, r.template_id, np.float32(r.margin),
             np.float32(r.score), r.energy_j, r.error) for r in out]


def _serve(svc, lib, trace, max_new):
    return svc.serve_prompts(lib.PromptRequest("edge-0", p,
                                               max_new_tokens=max_new)
                             for p in trace)


# ---------------------------------------------------------------------------
# pure-Python parts: featurizers, trace, store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_featurizers_and_trace_match_jax(seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, size=n) for n in (1, 2, 9, 16)]
    tf = tsc.hashing_featurizer(N_FEATURES, seed=seed)
    jf = jsc.hashing_featurizer(N_FEATURES, seed=seed)
    table = rng.standard_normal((512, 32)).astype(np.float32)
    te = tsc.embedding_featurizer(torch.from_numpy(table),
                                  num_features=N_FEATURES, seed=seed)
    je = jsc.embedding_featurizer(table, num_features=N_FEATURES, seed=seed)
    for p in prompts:
        np.testing.assert_array_equal(tf(p), jf(p))
        np.testing.assert_array_equal(te(p), je(p))
    kw = dict(vocab=512, n_unique=5, n_requests=17, min_len=3, max_len=9)
    for a, b in zip(tsc.synthetic_prompt_trace(seed, **kw),
                    jsc.synthetic_prompt_trace(seed, **kw)):
        np.testing.assert_array_equal(a, b)


def test_response_store_matches_jax():
    ts, js = tsc.ResponseStore(2), jsc.ResponseStore(2)
    for s in (ts, js):
        assert s.put(("a", 0), (1,)) == []
        assert s.put(("a", 1), (2,)) == []
        s.get(("a", 0))
    assert ts.put(("a", 2), (3,)) == js.put(("a", 2), (3,)) == [("a", 1)]
    assert ts.state() == js.state()
    assert ts.oldest_row("a") == js.oldest_row("a") == 0
    again = tsc.ResponseStore(2)
    again.load_state(js.state())
    assert again.put(("a", 3), (4,)) == [("a", 0)]


# ---------------------------------------------------------------------------
# routing against JAX
# ---------------------------------------------------------------------------

def test_miss_admit_hit_replay_matches_jax(stacks):
    ts, js = _services(stacks)
    trace = jsc.synthetic_prompt_trace(7, vocab=512, n_unique=4,
                                       n_requests=12)
    tout, jout = _serve(ts, tsc, trace, 6), _serve(js, jsc, trace, 6)
    assert _routed(tout) == _routed(jout)
    hits = [r for r in tout if r.cache_hit]
    misses = [r for r in tout if not r.cache_hit]
    assert len(misses) == 8 and len(hits) == 4  # slots=8: tick 2 all hit
    decoded = {r.template_id: r.tokens for r in misses}
    assert all(r.tokens == decoded[r.template_id] for r in hits)
    tm, jm = ts.metrics(), js.metrics()
    for key in ("completed", "escalated", "ticks", "classify_dispatches",
                "nj_per_request", "energy_total_j"):
        assert tm[key] == jm[key], key
    assert tm["classify_dispatches"] == tm["ticks"]
    for event in ("hit", "miss", "insert", "evict"):
        assert ts.obs.cache_events.value(event=event) == \
            js.obs.cache_events.value(event=event), event
    assert ts.obs.cache_events.value(event="insert") == 4  # deduped


def test_energy_ledger_bit_for_bit_with_jax(stacks):
    ts, js = _services(stacks)
    trace = jsc.synthetic_prompt_trace(3, vocab=512, n_unique=2,
                                       n_requests=8)
    tout = _serve(ts, tsc, trace[:2], 6) + _serve(ts, tsc, trace[2:], 6)
    jout = _serve(js, jsc, trace[:2], 6) + _serve(js, jsc, trace[2:], 6)
    assert [r.energy_j for r in tout] == [r.energy_j for r in jout]
    assert ts.obs.ledger.fleet_j() == js.obs.ledger.fleet_j()
    assert ts.obs.ledger.backend_j() == js.obs.ledger.backend_j()
    assert ts.obs.ledger.frontend_j() == js.obs.ledger.frontend_j()
    total = 0.0
    for r in tout:
        total += r.energy_j
    assert abs(total - ts.obs.ledger.fleet_j()) < 1e-18
    hit_j = max(r.energy_j for r in tout if r.cache_hit)
    miss_j = min(r.energy_j for r in tout if not r.cache_hit)
    assert miss_j > 100 * hit_j  # the paper's asymmetry, LM-sized


def test_disabled_cache_equals_the_bare_engine(stacks):
    (_, _), (tcfg, tp) = stacks
    ts, js = _services(stacks, batch_size=8, enabled=False)
    trace = jsc.synthetic_prompt_trace(5, vocab=512, n_unique=4,
                                       n_requests=4)
    tout, jout = _serve(ts, tsc, trace, 6), _serve(js, jsc, trace, 6)
    assert _routed(tout) == _routed(jout)
    assert not any(r.cache_hit for r in tout)
    refs = Engine(tcfg, tp, batch_size=8, max_len=64).generate(
        [Request(prompt=p, max_new_tokens=6) for p in trace])
    assert [list(r.tokens) for r in tout] == [r.out for r in refs]


def test_template_churn_matches_jax(stacks):
    ts, js = _services(stacks, max_templates=2, response_capacity=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=10).astype(np.int32)
               for _ in range(5)]
    for p in prompts + prompts[-1:]:
        (tr,) = _serve(ts, tsc, [p], 4)
        (jr,) = _serve(js, jsc, [p], 4)
        assert _routed([tr]) == _routed([jr])
    assert tr.cache_hit  # the survivor still hits
    for event, n in (("insert", 5), ("evict", 3), ("hit", 1)):
        assert ts.obs.cache_events.value(event=event) == n == \
            js.obs.cache_events.value(event=event)
    assert ts._store.state() == js._store.state()


def test_cold_tenant_never_fabricates_a_hit(stacks):
    ts, js = _services(stacks, admit_on_miss=False)
    trace = jsc.synthetic_prompt_trace(1, vocab=512, n_unique=2,
                                       n_requests=6)
    tout, jout = _serve(ts, tsc, trace, 4), _serve(js, jsc, trace, 4)
    assert _routed(tout) == _routed(jout)
    assert not any(r.cache_hit for r in tout)
    assert ts.obs.cache_events.value(event="insert") == 0


def test_hit_score_floor_matches_jax(stacks):
    ts, js = _services(stacks, max_templates=1, hit_score=0.95)
    rng = np.random.default_rng(4)
    a = rng.integers(0, 512, size=12).astype(np.int32)
    near = a.copy()
    near[-1] = (near[-1] + 1) % 512
    for trace in ([a], [a], [near]):
        assert _routed(_serve(ts, tsc, trace, 3)) == \
            _routed(_serve(js, jsc, trace, 3))


# ---------------------------------------------------------------------------
# durability and live swaps
# ---------------------------------------------------------------------------

def test_snapshot_spec_serialises_like_jax():
    for kw in (dict(), dict(hit_score=0.8, admit_on_miss=False,
                            featurizer="embedding", featurizer_seed=3)):
        assert make_spec(tspec, **kw).to_dict() == \
            make_spec(jspec, **kw).to_dict()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_restores_across_packages(stacks, tmp_path, writer):
    """A snapshot written by either package restores in the other,
    engine-less, and serves the same hits with the same tokens."""
    ts, js = _services(stacks)
    trace = jsc.synthetic_prompt_trace(11, vocab=512, n_unique=3,
                                       n_requests=6)
    src = ts if writer == "port" else js
    out = _serve(src, tsc if writer == "port" else jsc, trace, 5)
    decoded = {r.template_id: r.tokens for r in out if not r.cache_hit}
    if writer == "port":
        src.snapshot(TCkpt(tmp_path))
        dst, _ = jsc.SemanticCacheService.restore(JCkpt(tmp_path))
        lib = jsc
    else:
        src.snapshot(JCkpt(tmp_path))
        dst, _ = tsc.SemanticCacheService.restore(TCkpt(tmp_path),
                                                  device="cpu")
        lib = tsc
    assert dst._store.state() == src._store.state()
    np.testing.assert_array_equal(dst._templates["edge-0"].bits,
                                  src._templates["edge-0"].bits)
    np.testing.assert_array_equal(dst._templates["edge-0"].valid,
                                  src._templates["edge-0"].valid)
    replay = _serve(dst, lib, trace[:3], 5)
    assert all(r.cache_hit for r in replay)
    assert [tuple(r.tokens) for r in replay] == \
        [tuple(decoded[r.template_id]) for r in replay]


def test_restored_miss_without_engine_raises(stacks, tmp_path):
    ts, _ = _services(stacks)
    ts.snapshot(TCkpt(tmp_path))
    svc, _ = tsc.SemanticCacheService.restore(TCkpt(tmp_path), device="cpu")
    svc.submit_prompt(tsc.PromptRequest("edge-0",
                                        np.arange(8, dtype=np.int32)))
    with pytest.raises(RuntimeError, match="decode engine"):
        svc.step_routed()


def test_embedding_featurizer_needs_the_engine(stacks):
    (_, _), (tcfg, tp) = stacks
    svc = tsc.SemanticCacheService.from_spec(
        make_spec(tspec, featurizer="embedding"), device="cpu")
    svc.add_tenant("edge-0")
    with pytest.raises(RuntimeError, match="attach_backend"):
        svc.submit_prompt(tsc.PromptRequest("edge-0", np.arange(4)))
    svc.attach_backend(Engine(tcfg, tp, batch_size=4, max_len=64))
    (r,) = svc.serve_prompts([tsc.PromptRequest("edge-0", np.arange(4),
                                                max_new_tokens=2)])
    assert not r.cache_hit and len(r.tokens) == 2


def test_cnn_lm_swap_drains_queued_work_both_ways(stacks):
    ts, js = _services(stacks)
    trace = jsc.synthetic_prompt_trace(2, vocab=512, n_unique=3,
                                       n_requests=3)
    results = []
    for svc, lib, slib, m in ((ts, tsc, tsvc_lib, tspec),
                              (js, jsc, jsvc_lib, jspec)):
        for p in trace:
            svc.submit_prompt(lib.PromptRequest("edge-0", p,
                                                max_new_tokens=4))
        spec = make_spec(m)
        cnn = spec._replace(cascade=spec.cascade._replace(backend="cnn"))
        report = svc.reconfigure(cnn)  # lm -> cnn: drains under lm
        routed = svc.collect_routed(report.drained)
        assert svc.spec.cascade.backend == "cnn"
        bank, head, protos = jsvc_lib.make_synthetic_tenant(
            3, num_features=N_FEATURES)
        if lib is tsc:
            bank = convert.bank_from_numpy(*(np.asarray(a) for a in bank),
                                           device="cpu")
        svc.register_tenant("clf-0", bank, head=head)
        feats, _ = jsvc_lib.sample_tenant_queries(4, protos, 3)
        for f in feats:
            svc.submit(slib.ClassifyRequest("clf-0", f))
        report2 = svc.reconfigure(spec)  # cnn -> lm with classify queued
        assert svc.spec.cascade.backend == "lm"
        results.append((_routed(routed),
                        [(r.pred, r.escalated, r.error)
                         for r in report2.drained]))
    assert results[0] == results[1]
    assert len(results[0][0]) == 3 and len(results[0][1]) == 3
    assert all(len(r[2]) == 4 for r in results[0][0])


# ---------------------------------------------------------------------------
# the launcher's LM workloads and the bench's LM rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--workload", "lm"],
    ["--workload", "lm", "--arch", "qwen3-1.7b", "--requests", "5",
     "--max-new", "4", "--batch-size", "2"],
])
def test_launcher_lm_counts_match_jax(capsys, argv):
    got = tserve.main(argv, device="cpu")
    want = jserve.main(argv)
    out = capsys.readouterr().out
    assert got["tokens"] == want["tokens"]
    assert out.count(f"requests, {got['tokens']} tokens") == 2
    assert all(r.done for r in got["requests"])


def test_launcher_lm_cached_counts_match_jax(capsys):
    argv = ["--workload", "lm-cached", "--print-spec"]
    got = tserve.main(argv, device="cpu")
    want = jserve.main(argv)
    out = capsys.readouterr().out
    for key in ("hits", "served", "classify_dispatches", "ticks",
                "nj_per_request", "escalated", "completed"):
        assert got[key] == want[key], key
    assert got["hits"] == 24 and got["served"] == 32
    specs = [line for line in out.splitlines() if line.startswith("{")]
    assert len(specs) == 2 and specs[0] == specs[1]


def test_lm_cache_bench_rows_match_jax():
    got = tbench.lm_cache_bench(smoke=True, device="cpu")
    want = jbench.lm_cache_bench(smoke=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tbench._row_name(g) == jbench._row_name(w)
        for key in ("requests", "slots", "hit_rate", "escalation_rate",
                    "nj_per_request", "mean_energy_ratio",
                    "hit_path_energy_ratio", "hit_path_nj",
                    "decode_energy_nj", "classify_dispatches", "occupancy"):
            assert g.get(key) == w.get(key), key
