"""The port's bank-sharded matching against its replicated calls and the
JAX package's.

Forced meshes (`repro_torch.distributed.forcemesh`, the CPU repeated) run
the engine's `PartitionPlan` on one device. Oracles:

  * the port's replicated call (no mesh) and JAX's replicated call, in
    process: feature count bit-identical (pred, per_class, margin,
    escalate) under forced 1x2, 1x4, 2x2 and 1x8 meshes and both merge
    strategies, B 256, C 512, N 784, windows straddling and edging the
    shard boundaries and empty ones, and a 2,304-class K 2 bank past
    `MAX_FUSED_ROWS` on each of two shards;
  * JAX's sharded execution (`shard_map` over forced host devices) in one
    subprocess: the merges' NaN semantics (which a sharded call keeps and
    a replicated argmax does not) and the similarity engine at 1x4.

Similarity runs on dyadic windows (bit-identical) at a smaller size, the
device backend at sigma 0 and with ``per_shard`` noise against
`classify_features_keyed(bank_shards=S)`.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_fallback import given, settings, st
from _torch_parity import (JaxJob, assert_equal_outputs, dyadic_windows,
                           port_mesh, to_np)
from repro import match as jmatch
from repro.core.templates import TemplateBank as JBank
from repro.distributed import forcemesh as jforcemesh
from repro.launch import mesh as jmesh
from repro_torch import match as tmatch
from repro_torch.core import acam as tacam
from repro_torch.core.templates import TemplateBank as TBank
from repro_torch.distributed import context, forcemesh
from repro_torch.launch import mesh as tmesh
from repro_torch.match import engine as tengine

C, K, N, B, T = 512, 2, 784, 256, 8
MESHES = [(1, 2), (1, 4), (2, 2), (1, 8)]


@pytest.fixture(autouse=True)
def no_mesh(monkeypatch):
    monkeypatch.delenv("REPRO_FORCE_MESH", raising=False)
    monkeypatch.delenv("REPRO_REDUCE_STRATEGY", raising=False)
    context.clear()
    yield
    context.clear()


# ---------------------------------------------------------------------------
# the plan, the mesh, forced meshes
# ---------------------------------------------------------------------------

def test_reduce_strategy_and_env_override(monkeypatch):
    for env in ("", "tree", "allgather", "bogus"):
        monkeypatch.setenv("REPRO_REDUCE_STRATEGY", env)
        for s in range(1, 17):
            assert tmatch.reduce_strategy(s) == jmatch.reduce_strategy(s)
    monkeypatch.setenv("REPRO_REDUCE_STRATEGY", "")
    assert tmatch.reduce_strategy(8) == "tree"
    assert tmatch.reduce_strategy(4) == tmatch.reduce_strategy(6) \
        == "allgather"
    monkeypatch.setenv("REPRO_REDUCE_STRATEGY", "tree")
    assert tmatch.reduce_strategy(2) == "tree"
    assert tmatch.reduce_strategy(6) == "allgather"  # needs a power of two
    assert tmatch.TREE_REDUCE_MIN_SHARDS == jmatch.TREE_REDUCE_MIN_SHARDS


@pytest.mark.parametrize("shape", MESHES + [(2, 1), (3, 2)])
def test_plan_rules(shape):
    d, m = shape
    with port_mesh(shape) as mesh:
        assert mesh.virtual and mesh.shape == {"data": d, "model": m}
        assert tmatch.bank_shards_in_mesh() == m
        for batch, classes in itertools.product((1, 6, 256), (3, 96, 512)):
            plan, got_mesh = tmatch.plan_for(batch=batch,
                                             num_classes=classes)
            dp = d if d > 1 and batch % d == 0 else 1
            shards = m if m > 1 and classes % m == 0 else 1
            assert (plan.dp_devices, plan.bank_shards) == (dp, shards)
            assert plan.rows_per_shard == (classes // shards
                                           if shards > 1 else 0)
            assert plan.reduce == tmatch.reduce_strategy(shards)
            assert (got_mesh is None) == (not plan.sharded)
            if plan.bank_sharded:
                assert plan.class_slice(shards - 1) == slice(
                    classes - plan.rows_per_shard, classes)
            if plan.batch_sharded:
                assert plan.batch_slice(batch, 1) == slice(batch // dp,
                                                           2 * batch // dp)
        # a backend that declines bank sharding keeps the bank replicated
        plan, _ = tmatch.plan_for(batch=256, num_classes=512,
                                  bank_shardable=False)
        assert plan.bank_shards == 1
    assert tmatch.plan_for(batch=4, num_classes=4) == (tmatch.REPLICATED,
                                                       None)
    assert tmatch.bank_shards_in_mesh() == 1


def test_forcemesh_and_serving_mesh_match_jax(monkeypatch):
    for bad in ("2", "axb", "0x2", "2x-1"):
        with pytest.raises(ValueError) as jerr:
            jforcemesh.parse(bad)
        with pytest.raises(ValueError) as terr:
            forcemesh.parse(bad)
        assert str(terr.value) == str(jerr.value)
    assert forcemesh.ENV == jforcemesh.ENV
    monkeypatch.setenv("REPRO_FORCE_MESH", "2X4")
    assert forcemesh.env_spec() == jforcemesh.env_spec() == (2, 4)
    # the env asks for a forced list of the caller's device; installing
    # makes it the device list until clear()
    assert context.devices("cpu") == [torch.device("cpu")] * 8
    mesh = tmesh.make_serving_mesh(bank_shards=4, device="cpu")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.virtual
    monkeypatch.delenv("REPRO_FORCE_MESH")
    assert context.devices("cpu") == [torch.device("cpu")]
    # no fallback: one device never holds two shards unasked, and the
    # error is the JAX package's (whose jax runs one CPU device here)
    with pytest.raises(ValueError) as jerr:
        jmesh.make_serving_mesh(bank_shards=2)
    with pytest.raises(ValueError) as terr:
        tmesh.make_serving_mesh(bank_shards=2, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert not tmesh.make_host_mesh().virtual
    assert forcemesh.install() is None  # nothing requested
    assert context.get_mesh() is None
    forcemesh.install((1, 3), device="cpu")
    assert context.devices() == [torch.device("cpu")] * 3
    context.clear()
    assert context.get_mesh() is None


# ---------------------------------------------------------------------------
# the merges
# ---------------------------------------------------------------------------

def test_argmax_nan_and_tie_order_is_jnps():
    """The merges assume `torch.argmax` ranks as `jnp.argmax` does: the
    first NaN wins, ties go to the first index, all -inf gives 0
    (chip_smoke's `sh_argmax_probe` checks the card)."""
    nan, inf = float("nan"), float("inf")
    rows = np.array([[1.0, nan, 3.0, nan], [2.0, 5.0, 5.0, 1.0],
                     [-inf] * 4, [nan] * 4, [-inf, 0.0, 0.0, -inf]],
                    np.float32)
    got = to_np(torch.argmax(torch.from_numpy(rows), dim=-1))
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(rows, -1)))
    np.testing.assert_array_equal(got, [1, 1, 0, 0, 1])


def _partials(rng, shards, b, rows):
    """Per-shard (per_class, windows) with ties planted across shard edges:
    integer scores 0..5, so equal tops in two shards are common."""
    pc = rng.integers(0, 6, size=(b, shards * rows)).astype(np.float32)
    pc[rng.random(pc.shape) < 0.05] = -np.inf
    edge = rows * rng.integers(1, shards, size=b)
    pc[np.arange(b), edge - 1] = pc[np.arange(b), edge] = 7.0  # edge ties
    lo = rng.integers(0, shards * rows, size=b)
    hi = np.minimum(lo + rng.integers(0, 3 * rows, size=b), shards * rows)
    lo[:2], hi[:2] = (edge[0] - 1, 5), (edge[0] + 1, 5)  # straddle, empty
    return pc, lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("shards", [2, 4, 8])
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_merges_match_a_replicated_argmax(shards, seed):
    """tree == all-gather == the windowed argmax over all classes
    (`windowed_margin`), pred and margin, with ties on shard edges."""
    from repro_torch.kernels.layout import windowed_margin

    for s in range(seed, seed + 4):
        rng = np.random.default_rng(s)
        rows = 5
        pc, lo, hi = _partials(rng, shards, 16, rows)
        per_class, lo_t, hi_t = (torch.from_numpy(pc), torch.from_numpy(lo),
                                 torch.from_numpy(hi))
        want = windowed_margin(per_class, lo_t[:, None], hi_t[:, None], 7.0)
        parts = [tmatch.shard_window_top2(
            per_class[:, i * rows:(i + 1) * rows], lo_t, hi_t, i * rows)
            for i in range(shards)]
        winners = [(torch.amax(per_class[:, i * rows:(i + 1) * rows], -1),
                    torch.argmax(per_class[:, i * rows:(i + 1) * rows],
                                 -1).to(torch.int32) + i * rows)
                   for i in range(shards)]
        for strat in ("allgather", "tree"):
            got = tengine._reduce_margin(parts, 7.0, strat)
            assert_equal_outputs(got, want, ("pred", "margin"))
            _, pred = tengine._reduce_winner(winners, strat)
            np.testing.assert_array_equal(
                to_np(pred), to_np(torch.argmax(per_class, -1)))


# ---------------------------------------------------------------------------
# the engine under forced meshes: feature count, bit for bit
# ---------------------------------------------------------------------------

def _problem(seed=0, c=C, k=K, n=N, b=B):
    rng = np.random.default_rng(seed)
    templates = (rng.random((c, k, n)) > 0.5).astype(np.float32)
    valid = rng.random((c, k)) < 0.9
    valid[c - 1] = False
    bank = (templates, np.zeros_like(templates), np.ones_like(templates),
            valid, (rng.standard_normal(n) * 0.1).astype(np.float32))
    feats = rng.standard_normal((b, n)).astype(np.float32)
    lo = rng.integers(0, c - 8, size=b)
    hi = np.minimum(lo + rng.integers(1, 96, size=b), c)
    # windows edging and straddling every 1x2 / 1x4 / 1x8 shard boundary,
    # and an empty one (pred 0, margin 0)
    lo[:6], hi[:6] = (c // 2 - 8, c // 2, c // 4 - 3, 0, c // 8 - 1, 7), \
        (c // 2, c // 2 + 40, 3 * c // 4 + 3, c, c // 8 + 1, 7)
    thr = (rng.standard_normal((T, n)) * 0.1).astype(np.float32)
    slot = rng.integers(0, T, size=b).astype(np.int32)
    tau = rng.uniform(0, 12, size=b).astype(np.float32)
    return dict(bank=bank, feats=feats, lo=lo.astype(np.int32),
                hi=hi.astype(np.int32), thr=thr, slot=slot, tau=tau)


def _calls(eng, p, lib, bank_cls):
    asarr = (lambda x: torch.from_numpy(np.array(x))) if lib == "torch" \
        else jnp.asarray
    bank = bank_cls(*(asarr(x) for x in p["bank"]))
    f, lo, hi = asarr(p["feats"]), asarr(p["lo"]), asarr(p["hi"])
    q = asarr((p["feats"] > 0).astype(np.float32))
    return {
        "classify": eng.classify(q, bank),
        "classify_features": eng.classify_features(f, bank),
        "classify_features_margin": eng.classify_features_margin(
            f, bank, lo, hi),
        # the serve tick's bank is a registry super-bank: zero thresholds
        # (each row's tenant thresholds come from the table)
        "classify_serve": eng.classify_serve(
            f, asarr(p["thr"]), asarr(p["slot"]),
            bank._replace(thresholds=bank.thresholds * 0), lo, hi,
            asarr(p["tau"])),
    }


@pytest.fixture(scope="module")
def feature_count():
    p = _problem()
    jax_rep = {k: tuple(to_np(x) for x in v) for k, v in _calls(
        jmatch.engine_for(backend="kernel"), p, "jax", JBank).items()}
    tor_rep = _calls(tmatch.engine_for(backend="kernel"), p, "torch", TBank)
    return p, jax_rep, tor_rep


def test_replicated_port_matches_jax(feature_count):
    _, jax_rep, tor_rep = feature_count
    for name in jax_rep:
        assert_equal_outputs(tor_rep[name], jax_rep[name])
    esc = jax_rep["classify_serve"][3]
    assert esc.any() and not esc.all()


@pytest.mark.parametrize("strategy", ["allgather", "tree"])
@pytest.mark.parametrize("shape", MESHES)
def test_engine_sharded_bit_identical(feature_count, shape, strategy,
                                      monkeypatch):
    p, jax_rep, tor_rep = feature_count
    monkeypatch.setenv("REPRO_REDUCE_STRATEGY", strategy)
    eng = tmatch.engine_for(backend="kernel")
    with port_mesh(shape):
        plan, _ = tmatch.plan_for(batch=B, num_classes=C)
        assert plan.bank_shards == shape[1]
        assert plan.dp_devices == shape[0]
        assert plan.reduce == tmatch.reduce_strategy(shape[1])
        got = _calls(eng, p, "torch", TBank)
    for name in got:
        assert_equal_outputs(got[name], tor_rep[name])
        assert_equal_outputs(got[name], jax_rep[name])


def test_big_bank_past_the_fused_budget_on_each_shard():
    """2,304 classes x K 2 at 1x2: 1,152 rows a shard, 2,304 fused rows
    past `MAX_FUSED_ROWS`, so each shard takes the chunked kernel path."""
    from repro_torch.kernels import layout

    p = _problem(seed=3, c=2304, k=2, n=128, b=32)
    assert 2 * layout.padded_classes(2304 // 2) > tmatch.MAX_FUSED_ROWS
    want = {k: tuple(to_np(x) for x in v) for k, v in _calls(
        jmatch.engine_for(backend="kernel"), p, "jax", JBank).items()}
    eng = tmatch.engine_for(backend="kernel")
    rep = _calls(eng, p, "torch", TBank)
    with port_mesh((1, 2)):
        got = _calls(eng, p, "torch", TBank)
    for name in want:
        assert_equal_outputs(rep[name], want[name])
        assert_equal_outputs(got[name], want[name])


def test_batch_only_plan_runs_the_replicated_entry_point_per_slice(
        feature_count, monkeypatch):
    """A (2, 1) mesh cuts the batch and keeps the bank whole: each slice
    runs the unsharded `classify_serve` (one B3 serve kernel a slice)."""
    from repro_torch.match import backends

    p, _, tor_rep = feature_count
    calls = []
    orig = backends.KernelBackend.classify_serve

    def counting(self, f, *a):
        calls.append(f.shape[0])
        return orig(self, f, *a)

    monkeypatch.setattr(backends.KernelBackend, "classify_serve", counting)
    with port_mesh((2, 1)):
        got = _calls(tmatch.engine_for(backend="kernel"), p, "torch", TBank)
    assert calls == [B // 2, B // 2]
    for name in got:
        assert_equal_outputs(got[name], tor_rep[name])


# ---------------------------------------------------------------------------
# similarity, the raw scores, the device backend
# ---------------------------------------------------------------------------

def _sim_problem(seed=5, c=64, k=2, n=100, b=32):
    rng = np.random.default_rng(seed)
    lower, upper = dyadic_windows(rng, c, k, n)
    valid = rng.random((c, k)) < 0.9
    templates = (rng.random((c, k, n)) > 0.5).astype(np.float32)
    bank = (templates, lower, upper, valid, np.zeros(n, np.float32))
    p = _problem(seed=seed, c=c, k=k, n=n, b=b)
    p["bank"] = bank
    p["feats"] = (rng.integers(-8, 9, size=(b, n)) / 4).astype(np.float32)
    return p


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_similarity_sharded_bit_identical(shape):
    p = _sim_problem()
    want = {k: tuple(to_np(x) for x in v) for k, v in _calls(
        jmatch.engine_for(method="similarity", alpha=0.37,
                          backend="kernel"), p, "jax", JBank).items()}
    eng = tmatch.engine_for(method="similarity", alpha=0.37,
                            backend="kernel")
    with port_mesh(shape):
        got = _calls(eng, p, "torch", TBank)
    for name in want:
        assert_equal_outputs(got[name], want[name])


def test_raw_scores_sharded():
    p = _sim_problem(c=32, n=64, b=8)
    tm, lo, hi, valid, _ = (torch.from_numpy(np.array(x))
                           for x in p["bank"])
    q = torch.from_numpy((p["feats"] > 0).astype(np.float32))
    f = torch.from_numpy(p["feats"])
    fc = tmatch.engine_for(backend="kernel")
    sim = tmatch.engine_for(method="similarity", backend="kernel")
    bank = TBank(tm, lo, hi, valid, torch.zeros(64))
    want = (fc.feature_count_scores(q, tm, valid),
            sim.similarity_scores(f, lo, hi), sim.scores(f, bank))
    with port_mesh((2, 4)):
        got = (fc.feature_count_scores(q, tm, valid),
               sim.similarity_scores(f, lo, hi), sim.scores(f, bank))
    assert_equal_outputs(got, want, ("fc", "sim", "scores"))


@pytest.mark.parametrize("cell", ["6T4R", "3T1R"])
def test_device_backend_sigma0_and_per_shard(cell):
    p = _problem(seed=9, c=32, k=2, n=64, b=16)
    bank = TBank(*(torch.from_numpy(np.array(x)) for x in p["bank"]))
    f = torch.from_numpy(p["feats"])
    lo, hi = torch.from_numpy(p["lo"] % 32), torch.from_numpy(p["hi"] % 33)
    ideal = tmatch.engine_for(backend="device",
                              device=tacam.ACAMConfig(cell=cell))
    want = (ideal.classify_features(f, bank),
            ideal.classify_features_margin(f, bank, lo, hi))
    with port_mesh((1, 4)):
        got = (ideal.classify_features(f, bank),
               ideal.classify_features_margin(f, bank, lo, hi))
    assert_equal_outputs(got[0], want[0], ("pred", "per_class"))
    assert_equal_outputs(got[1], want[1])

    noisy = tmatch.engine_for(
        backend="device", device=tacam.ACAMConfig(cell=cell,
                                                  sigma_program=0.05),
        seed=7, device_noise="per_shard")
    be = noisy.backend(f, bank)
    key = tacam.prng_key(7)
    for shards in (2, 4):
        want = be.classify_features_keyed(f, bank, key, bank_shards=shards)
        with port_mesh((1, shards)):
            got = noisy.classify_features(f, bank)
            swept = noisy.sweep_program_noise(f, bank, [key], device="cpu")
        assert_equal_outputs(got, want, ("pred", "per_class"))
        assert_equal_outputs((swept[0][0], swept[1][0]), want,
                             ("pred", "per_class"))
    # "global" noise declines bank sharding: the plan keeps the bank whole
    glob = tmatch.engine_for(backend="device", device=tacam.ACAMConfig(
        cell=cell, sigma_program=0.05), seed=7)
    assert not glob.backend(f, bank).supports_bank_sharding
    want = glob.classify_features(f, bank)
    with port_mesh((1, 4)):
        assert_equal_outputs(glob.classify_features(f, bank), want,
                             ("pred", "per_class"))


# ---------------------------------------------------------------------------
# JAX's own sharded path, in one subprocess
# ---------------------------------------------------------------------------

_NAN_T = [[1.0, 5.0, float("nan")], [2.0, 1.0, 1.0],
          [float("nan"), 3.0, 2.0], [9.0, 9.0, 9.0]]
_NAN_I = [[0, 1, 2], [16, 17, 18], [32, 33, 34], [48, 49, 50]]


def _nan_similarity_problem():
    rng = np.random.default_rng(11)
    c, k, n, b = 64, 2, 32, 8
    lower = (rng.integers(0, 4, size=(c, k, n)) / 4).astype(np.float32)
    upper = lower + 0.5
    lower[40, 1, 7] = np.nan  # NaN scores for class 40: shard 2 of 1x4
    valid = np.ones((c, k), bool)
    templates = (rng.random((c, k, n)) > 0.5).astype(np.float32)
    feats = (rng.integers(0, 5, size=(b, n)) / 4).astype(np.float32)
    return (templates, lower, upper, valid, np.zeros(n, np.float32)), feats


@pytest.fixture(scope="module", autouse=True)
def _jax_job(tmp_path_factory):
    """JAX's sharded runs, started with the module so they overlap the
    port's tests; `jax_sharded` collects them."""
    bank, feats = _nan_similarity_problem()
    sim = _sim_problem(c=64, n=100, b=16)
    path = tmp_path_factory.mktemp("jax_sharded") / "inputs.npz"
    np.savez(path, **{f"nan_bank{j}": x for j, x in enumerate(bank)},
             nan_feats=feats,
             **{f"sim_bank{j}": x for j, x in enumerate(sim["bank"])},
             sim_feats=sim["feats"], sim_lo=sim["lo"], sim_hi=sim["hi"],
             t=np.array(_NAN_T, np.float32), i=np.array(_NAN_I, np.int32))
    return JaxJob(f"""
        import json, os
        import jax, jax.numpy as jnp, numpy as np
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro import match
        from repro.core.templates import TemplateBank
        from repro.distributed import context
        from repro.match import engine as E

        z = np.load({str(path)!r})
        out = {{}}
        mesh = jax.make_mesh((1, 4), ("data", "model"))
        for strat in ("allgather", "tree"):
            f = shard_map(
                lambda tt, ii: E._reduce_winner(tt[0], ii[0], "model", 4,
                                                strat)[1],
                mesh=mesh, in_specs=(P("model"), P("model")),
                out_specs=P(None), check_rep=False)
            out["reduce_" + strat] = np.asarray(
                f(jnp.asarray(z["t"]), jnp.asarray(z["i"]))).tolist()

        def run(bank, feats, eng, lo=None, hi=None):
            m = eng.classify_features_margin(feats, bank, lo, hi)
            return [np.asarray(x).tolist() for x in m]

        nb = TemplateBank(*(jnp.asarray(z[f"nan_bank{{j}}"])
                            for j in range(5)))
        sb = TemplateBank(*(jnp.asarray(z[f"sim_bank{{j}}"])
                            for j in range(5)))
        nf, sf = jnp.asarray(z["nan_feats"]), jnp.asarray(z["sim_feats"])
        slo, shi = jnp.asarray(z["sim_lo"]), jnp.asarray(z["sim_hi"])
        eng = match.engine_for(method="similarity", alpha=0.37,
                               backend="reference")
        out["nan_replicated"] = run(nb, nf, eng)
        for strat in ("allgather", "tree"):
            os.environ["REPRO_REDUCE_STRATEGY"] = strat
            context.set_mesh_axes("data", "model", mesh)
            out["nan_" + strat] = run(nb, nf, eng)
            out["sim_" + strat] = run(sb, sf, eng, slo, shi)
            context.clear()
        print("OUT", json.dumps(out))
        """, ndev=4)


@pytest.fixture(scope="module")
def jax_sharded(_jax_job):
    return _jax_job.result()


def test_merge_nan_semantics_are_jaxs_sharded_path(jax_sharded):
    """A NaN partial never wins a merge it challenges and keeps winning
    one it holds; the tree's result is rank 0's. Pinned against JAX's
    `shard_map` reduce on four host devices."""
    t = torch.tensor(_NAN_T)
    i = torch.tensor(_NAN_I, dtype=torch.int32)
    parts = [(t[s], i[s]) for s in range(4)]
    for strat in ("allgather", "tree"):
        _, pred = tengine._reduce_winner(parts, strat)
        assert to_np(pred).tolist() == jax_sharded["reduce_" + strat]
    # the two strategies differ on NaN partials (rank 2's NaN eliminates
    # shard 3 in the butterfly), and neither is the replicated argmax
    assert jax_sharded["reduce_allgather"][0] == 48
    assert jax_sharded["reduce_tree"][0] == 16


def _as_lists(outs):
    return [to_np(x).tolist() for x in outs]


def _same_nan(a, b):
    np.testing.assert_array_equal(np.array(a, np.float64),
                                  np.array(b, np.float64))


@pytest.mark.parametrize("strategy", ["allgather", "tree"])
def test_sharded_engine_matches_jax_sharded(jax_sharded, strategy,
                                            monkeypatch):
    """The similarity engine at 1x4 against JAX's `shard_map` execution
    (its reference backend; the kernel backend's bits are the same):
    NaN-bound banks (the sharded semantics, not the replicated argmax's)
    and straddling windows on dyadic banks."""
    monkeypatch.setenv("REPRO_REDUCE_STRATEGY", strategy)
    bank, feats = _nan_similarity_problem()
    tbank = TBank(*(torch.from_numpy(np.array(x)) for x in bank))
    sim = _sim_problem(c=64, n=100, b=16)
    sbank = TBank(*(torch.from_numpy(np.array(x)) for x in sim["bank"]))
    eng = tmatch.engine_for(method="similarity", alpha=0.37,
                            backend="kernel")
    f = torch.from_numpy(feats)
    sf = torch.from_numpy(sim["feats"])
    slo, shi = torch.from_numpy(sim["lo"]), torch.from_numpy(sim["hi"])
    rep = _as_lists(eng.classify_features_margin(f, tbank))
    with port_mesh((1, 4)):
        nan_got = _as_lists(eng.classify_features_margin(f, tbank))
        sim_got = _as_lists(eng.classify_features_margin(sf, sbank, slo,
                                                         shi))
        # classify_features merges the same way: its pred is the margin
        # call's over the whole class range
        np.testing.assert_array_equal(
            to_np(eng.classify_features(f, tbank)[0]), nan_got[0])
    for a, b in zip(nan_got, jax_sharded["nan_" + strategy]):
        _same_nan(a, b)
    for a, b in zip(sim_got, jax_sharded["sim_" + strategy]):
        _same_nan(a, b)
    for a, b in zip(rep, jax_sharded["nan_replicated"]):
        _same_nan(a, b)
    # the replicated argmax takes the first NaN class; the sharded merge
    # does not, for the queries whose first NaN sits past shard 0
    assert rep[0] != nan_got[0]
