"""The port's Hopper tuning table (`repro_torch.kernels.tuning`), as
`tests/test_matching_dispatch.py::TestTuning` holds the JAX package's:
the cache file from the environment, its version gate and key format, the
defaults (the designs the kernels took before the table), autotune's
persisted winner, and the wrappers' ``block`` override."""
import json
import time

import numpy as np
import pytest
import torch

from _torch_parity import binary_windows, t
from repro_torch.kernels import tuning
from repro_torch.kernels.acam_match import acam_match as am
from repro_torch.kernels.acam_match import ops as match_ops
from repro_torch.kernels.acam_similarity import acam_similarity as asim
from repro_torch.kernels.acam_similarity import ops as sim_ops

F32 = torch.float32


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "sub" / "blocks.json"
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(path))
    tuning.clear_cache_for_tests()
    yield path
    tuning.clear_cache_for_tests()


def test_cache_path_from_the_environment(cache, monkeypatch):
    assert tuning.cache_path() == str(cache)
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE")
    monkeypatch.setenv("HOME", "/home/someone")
    assert tuning.cache_path() == \
        "/home/someone/.cache/repro_torch/hopper_blocks.json"


def test_key_format():
    assert tuning.shape_key(256, 10, 784) == "b256_m10_n784"
    assert tuning.entry_key("acam_match", (256, 10, 784), F32, "cpu") == \
        "acam_match|cpu|b256_m10_n784|float32"
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        assert tuning.platform("cuda:0") == f"cuda:sm_{major}{minor}"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tuning.platform()  # the card unless the caller asks for the CPU


@pytest.mark.parametrize("version", [tuning.CACHE_VERSION, 0, None])
def test_version_gate(cache, version):
    """Entries of another version are never read; a broken file reads as
    empty."""
    key = tuning.entry_key("acam_match", (4, 40, 64), F32, "cpu")
    cache.parent.mkdir(parents=True)
    body = {"entries": {key: {"block": "cooperative", "us": 1.0}}}
    if version is not None:
        body["version"] = version
    cache.write_text(json.dumps(body))
    got = tuning.get_block("acam_match", (4, 40, 64), F32, "cpu")
    assert got == ("cooperative" if version == tuning.CACHE_VERSION
                   else "local" if 40 <= am.LOCAL_ROWS else "cooperative")
    cache.write_text("{not json")
    tuning.clear_cache_for_tests()
    assert tuning.get_block("acam_match", (4, 3, 64), F32, "cpu") == "local"


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("c", [1, 4, 5, 8, 9, 16, 17])
def test_empty_cache_takes_todays_design(cache, k, c):
    """B7a over a flattened (C K, N) bank: local up to `LOCAL_ROWS` rows,
    cooperative past it, as `_scratch` picked before the table; B5 / B6
    follow the same rule."""
    rows = k * c
    want = "local" if rows <= am.LOCAL_ROWS else "cooperative"
    assert tuning.get_block("acam_match", (64, rows, 784), F32,
                            "cpu") == want
    assert am.tiled_design(rows) == want
    cp = -(-rows // am.CLASS_TILE) * am.CLASS_TILE
    assert (am._scratch(64, 784, 1, cp, rows, raw=True) == 0) == (
        want == "local")
    assert (asim.scratch_words(64, 784, k, 32, c) == 0) == (want == "local")


@pytest.mark.parametrize("b,m", [(256, 10), (1, 10), (64, 2200), (8, 2200),
                                 (33, 1056), (32, 1056), (4096, 10),
                                 (2048, 32)])
def test_empty_cache_takes_todays_b7b_tiling(cache, b, m):
    """B7b wide where its 8 x 16 grid gives two blocks an SM (the rule the
    C entry applies for tiling -1), narrow otherwise; on the CPU key the
    H100's 132 SMs."""
    blocks = -(-b // 8) * -(-m // 16)
    want = "wide" if blocks >= 2 * tuning.H100_SMS else "narrow"
    assert tuning.get_block("acam_similarity", (b, m, 784), F32,
                            "cpu") == want
    assert tuning.default_block("acam_similarity", (b, m, 784), "cpu") == \
        want


def test_candidates_are_the_legal_designs():
    assert tuning.candidates("acam_match", (1, 10, 784)) == \
        ["local", "cooperative"]
    assert tuning.candidates("acam_similarity", (256, 2200, 784)) == \
        ["narrow", "wide"]
    assert tuning.candidates("acam_similarity", (0, 10, 784)) == []
    with pytest.raises(ValueError, match="no tuning table"):
        tuning.candidates("kd_loss", (1, 1, 1))


def test_autotune_persists_the_fastest(cache):
    """A fake kernel whose local design sleeps: autotune checks each
    candidate against the plain output, persists the faster design with
    its time, and the lookup returns it; other shapes keep the default."""
    shape = (64, 40, 784)
    plain = torch.arange(6, dtype=F32)
    calls = []

    def run(block):
        calls.append(block)
        if block == "local":
            time.sleep(0.003)
        return plain.clone()

    times = {}
    best = tuning.autotune("acam_match", shape, F32, run, plain=plain,
                           iters=3, times=times)
    assert best == "cooperative" and set(calls) == {"local", "cooperative"}
    assert times["local"] > times["cooperative"]
    tuning.clear_cache_for_tests()
    assert tuning.get_block("acam_match", shape, F32, "cpu") == "cooperative"
    saved = json.loads(cache.read_text())
    assert saved["version"] == tuning.CACHE_VERSION
    entry = saved["entries"]["acam_match|cpu|b64_m40_n784|float32"]
    assert entry["block"] == "cooperative" and entry["us"] == \
        times["cooperative"]
    assert tuning.get_block("acam_match", (8, 8, 8), F32, "cpu") == "local"
    assert not list(cache.parent.glob("*.tmp.*"))  # the rename took it


def test_autotune_raises_on_a_candidate_that_differs(cache):
    plain = torch.zeros(4)

    def run(block):
        return plain + (block == "wide")

    with pytest.raises(RuntimeError, match="wide"):
        tuning.autotune("acam_similarity", (4, 4, 4), F32, run, plain=plain,
                        iters=1)
    assert not cache.exists()


def test_autotune_acam_on_the_cpu(cache):
    """The search over both kernels at a small shape, on the CPU's plain
    versions (every candidate the same code, bit-identical to itself)."""
    times = {}
    out = tuning.autotune_acam([(3, 5, 40)], iters=1, device="cpu",
                               times=times)
    assert set(out) == {"acam_match|cpu|b3_m5_n40|float32",
                        "acam_similarity|cpu|b3_m5_n40|float32"}
    assert out["acam_match|cpu|b3_m5_n40|float32"] in ("local",
                                                       "cooperative")
    assert set(times["acam_similarity|cpu|b3_m5_n40|float32"]) == \
        {"narrow", "wide"}


def test_explicit_block_overrides_the_cache(cache):
    key = tuning.entry_key("acam_match", (4, 10, 64), F32, "cpu")
    cache.parent.mkdir(parents=True)
    cache.write_text(json.dumps({"version": tuning.CACHE_VERSION, "entries": {
        key: {"block": "cooperative", "us": 1.0}}}))
    cpu = torch.device("cpu")
    shape = (4, 10, 64)
    assert tuning.resolve_block("acam_match", shape, F32, cpu,
                                None) == "cooperative"
    assert tuning.resolve_block("acam_match", shape, F32, cpu,
                                "local") == "local"
    assert tuning.resolve_block("acam_similarity", shape, F32, cpu,
                                "wide") == "wide"
    # memoised per LOCAL_ROWS: forcing the rule still reaches the default
    assert tuning.resolve_block("acam_match", (4, 40, 64), F32, cpu,
                                None) == "cooperative"
    keep = am.LOCAL_ROWS
    try:
        am.LOCAL_ROWS = 1 << 30
        assert tuning.resolve_block("acam_match", (4, 40, 64), F32, cpu,
                                    None) == "local"
    finally:
        am.LOCAL_ROWS = keep
    assert am.tiled_design(100, "local") == "local"


def test_unknown_block_raises():
    """Every wrapper that takes ``block`` refuses a name it does not know,
    on the CPU too, before any work."""
    rng = np.random.default_rng(0)
    f = t(rng.standard_normal((3, 40)).astype(np.float32))
    thr = torch.zeros(40)
    tmpl = (torch.rand(5, 40) > 0.5).float()
    lo, hi = (t(w) for w in binary_windows(rng, 2, 1, 40))
    valid = torch.ones((2, 1), dtype=torch.bool)
    for call in (
            lambda: match_ops.match_scores(f, thr, tmpl, block="wide"),
            lambda: am.acam_match(f, thr, tmpl, block=(128, 128, 512)),
            lambda: sim_ops.similarity_scores(f, lo[:, 0], hi[:, 0],
                                              block="local"),
            lambda: sim_ops.classify_fused(f, thr, lo, hi, valid,
                                           block="narrow"),
            lambda: sim_ops.classify_fused_margins(f, thr, lo, hi, valid,
                                                   max_rows=64, block="x")):
        with pytest.raises(ValueError, match="design"):
            call()
    # a known name runs (the plain version, on the CPU)
    np.testing.assert_array_equal(
        match_ops.match_scores(f, thr, tmpl, block="cooperative").numpy(),
        am.match_plain(f, thr, tmpl).numpy())
    assert sim_ops.classify_fused(f, thr, lo, hi, valid,
                                  block="cooperative")[0].shape == (3,)
