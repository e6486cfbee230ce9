"""The port's serving launcher against the JAX package's.

One similarity spec and one feature-count spec, written as files, boot the
multi-tenant service through `repro.launch.serve.main` and
`repro_torch.launch.serve.main(..., device="cpu")` with the same flags (3
synthetic tenants, N = 100). Both must report the same accuracy,
completed, escalated, classify_dispatches and escalation rate, and print the
same resolved spec; so must the flag-built service under ``--backend
device``. The ``lm`` and ``lm-cached`` workloads run. ``--bank-shards 2``
raises the JAX launcher's `ValueError` on one device and, under a forced
1x2 mesh, serves what the JAX launcher serves on two host devices.
"""
import numpy as np
import pytest

from _torch_parity import run_jax_sharded
from repro.launch import serve as jserve
from repro.match.config import EngineConfig
from repro.serve import spec as jspec
from repro_torch.launch import serve as tserve

N = 100
KEYS = ("accuracy", "completed", "escalated", "classify_dispatches",
        "escalation_rate")


def _spec_file(tmp_path, method, tau):
    spec = jspec.ServiceSpec(
        registry=jspec.RegistrySpec(num_features=N),
        engine=EngineConfig(method=method, alpha=0.37, backend="kernel",
                            margin=True),
        mesh=jspec.MeshSpec(install=False),
        scheduler=jspec.SchedulerSpec(slots=16),
        cascade=jspec.CascadeSpec(tau=tau, tau_units="count"))
    path = tmp_path / f"{method}.json"
    path.write_text(spec.to_json())
    return str(path)


@pytest.mark.parametrize("method,tau", [("similarity", 8.0),
                                        ("feature_count", 10.0)])
def test_launcher_matches_jax(tmp_path, capsys, method, tau):
    argv = ["--workload", "acam", "--spec", _spec_file(tmp_path, method, tau),
            "--tenants", "3", "--requests", "48", "--noise", "1.2",
            "--print-spec"]
    want = jserve.main(argv)
    jax_out = capsys.readouterr().out
    got = tserve.main(argv, device="cpu")
    torch_out = capsys.readouterr().out
    for key in KEYS:
        assert got[key] == want[key], key
    assert 0.0 < got["escalation_rate"] < 1.0
    assert len(got["responses"]) == 48
    assert all(r.error is None for r in got["responses"])
    # the resolved spec prints as the same JSON text, ahead of the metrics
    spec_j = jax_out[:jax_out.index("acam service:")]
    spec_t = torch_out[:torch_out.index("acam service:")]
    assert spec_t == spec_j and spec_t.startswith("{")


@pytest.fixture
def jax_mesh_cleared():
    """Without --spec the JAX launcher installs its serving mesh process-
    wide; clear it so later tests in this worker see none."""
    from repro.distributed import context

    yield
    context.clear()


def test_launcher_flags_build_the_same_spec(capsys, jax_mesh_cleared):
    argv = ["--workload", "acam", "--tenants", "2", "--requests", "8",
            "--features", str(N), "--slots", "8", "--backend", "kernel",
            "--margin-tau", "12", "--print-spec"]
    want = jserve.main(argv)
    jax_out = capsys.readouterr().out
    got = tserve.main(argv, device="cpu")
    torch_out = capsys.readouterr().out
    assert torch_out.split("acam service:")[0] == \
        jax_out.split("acam service:")[0]
    for key in KEYS:
        assert got[key] == want[key], key


@pytest.mark.parametrize("noise", ["global", "per_shard"])
def test_backend_device_flag_matches_jax(capsys, jax_mesh_cleared, noise):
    """``--backend device`` (and ``--device-noise``) reach the spec's
    engine in both launchers; the RRAM-physics service serves the same
    requests with the same decisions, its count-unit tau rescaled to
    matchline fractions (14.5 counts: between two count steps)."""
    argv = ["--workload", "acam", "--tenants", "2", "--requests", "24",
            "--features", str(N), "--slots", "8", "--backend", "device",
            "--device-noise", noise, "--margin-tau", "14.5", "--noise", "1.2",
            "--print-spec"]
    want = jserve.main(argv)
    jax_out = capsys.readouterr().out
    got = tserve.main(argv, device="cpu")
    torch_out = capsys.readouterr().out
    spec_t = torch_out.split("acam service:")[0]
    assert spec_t == jax_out.split("acam service:")[0]
    assert '"backend": "device"' in spec_t and f'"{noise}"' in spec_t
    for key in KEYS:
        assert got[key] == want[key], key
    assert 0.0 < got["escalation_rate"] < 1.0


SHARDED_ARGV = ["--workload", "acam", "--bank-shards", "2", "--tenants",
                "3", "--requests", "48", "--slots", "16", "--noise", "1.2",
                "--print-spec"]


@pytest.mark.parametrize("flags,match", [
    (["--workload", "acam", "--bank-shards", "2"],
     "must divide the 1 available devices"),
])
def test_unported_flags_raise(flags, match, capsys, monkeypatch):
    """Once refused as unported, ``--bank-shards 2`` now shards: without a
    forced mesh one CPU device cannot hold two shards (the JAX launcher's
    `ValueError`, raised by both), and under ``REPRO_FORCE_MESH=1x2`` the
    port serves what the JAX launcher serves on two host devices."""
    from repro_torch.distributed import context

    monkeypatch.delenv("REPRO_FORCE_MESH", raising=False)
    with pytest.raises(ValueError, match=match):
        jserve.main(flags)
    with pytest.raises(ValueError, match=match):
        tserve.main(flags, device="cpu")
    want = run_jax_sharded(f"""
        import contextlib, io, json
        from repro.launch import serve
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = serve.main({SHARDED_ARGV!r})
        out = {{k: got[k] for k in {KEYS!r}}}
        out["stdout"] = buf.getvalue().split("acam service:")[0]
        print("OUT", json.dumps(out))
        """, ndev=2)
    capsys.readouterr()
    monkeypatch.setenv("REPRO_FORCE_MESH", "1x2")
    try:
        got = tserve.main(SHARDED_ARGV, device="cpu")
        assert context.get_mesh().shape == {"data": 1, "model": 2}
    finally:
        context.clear()
    torch_out = capsys.readouterr().out
    assert torch_out.split("acam service:")[0] == want["stdout"]
    assert "installed serving mesh model=2 (2 devices)" in torch_out
    for key in KEYS:
        assert got[key] == want[key], key


@pytest.mark.parametrize("workload,key,want", [("lm", "tokens", 8 * 16),
                                               ("lm-cached", "hits", 24)])
def test_lm_workloads_run(workload, key, want):
    """The LM workloads run (their counts against the JAX launcher's:
    `tests/test_torch_semantic_cache.py`)."""
    got = tserve.main(["--workload", workload], device="cpu")
    assert got[key] == want


def test_main_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--workload", "acam", "--tenants", "1", "--requests",
                     "2"])
    assert np.isfinite(tserve.main(
        ["--workload", "acam", "--tenants", "1", "--requests", "2"],
        device="cpu")["accuracy"])
