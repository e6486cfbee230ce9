"""The port's training launcher (`repro_torch.launch.train`) and its
checkpoints against the JAX package's, on the CPU.

Both launchers start from the same weights: the port's `lm.init_params` is
patched to carry JAX's ``init_params(PRNGKey(0))`` over
(`convert.lm_params_from_numpy`). The JAX launcher builds its one-device
mesh with `jax.make_mesh`, whose axes are Explicit by default in the JAX
installed here, and its layers' sharding hints then raise; the tests hand
it the Auto-axis mesh the code was written for
(`repro.launch.mesh.make_host_mesh` patched). Tolerances:
  * bf16, as the launchers run: the first step's loss within 2^-8
    relative (the bf16 loss tolerance of `test_torch_lm_train_bf16.py`;
    XLA compiles the JAX step, the port runs eagerly), the later ones
    within 2^-6 (the updates round differently in bf16; measured at most
    8.2e-4);
  * f32 (both packages' configs patched to f32): every step's loss within
    1e-5 relative (measured at most 4.3e-7), so ``--grad-accum 2`` (one
    update per microbatch) and ``--compress`` are held to their own
    losses: compression alone moves them by 2.5e-5 to 3.6e-4;
  * a checkpoint written by either launcher resumed by the other: the
    next losses within the f32 tolerance of the writer's uninterrupted run;
  * the port's own resume: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import to_np  # noqa: F401  (one torch thread per worker)
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.distributed import context as jmesh_ctx
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm

BF16_FIRST_RTOL = 2.0 ** -8
BF16_LATER_RTOL = 2.0 ** -6
F32_RTOL = 1e-5
SMOKE4 = ["--smoke", "--steps", "4"]


def _auto_host_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(autouse=True)
def jax_mesh_cleared():
    """The JAX launcher installs its mesh process-wide and clears it only
    when it returns; clear it after each test whatever happened, so later
    test files in this worker see none."""
    yield
    jmesh_ctx.clear()


@pytest.fixture
def launchers(monkeypatch):
    """The two launchers from the same (JAX) weights; ``f32(True)`` makes
    both packages' configs f32."""
    monkeypatch.setattr(jmesh, "make_host_mesh", _auto_host_mesh)
    jget, tget = jconfigs.get, tconfigs.get
    as_f32 = {"on": False}

    def jconfig(name, smoke=False):
        cfg = jget(name, smoke)
        return dataclasses.replace(cfg, dtype=jnp.float32) \
            if as_f32["on"] else cfg

    def tconfig(name, smoke=False):
        cfg = tget(name, smoke)
        return dataclasses.replace(cfg, dtype=torch.float32) \
            if as_f32["on"] else cfg

    def init_from_jax(key, cfg, *, device=None):
        jcfg = jconfig(next(a for a in tconfigs.ALIASES
                            if tget(a, smoke=True).name == cfg.name),
                       smoke=True)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        return convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device=device)

    monkeypatch.setattr(jconfigs, "get", jconfig)
    monkeypatch.setattr(tconfigs, "get", tconfig)
    monkeypatch.setattr(tlm, "init_params", init_from_jax)

    def f32(on: bool):
        as_f32["on"] = on

    return f32


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-vl-72b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_bf16_losses_match_the_jax_launcher(launchers, arch):
    argv = ["--arch", arch, *SMOKE4]
    want = jtrain.main(argv)
    got = ttrain.main(argv, device="cpu")
    assert set(want) <= set(got) and len(got["losses"]) == 4
    _close(got["losses"][0], want["losses"][0], BF16_FIRST_RTOL, "step 0")
    _close(got["losses"][1:], want["losses"][1:], BF16_LATER_RTOL)
    assert got["final_loss"] == got["losses"][-1]


@pytest.mark.parametrize("flags", [[], ["--grad-accum", "2"],
                                   ["--compress"]])
def test_f32_losses_match_the_jax_launcher(launchers, flags):
    launchers(True)
    argv = ["--arch", "tinyllama-1.1b", *SMOKE4, *flags]
    want = jtrain.main(argv)["losses"]
    _close(ttrain.main(argv, device="cpu")["losses"], want, F32_RTOL)


def test_checkpoints_resume_across_the_packages(launchers, tmp_path):
    """JAX writes step 1, the port resumes to 4; the port writes step 1,
    JAX resumes to 4: steps 2-3 as the writer's uninterrupted run."""
    launchers(True)
    base = ["--arch", "tinyllama-1.1b", "--smoke"]
    jax_full = jtrain.main([*base, "--steps", "4"])["losses"]
    port_full = ttrain.main([*base, "--steps", "4"], device="cpu")["losses"]
    _close(port_full, jax_full, F32_RTOL)

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtrain.main([*base, "--steps", "2", "--ckpt-dir", jdir])
    resumed = ttrain.main([*base, "--steps", "4", "--ckpt-dir", jdir,
                           "--resume"], device="cpu")["losses"]
    _close(resumed, jax_full[2:], F32_RTOL, "port from a JAX checkpoint")

    ttrain.main([*base, "--steps", "2", "--ckpt-dir", tdir], device="cpu")
    resumed = jtrain.main([*base, "--steps", "4", "--ckpt-dir", tdir,
                           "--resume"])["losses"]
    _close(resumed, port_full[2:], F32_RTOL, "JAX from a port checkpoint")


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """6 steps checkpointed every 3, then ``--resume`` to 8: steps 6-7
    equal an uninterrupted 8-step run's, bit for bit."""
    base = ["--arch", "hymba-1.5b", "--smoke", "--batch", "2", "--seq",
            "16"]
    full = ttrain.main([*base, "--steps", "8"], device="cpu")["losses"]
    d = str(tmp_path / "ckpt")
    first = ttrain.main([*base, "--steps", "6", "--ckpt-every", "3",
                         "--ckpt-dir", d], device="cpu")["losses"]
    assert first == full[:6]
    assert ttrain.main([*base, "--steps", "8", "--ckpt-dir", d,
                        "--resume"], device="cpu")["losses"] == full[6:]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hubert-xlarge",
                                  "qwen2-vl-72b"])
def test_synthetic_batch_is_the_jax_launchers(arch):
    cfg = jconfigs.get(arch, smoke=True)
    want = jtrain.synthetic_batch(cfg, 3, 8, 7)
    got = ttrain.synthetic_batch(tconfigs.get(arch, smoke=True), 3, 8, 7,
                                 device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), np.asarray(w).view(np.int16)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), k)


@pytest.mark.parametrize("arch", tuple(tconfigs.ALIASES))
def test_params_to_numpy_inverts_from_numpy(arch):
    """`lm_params_to_numpy` after `lm_params_from_numpy` is the identity
    on the JAX tree, every leaf in its own dtype (bf16 included), and the
    optimizer state maps both ways."""
    jcfg, tcfg = jconfigs.get(arch, smoke=True), tconfigs.get(arch,
                                                             smoke=True)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(1),
                                                    jcfg))
    model = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    back = convert.lm_params_to_numpy(model, tcfg)
    want, got = convert.flatten_tree(tree), convert.flatten_tree(back)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      w.view(np.uint8), k)
    named = {k: p.detach() for k, p in model.named_parameters()}
    opt = tsteps.make_optimizer(tcfg)
    grads = {k: torch.full_like(p, 0.5) for k, p in named.items()}
    _, state = opt.update(grads, opt.init(named), named)
    tree = convert.lm_opt_state_tree(state)
    assert tree.mu.keys() == convert.nest(want).keys()
    back = convert.lm_opt_state_untree(tree)
    assert int(back.step) == 1 and back.mu.keys() == named.keys()
    for k in named:
        assert torch.equal(back.mu[k], state.mu[k])
        assert torch.equal(back.nu[k], state.nu[k])
