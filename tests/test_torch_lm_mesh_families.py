"""The LM zoo on a mesh, continued: the port's sharded step builders
against the JAX package's sharded ones for the MLA + sigmoid-MoE
(deepseek-v3 with 16 experts), SSM (mamba2) and hybrid (hymba) SMOKE
configs on a forced 2x4 mesh, on the CPU (the oracle and the tolerances:
`_torch_mesh`).
"""
import numpy as np
import pytest
from _torch_mesh import (check_serve_steps, check_train_step,
                         mesh24 as make_mesh24, start_oracle)

from repro_torch.distributed import context

CASES = {
    "deepseek": ("deepseek-v3-671b", {"n_experts": 16}),
    "mamba": ("mamba2-2.7b", {}),
    "hymba": ("hymba-1.5b", {}),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_job(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_lm_mesh_families") / "out.npz"
    return start_oracle(CASES, path), path


@pytest.fixture(scope="module")
def jax_out(_jax_job):
    job, path = _jax_job
    job.result(timeout=900)
    return dict(np.load(path))


@pytest.fixture
def mesh24():
    yield make_mesh24()
    context.clear()


@pytest.mark.parametrize("name", CASES)
def test_train_step_matches_jaxs_sharded_step(name, jax_out, mesh24):
    check_train_step(jax_out, name, CASES, mesh24)


@pytest.mark.parametrize("name", CASES)
def test_prefill_and_decode_match_jaxs_sharded_steps(name, jax_out, mesh24):
    check_serve_steps(jax_out, name, CASES, mesh24)
