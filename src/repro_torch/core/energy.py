"""Energy model (paper §V-D), Horowitz ISSCC'14 figures.

The paper's arithmetic:

    E_backend  = N_templates x N_features x E_cell
               = 10 x 784 x 185 fJ = 1.45 nJ                      (Eq. 14)
    E_frontend = 4,749,174 effective ops -> 96.07 nJ
    E_teacher  = 3,858,551,808 ops       -> 78.06 uJ
    reduction ~= 792x

Unit-consistency note (recorded honestly): 96.07 nJ / 4,749,174 ops
= 20.23 fJ/op and 78.06 uJ / 3.859e9 ops = 20.23 fJ/op — i.e. the paper
applied the Horowitz figures "0.2 pJ mul + 0.03 pJ add + 20 pJ cache" as
*femto*joules. With true picojoule units the absolute energies are 1000x
larger (96 uJ front-end, 78 mJ teacher) but every ratio — including the
headline ~800x reduction — is unchanged. We expose both modes:
`paper_faithful=True` reproduces the printed numbers; False gives physical
Horowitz units.
"""
from __future__ import annotations

from typing import NamedTuple

# --- Horowitz energy/op table (J, physical) ---
E_MUL_8BIT = 0.2e-12
E_ADD_8BIT = 0.03e-12
E_MUL_FP32 = 3.7e-12
E_ADD_FP32 = 0.9e-12
E_CACHE_32KB = 20e-12
E_DRAM = 1.3e-9  # per 32-bit DRAM access (not charged by the paper's model)

#: effective per-op energy as the paper applied it (fJ where Horowitz says pJ)
PAPER_UNIT_SLIP = 1e-3

E_ACAM_CELL = 185e-15  # TXL-ACAM per-cell similarity-search energy (§III-B)


class EnergyReport(NamedTuple):
    frontend_j: float
    backend_j: float
    teacher_j: float

    @property
    def total_j(self) -> float:
        return self.frontend_j + self.backend_j

    @property
    def reduction(self) -> float:
        return self.teacher_j / self.total_j


def per_op_energy(*, bits: int = 8, mem_accesses_per_op: float = 1.0,
                  paper_faithful: bool = True) -> float:
    """Energy of one (MAC-ish) op: compute + charged cache traffic.

    The paper: "For each MAC operation, the computation energy is 0.23pJ and
    the memory access energy is 20pJ" — one 32KB-cache access per op.
    """
    if bits == 8:
        e = E_MUL_8BIT + E_ADD_8BIT
    elif bits == 32:
        e = E_MUL_FP32 + E_ADD_FP32
    else:
        raise ValueError(f"no Horowitz entry for {bits}-bit ops")
    e += mem_accesses_per_op * E_CACHE_32KB
    return e * (PAPER_UNIT_SLIP if paper_faithful else 1.0)


def backend_energy(n_templates: int, n_features: int, e_cell: float = E_ACAM_CELL) -> float:
    """Eq. 14 — this one is physically consistent as printed."""
    return n_templates * n_features * e_cell


def frontend_energy(effective_ops: int, *, paper_faithful: bool = True) -> float:
    return effective_ops * per_op_energy(bits=8, paper_faithful=paper_faithful)


def lm_decode_energy(active_params: int, tokens: int, *,
                     paper_faithful: bool = True) -> float:
    """Per-request LM decode cost, in the same op-energy model as §V-D.

    The semantic-cache router's "expensive backend" is a decode engine,
    not the paper's CNN; its cost model is the standard transformer
    inference count — 2 x N_active MACs per processed token (the forward
    half of the 6N rule; N_active = `ArchConfig.active_param_count()`, so
    MoE archs are charged for routed experts only) — priced at the same
    Horowitz per-op figure (and the same `paper_faithful` unit handling)
    as the front-end, so LM rows in the energy ledger are directly
    comparable to the Eq. 14 ACAM numbers. ``tokens`` should count every
    token the engine pushed through the stack for the request: prompt
    (prefill) + generated.
    """
    ops = 2 * int(active_params) * int(tokens)
    return ops * per_op_energy(bits=8, paper_faithful=paper_faithful)


def hybrid_report(
    *,
    student_macs: int = 23_785_120,
    sparsity: float = 0.80,
    softmax_layer_ops: int = 7_850,
    n_templates: int = 10,
    n_features: int = 784,
    teacher_ops: int = 3_858_551_808,
    paper_faithful: bool = True,
) -> EnergyReport:
    """The paper's §V-D arithmetic for the full hybrid classifier.

    effective ops = student_macs * (1 - sparsity) - softmax_layer_ops:
    pruned-weight MACs are skipped (80% sparsity) and the dense softmax
    head's 7,850 ops are removed, replaced by the ACAM back-end.
    """
    effective = int(round(student_macs * (1.0 - sparsity))) - softmax_layer_ops
    return EnergyReport(
        frontend_j=frontend_energy(effective, paper_faithful=paper_faithful),
        backend_j=backend_energy(n_templates, n_features),
        teacher_j=teacher_ops * per_op_energy(bits=8, paper_faithful=paper_faithful),
    )


def paper_numbers() -> dict[str, float]:
    """§V-D constants for validation in tests/benchmarks."""
    rep = hybrid_report(paper_faithful=True)
    return {
        "backend_nj": rep.backend_j * 1e9,
        "frontend_nj": rep.frontend_j * 1e9,
        "total_nj": rep.total_j * 1e9,
        "teacher_uj": rep.teacher_j * 1e6,
        "reduction_x": rep.reduction,
    }
