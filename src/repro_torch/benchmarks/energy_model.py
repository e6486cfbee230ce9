"""Paper §V-D: energy per classification of the hybrid system against the
teacher, the paper's arithmetic exactly (Eq. 14 and Horowitz's figures), in
the paper's units and in physical ones (`repro_torch.core.energy` notes the
unit slip). Analytic: no device runs."""
from __future__ import annotations

from repro_torch.core import energy


def run() -> dict:
    paper = energy.paper_numbers()
    phys = energy.hybrid_report(paper_faithful=False)
    return {
        **{f"paper_{k}": round(v, 4) for k, v in paper.items()},
        "physical_frontend_uj": round(phys.frontend_j * 1e6, 3),
        "physical_teacher_mj": round(phys.teacher_j * 1e3, 3),
        "physical_reduction_x": round(phys.reduction, 1),
    }


if __name__ == "__main__":
    print(run())
