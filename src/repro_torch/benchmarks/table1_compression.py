"""Paper Table I: the teacher against the student through the compression
pipeline.

Columns: accuracy, F1, precision, recall, parameters, MAC operations and
compression ratio, for the teacher (colour and greyscale), the unoptimised
student and the optimised (KD + prune + QAT) student. Parameters and MACs
are analytic (Eq. 13), the paper's method; accuracies are on the synthetic
substitute for CIFAR-10, not the paper's data.
"""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.models import cnn
from repro_torch.train import cnn_trainer as T


def run(device=None) -> list[dict]:
    """The four rows, trained and evaluated on ``device`` (the card unless
    the caller asks for the CPU)."""
    d = common.data()
    m = common.models(device)
    rows = []

    teacher_macs_c = cnn.teacher_macs(common.TEACHER_CFG_COLOR)
    met = T.metrics(cnn.teacher_logits, m["teacher_color"], *d["color_te"])
    rows.append(dict(model="teacher_colour", **met,
                     params=cnn.count_params(m["teacher_color"]),
                     macs=teacher_macs_c, compression="1:1"))

    teacher_macs_g = cnn.teacher_macs(common.TEACHER_CFG_GRAY)
    met = T.metrics(cnn.teacher_logits, m["teacher_gray"], *d["gray_te"])
    rows.append(dict(model="teacher_greyscale", **met,
                     params=cnn.count_params(m["teacher_gray"]),
                     macs=teacher_macs_g,
                     compression=f"{teacher_macs_c/teacher_macs_g:.2f}:1"))

    s_macs = cnn.student_macs()["total"]
    s_params = cnn.count_params(m["student_base"])
    met = T.metrics(cnn.student_logits, m["student_base"], *d["gray_te"])
    rows.append(dict(model="student_base", **met, params=s_params,
                     macs=s_macs,
                     compression=f"{teacher_macs_c/s_macs:.0f}:1"))

    met = T.metrics(cnn.student_logits, m["student_opt"], *d["gray_te"])
    eff_macs = int(s_macs * 0.2)  # 80% sparsity skips pruned-weight MACs
    rows.append(dict(model="student_optimised", **met, params=s_params,
                     macs=eff_macs,
                     compression=f"{teacher_macs_c/eff_macs:.0f}:1"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
