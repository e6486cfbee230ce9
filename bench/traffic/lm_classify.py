"""Traffic kind ``lm_classify``: one client classifies batches of token
sequences in a closed loop through `HybridClassifier.predict`, the
front end a language model's features (`lm.features`: the final-norm
hidden state averaged over the positions) and the back end the
feature-count ACAM.

Set-up draws the configuration's weights on the card (`draw_weights`) and
the program's model takes them as they lie (no copy); it draws a
calibration set (``calibration_sequences_per_class`` sequences a class)
from which the program builds its ACAM head (`fit_acam_head`, a batch at a
time), and a pool of ``pool_batches`` batches of ``batch`` sequences of
``seq_len`` int32 token ids, held in pinned host memory. Each sequence
belongs to one of ``num_classes`` classes: a ``class_share`` of its tokens
come from a Zipf(``zipf_s``) over its class's slice of ``class_slice`` ids,
the rest from a Zipf(``zipf_s``) over the whole vocabulary, its ranks
spread over the ids by a seeded permutation. Every batch is handed to
``predict`` as it lies on the host; the predictions come back to the host
before the next batch is sent. An item is one sequence.

Parameters: ``batch``, ``seq_len``, ``pool_batches``, ``class_slice``,
``zipf_s``, ``class_share``, ``trace_batches``.

Checks, once the window has closed, against the plain reference
(`bench/reference/deepseek_v3.py`) in the configuration's precision, run
one sequence at a time and layer by layer after the program's state is
freed: the features of the first pool batch's first pass (set-up's
warm-up) and of one more batch run after the window (``feat_err``,
`compare.worst_row_gap` over their sequences); the routing of those two
batches, recorded where the program's MoE layers call `layers.route`
(`recorded_taps`, for these two calls alone): the share of (token, MoE
layer) pairs whose chosen expert set differs from the reference's
(``route_flips``); the same two calls' router and attention on equal
inputs, each recorded at its call with what it computed and recomputed
by the reference in float32 from the recorded input alone, so that the
rounding upstream, which reroutes 15% of the pairs above, is out of the
comparison: the share of pairs routed to another set
(``route_flips_equal_input``) and the gap of the attention's outputs,
all rows together (``attn_gap_equal_input``: the L2 norm of the
difference over that of the reference's outputs); every prediction of the
warm-up, the window and that batch against the reference's own bank,
built from its features of the same calibration set (``pred_mismatch``);
and the slots the program dropped past an expert's capacity, over every
batch (``dropped_slots``). Beside them, as notes: the rows each held
expert of each MoE layer computed for the two batches, the program's own
counters against the reference's routing (``route_gap``: the summed
absolute difference over the reference's rows), which swaps between
experts leave unseen, and the worst row's attention gap on equal inputs
(``attn_gap_equal_input_worst_row``, `compare.worst_row_gap` a layer and
a sequence), which single rows' rounding dominates.

Host totals (``host`` of the window, read by the metrics): ``call_s``,
``calls``, the window's ``held_rows`` and ``dropped_slots``, and after a
traced stretch its ``traced_held_rows``, which `mfu.lm` reads.

Besides the ``Driver``: `flops_per_sequence`, `routed_flops_per_row` and
``BF16_FLOPS`` (`mfu.lm`); ``CONTROL`` (the reference in the program's
place, its attention scores and router logits rounded to bf16, as a GEMM
that writes bf16 rounds them) and
``FAULTS``, what the checks' tests and `bench/calibrate.py` put in the
program's place; ``CPU_TEST``, the sizes at which the tests run a cell of
this kind on the CPU.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from bench.harness import cells, compare
from bench.reference import acam
from bench.reference import deepseek_v3 as ref

_FRAMES = cells.load_module("traffic", "frames",
                            Path(__file__).resolve().parents[2])

#: NVIDIA H100 SXM data sheet, dense bf16 on the tensor cores, 700 W
BF16_FLOPS = 989.4e12


# ---------------------------------------------------------------------------
# the yardstick's arithmetic
# ---------------------------------------------------------------------------

def flops_per_sequence(cfg: dict, seq_len: int) -> float:
    """Operations of one sequence's forward but the routed experts: the
    MLA projections and causal attention (a query attends (S + 1) / 2 keys
    on average) in every layer, the dense MLP of the leading layers, the
    router and the shared expert of the rest; 2 a multiply-accumulate."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    ql, kl = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    proj = (d * ql + ql * h * (nope + rope) + d * (kl + rope)
            + kl * h * (nope + dv) + h * dv * d)
    attn = h * (nope + rope + dv) * (seq_len + 1) / 2
    dense = 3 * d * cfg["intermediate_size"]
    shared = (d * cfg["router_experts"]
              + 3 * d * cfg["moe_intermediate_size"] * cfg["n_shared_experts"])
    n, k = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    return 2 * seq_len * (n * (proj + attn) + k * dense + (n - k) * shared)


def routed_flops_per_row(cfg: dict) -> float:
    """Operations of one routed row through one expert (gate, up,
    down)."""
    return 2 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


# ---------------------------------------------------------------------------
# traffic and weights, from the seed
# ---------------------------------------------------------------------------

def zipf(gen: torch.Generator, n_ids: int, count: int, s: float,
         device) -> torch.Tensor:
    """``count`` ranks in [0, n_ids) with P(r) proportional to
    (r + 1) ** -s."""
    p = torch.arange(1, n_ids + 1, dtype=torch.float64,
                     device=device) ** -s
    return torch.multinomial(p.to(torch.float32), count, replacement=True,
                             generator=gen)


def sequences(gen: torch.Generator, labels: torch.Tensor, cfg: dict,
              p: dict) -> torch.Tensor:
    """(n, seq_len) int32 token ids of classes ``labels`` (n,)."""
    n, s, dev = labels.shape[0], p["seq_len"], labels.device
    vocab, size = cfg["vocab_size"], p["class_slice"]
    spread = torch.randperm(vocab, generator=gen, device=dev)
    common = spread[zipf(gen, vocab, n * s, p["zipf_s"], dev)].view(n, s)
    own = (labels[:, None] * size
           + zipf(gen, size, n * s, p["zipf_s"], dev).view(n, s))
    pick = torch.rand((n, s), generator=gen, device=dev) < p["class_share"]
    return torch.where(pick, own, common).to(torch.int32)


def arch_config(cfg: dict):
    """The program's `ArchConfig` of the configuration."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    rs = cfg["rope_scaling"]
    return lm.ArchConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], n_experts=cfg["router_experts"],
        top_k=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        d_ff_expert=cfg["moe_intermediate_size"],
        router_type="sigmoid_group", n_group=cfg["n_group"],
        topk_group=cfg["topk_group"], router_bias=True,
        routed_scaling_factor=cfg["routed_scaling_factor"],
        first_k_dense=cfg["first_k_dense_replace"],
        experts_held=cfg["n_routed_experts"],
        expert_offset=cfg["expert_offset"], dropless=cfg["dropless"],
        mla=True, q_lora_rank=cfg["q_lora_rank"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        rope_theta=float(cfg["rope_theta"]),
        yarn=L.YaRN(float(rs["factor"]),
                    rs["original_max_position_embeddings"],
                    float(rs["beta_fast"]), float(rs["beta_slow"]),
                    float(rs["mscale"]), float(rs["mscale_all_dim"])),
        dtype=getattr(torch, cfg["dtype"]))


def draw_weights(gen: torch.Generator, cfg: dict, device: torch.device
                 ) -> dict:
    """The program's parameters by name, drawn on ``device`` as the
    configuration's ``assumed`` says, a slice at a time (an f32 draw of a
    whole matrix would be a temporary as large)."""
    from repro_torch.models import lm

    shapes = lm.init_params(0, arch_config(cfg), device="meta")
    dtype = getattr(torch, cfg["dtype"])
    out = {}
    for name, p in shapes.named_parameters():
        if name.endswith("scale"):
            out[name] = torch.ones(p.shape, dtype=p.dtype, device=device)
            continue
        if name.endswith("moe.bias"):
            std, dt = 0.02, torch.float32
        elif name.endswith("router.w"):
            std, dt = p.shape[0] ** -0.5, torch.float32
        elif name == "embed":
            std, dt = 0.02, dtype
        else:  # (din, dout) or an expert stack (n, din, dout)
            std, dt = p.shape[-2] ** -0.5, dtype
        t = torch.empty(p.shape, dtype=dt, device=device)
        for piece in t.view(-1, p.shape[-1]).split(1024):
            piece.copy_(torch.randn(piece.shape, generator=gen,
                                    device=device) * std)
        out[name] = t
    return out


def reference_weights(weights: dict, cfg: dict, index: int) -> dict:
    """Layer ``index``'s weights as the reference names them (the same
    tensors; q_b's and kv_a's rope columns put in pair order)."""
    at = f"layers.{index}."
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]

    def w(name):
        return weights[at + name]

    lw = {"attn_norm": w("ln1.scale"), "q_a": w("attn.q_a.w"),
          "q_a_norm": w("attn.q_a_norm.scale"),
          "q_b": ref.interleave_rope_columns(w("attn.q_b.w"), nope + rope,
                                             rope),
          "kv_a": ref.interleave_rope_columns(
              w("attn.kv_a.w"), cfg["kv_lora_rank"] + rope, rope),
          "kv_a_norm": w("attn.kv_a_norm.scale"), "kv_b": w("attn.kv_b.w"),
          "o": w("attn.o.w"), "ffn_norm": w("ln2.scale")}
    if index < cfg["first_k_dense_replace"]:
        lw.update(gate=w("mlp.gate.w"), up=w("mlp.up.w"),
                  down=w("mlp.down.w"))
    else:
        lw.update(router=w("moe.router.w"), bias=w("moe.bias"),
                  experts_gate=w("moe.gate"), experts_up=w("moe.up"),
                  experts_down=w("moe.down"),
                  shared_gate=w("moe.shared.gate.w"),
                  shared_up=w("moe.shared.up.w"),
                  shared_down=w("moe.shared.down.w"))
    return lw


def precision_of(cfg: dict, below: bool = False) -> ref.Precision:
    """The reference's precision for the configuration's dtype; ``below``:
    its attention scores and router logits rounded to bf16."""
    act = None if cfg["dtype"] == "float32" else getattr(torch, cfg["dtype"])
    return ref.Precision(act, torch.bfloat16 if below else torch.float32)


def reference_features(weights: dict, cfg: dict, seqs: torch.Tensor,
                       prec: ref.Precision, routed: dict | None = None,
                       taps: dict | None = None) -> torch.Tensor:
    """(n, d) float32 reference features of ``seqs`` (n, S), computed layer
    by layer over all of them (each layer's weights read in float32 once),
    one sequence at a time. ``routed`` maps a sequence's row to a list that
    gains its MoE layers' ids, ``taps`` to a dict that gains its router's
    and attention's inputs and outputs (`ref.layer`)."""
    n = seqs.shape[0]
    emb = {"embed": weights["embed"]}
    h = [ref.embed(emb, seqs[i], prec) for i in range(n)]
    for index in range(cfg["num_hidden_layers"]):
        lw = {k: v.to(torch.float32)
              for k, v in reference_weights(weights, cfg, index).items()}
        for i in range(n):
            h[i] = ref.layer(lw, cfg, index, h[i], prec,
                             None if routed is None else routed.get(i),
                             None if taps is None else taps.get(i))
        del lw
    fin = {"final_norm": weights["final_norm.scale"]}
    return torch.stack([ref.final(fin, x, cfg, prec).mean(dim=0)
                        for x in h])


def other_sets(got: torch.Tensor, want: torch.Tensor) -> int:
    """Rows of expert ids (T, k) whose set differs between the two."""
    return int((torch.sort(got.to(want.device), dim=1).values
                != torch.sort(want, dim=1).values).any(1).sum())


def equal_input_gaps(weights: dict, cfg: dict, recorded: list,
                     prec: ref.Precision, device: torch.device) -> tuple:
    """The reference's router and attention in ``prec`` on the inputs that
    a system's calls recorded (``recorded``: `recorded_taps`' dicts),
    against what those calls chose and computed -> (the share of (token,
    MoE layer) pairs routed to another set, the worst row's attention gap
    (`compare.worst_row_gap` a layer and a sequence), the gap of all rows
    together: the L2 norm of the difference over the reference's)."""
    f32, first = torch.float32, cfg["first_k_dense_replace"]
    flips, pairs, worst, diff2, norm2 = 0, 0, 0.0, 0.0, 0.0
    for index in range(cfg["num_hidden_layers"]):
        lw = {k: v.to(f32)
              for k, v in reference_weights(weights, cfg, index).items()}
        with ref.no_tf32():
            for taps in recorded:
                x, out = taps["attn"][index]
                for i in range(x.shape[0]):
                    want = ref.attention(lw, x[i].to(device, f32), cfg,
                                         prec)
                    got = out[i].to(device, f32)
                    worst = max(worst, compare.worst_row_gap(got, want))
                    diff2 += float((got - want).square().sum())
                    norm2 += float(want.square().sum())
                if index >= first:
                    j = index - first
                    ids, _ = ref.route(lw, taps["router"][j].to(device, f32),
                                       cfg, prec)
                    flips += other_sets(taps["ids"][j], ids)
                    pairs += ids.shape[0]
        del lw
    return flips / max(pairs, 1), worst, (diff2 / max(norm2, 1e-30)) ** 0.5


def held_rows(ids_by_layer: list, cfg: dict) -> list:
    """Rows of each held expert (one list a MoE layer) in routing ids."""
    lo, n = cfg["expert_offset"], cfg["n_routed_experts"]
    return [[int((ids == lo + j).sum()) for j in range(n)]
            for ids in ids_by_layer]


# ---------------------------------------------------------------------------
# the systems
# ---------------------------------------------------------------------------

class recorded_taps:
    """A context in which the program's router (`layers.route`) and MLA
    attention (`lm._mla_train_attention`) record what each call was given
    and what it chose or computed, in the dict it yields: ``"ids"`` (T, k)
    and ``"router"``, the router's input (T, d), one a MoE layer;
    ``"attn"``, the attention's input and output (B, S, d), a pair a
    layer. The timed path's own tensors, the large ones copied to the
    host, read for the checked batches alone."""

    def __enter__(self) -> dict:
        from repro_torch.models import layers as L
        from repro_torch.models import lm

        got = {"ids": [], "router": [], "attn": []}
        route, attention = L.route, lm._mla_train_attention
        self.saved = [(L, "route", route),
                      (lm, "_mla_train_attention", attention)]

        def recording_route(p, xf, *args, **kw):
            out = route(p, xf, *args, **kw)
            got["router"].append(xf.cpu())
            got["ids"].append(out[3])
            return out

        def recording_attention(p, cfg, h, *args, **kw):
            out = attention(p, cfg, h, *args, **kw)
            got["attn"].append((h.cpu(), out[0].cpu()))
            return out

        L.route, lm._mla_train_attention = recording_route, \
            recording_attention
        return got

    def __exit__(self, *exc) -> None:
        for module, name, fn in self.saved:
            setattr(module, name, fn)


class PortClassifier:
    """The system under test: the port's `HybridClassifier` over
    `lm.features`, its MoE counters (`layers.MoECounts`) kept."""

    arch_changes: dict = {}

    def __init__(self, cfg: dict, weights: dict, cal_x, cal_y,
                 device: torch.device, batch: int):
        from repro_torch.core import hybrid
        from repro_torch.models import layers as L
        from repro_torch.models import lm

        arch = dataclasses.replace(arch_config(cfg), **self.arch_changes)
        model = lm.init_params(0, arch, device="meta")
        model.load_state_dict(self.take(weights, arch), assign=True)
        self.counts = L.MoECounts()
        self.n_moe, self.slot, self._kept = arch.n_moe_layers, 0, {}

        def feature_fn(params, x):
            f = lm.features(params, arch, x, counts=self.counts)
            self._kept[self.slot] = f
            return f

        head = hybrid.fit_acam_head(
            feature_fn, model, cal_x, cal_y, cfg["num_classes"],
            k=cfg["templates_per_class"],
            threshold_method=cfg["threshold_method"], method=cfg["method"],
            batch_size=batch, device=device)
        self.clf = hybrid.HybridClassifier(model, feature_fn, head,
                                           device=str(device))

    def predict_recorded(self, x, slot: int) -> tuple:
        """`predict`, with what its router and attention were given and
        computed (`recorded_taps`)."""
        with recorded_taps() as taps:
            pred = self.predict(x, slot)
        return pred, taps

    @staticmethod
    def take(weights: dict, arch) -> dict:
        return weights

    def predict(self, x, slot: int) -> torch.Tensor:
        self.slot = slot
        return self.clf.predict(x)

    def kept(self) -> dict:
        return self._kept

    def last_rows(self) -> list:
        """Rows a held expert computed, one list a MoE layer, in the last
        batch."""
        return self.counts.calls[-self.n_moe:]


class Counts:
    """The control's routing tallies, as the program's counters hold
    them."""

    def __init__(self):
        self.held_rows, self.dropped_slots, self.calls = 0, 0, []


class ControlClassifier:
    """The reference in the program's place, its attention scores and
    router logits rounded to bf16 as a bf16 GEMM's output is: the control
    that the checks must fail."""

    def __init__(self, cfg: dict, weights: dict, cal_x, cal_y,
                 device: torch.device, batch: int):
        self.cfg, self.w = cfg, weights
        self.prec = precision_of(cfg, below=True)
        self.counts, self._kept = Counts(), {}
        self.bank = acam.build_bank(self._features(cal_x)[0], cal_y,
                                    cfg["num_classes"],
                                    cfg["templates_per_class"],
                                    cfg["kmeans_iters"])

    def _features(self, x: torch.Tensor, taps: dict | None = None
                  ) -> tuple:
        """(features, each MoE layer's ids (T, k)), its rows counted."""
        routed = {i: [] for i in range(x.shape[0])}
        f = reference_features(self.w, self.cfg, x, self.prec, routed, taps)
        ids = [torch.cat([routed[i][j] for i in routed])
               for j in range(len(routed[0]))]
        for rows in held_rows(ids, self.cfg):
            self.counts.calls.append(rows)
            self.counts.held_rows += sum(rows)
        return f, ids

    def predict(self, x, slot: int) -> torch.Tensor:
        dev = self.w["embed"].device
        f = self._features(torch.as_tensor(x).to(dev))[0]
        self._kept[slot] = f
        return acam.classify(f, self.bank)

    def predict_recorded(self, x, slot: int) -> tuple:
        """`predict`, with what the reference's router and attention were
        given and computed, in `recorded_taps`' form."""
        dev = self.w["embed"].device
        x = torch.as_tensor(x).to(dev)
        per = {i: {"attn": [], "router": []} for i in range(x.shape[0])}
        f, ids = self._features(x, per)
        self._kept[slot] = f
        seqs = list(per.values())

        def host(parts):
            return torch.stack(parts).to(torch.bfloat16).cpu()

        taps = {"ids": ids,
                "router": [host([t["router"][j] for t in seqs]).flatten(0, 1)
                           for j in range(len(seqs[0]["router"]))],
                "attn": [tuple(host([t["attn"][j][n] for t in seqs])
                               for n in (0, 1))
                         for j in range(len(seqs[0]["attn"]))]}
        return acam.classify(f, self.bank), taps

    def kept(self) -> dict:
        return self._kept

    def last_rows(self) -> list:
        n_moe = (self.cfg["num_hidden_layers"]
                 - self.cfg["first_k_dense_replace"])
        return self.counts.calls[-n_moe:]


class AlteredAnswers(PortClassifier):
    """A fault: one answer in 97 altered where it is produced."""

    def predict(self, x, slot):
        pred = super().predict(x, slot).clone()
        c = self.clf.head.bank.num_classes
        pred[::97] = (pred[::97] + 1) % c
        return pred


class OneExpertShort(PortClassifier):
    """A fault: the share holds one expert fewer than the configuration
    (the last one's rows never computed)."""

    @staticmethod
    def take(weights: dict, arch) -> dict:
        n = arch.n_held
        return {k: (v[:n] if k.endswith(("moe.gate", "moe.up", "moe.down"))
                    else v) for k, v in weights.items()}

    def __init__(self, cfg, *args, **kw):
        self.arch_changes = {"experts_held": cfg["n_routed_experts"] - 1}
        super().__init__(cfg, *args, **kw)


class PlainRope(PortClassifier):
    """A fault: the rotation without YaRN's frequencies and softmax
    scale."""

    arch_changes = {"yarn": None}


#: the reference in the program's place, one precision below the
#: configuration's: the checks must read it not correct
CONTROL = ControlClassifier
#: the program with its timed path broken: the checks must read each not
#: correct
FAULTS = {"altered_answers": AlteredAnswers,
          "one_expert_short": OneExpertShort, "plain_rope": PlainRope}
#: a cell of this kind at a size the CPU runs in a second or two, its
#: batch x classes x templates x features at the engine's kernel path on
#: the CPU (`match.backends.TINY_ELEMENTS`), as on the card
CPU_TEST = {
    "config": {"hidden_size": 128, "num_attention_heads": 4,
               "num_key_value_heads": 4, "q_lora_rank": 32,
               "kv_lora_rank": 16, "qk_nope_head_dim": 16,
               "qk_rope_head_dim": 8, "v_head_dim": 16,
               "intermediate_size": 96, "moe_intermediate_size": 32,
               "router_experts": 16, "n_routed_experts": 4,
               "num_experts_per_tok": 4, "n_group": 4, "topk_group": 2,
               "num_hidden_layers": 3, "first_k_dense_replace": 1,
               "vocab_size": 1024, "num_classes": 16, "num_features": 128,
               "calibration_sequences_per_class": 3, "dtype": "float32",
               "rope_scaling": {"type": "yarn", "factor": 40,
                                "original_max_position_embeddings": 64,
                                "beta_fast": 32, "beta_slow": 1,
                                "mscale": 1, "mscale_all_dim": 1}},
    "traffic": {"batch": 8, "seq_len": 48, "pool_batches": 2,
                "class_slice": 64, "trace_batches": 2}}


class Driver(_FRAMES.Driver):
    """`frames`' driver (window, traced stretch, marks), with sequences
    for frames and the checks above."""

    def __init__(self, cell, seed: int, device: torch.device,
                 system=PortClassifier):
        super().__init__(cell, seed, device, system)

    def setup(self) -> None:
        cfg, p, dev = self.cfg, self.p, self.dev
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.weights = draw_weights(gen, cfg, dev)
        self._mark("weights")
        per, c = cfg["calibration_sequences_per_class"], cfg["num_classes"]
        self.cal_y = torch.arange(c, device=dev).repeat_interleave(per)
        self.cal_x = sequences(gen, self.cal_y, cfg, p)
        nb, b = p["pool_batches"], p["batch"]
        self.labels = torch.randint(0, c, (nb * b,), generator=gen,
                                    device=dev)
        seqs = sequences(gen, self.labels, cfg, p).view(nb, b, -1)
        self.pool = torch.empty(seqs.shape, dtype=seqs.dtype,
                                pin_memory=self.cuda)
        self.pool.copy_(seqs)
        del seqs
        self._mark("sequences")
        self.system = self.make_system(cfg, self.weights, self.cal_x,
                                       self.cal_y, dev, b)
        self._mark("system")
        self.answers = []
        for slot in range(nb):  # every shape and pool batch once
            if slot == 0:
                pred, taps = self.system.predict_recorded(self.pool[0], 0)
                self.first = (0, self.system.kept()[0],
                              self.system.last_rows(), taps)
            else:
                pred = self.system.predict(self.pool[slot], slot)
            pred.cpu()
        self._mark("warm_up")
        self.done = nb

    def _batch(self, slot: int) -> float:
        self.done += 1
        return super()._batch(slot)

    def window(self, seconds: float) -> dict:
        counts = self.system.counts
        rows0, drops0 = counts.held_rows, counts.dropped_slots
        out = super().window(seconds)
        out["host"].update(held_rows=counts.held_rows - rows0,
                           dropped_slots=counts.dropped_slots - drops0)
        self.host = out["host"]
        return out

    def traced_run(self):
        run, sizes = super().traced_run()
        counts = self.system.counts

        def traced():
            before = counts.held_rows
            run()
            self.host["traced_held_rows"] = counts.held_rows - before

        return traced, sizes

    def check(self) -> dict:
        cfg, dev, nb = self.cfg, self.dev, self.p["pool_batches"]
        slot = self.done % nb
        pred, taps = self.system.predict_recorded(self.pool[slot], slot)
        self.answers.append((slot, pred.cpu()))
        after = (slot, self.system.kept()[slot], self.system.last_rows(),
                 taps)
        dropped = self.system.counts.dropped_slots
        self.system = None  # the program's state goes before the reference
        if self.cuda:
            torch.cuda.empty_cache()
        prec = precision_of(cfg)
        b = self.p["batch"]
        n_cal = self.cal_x.shape[0]
        seqs = torch.cat([self.cal_x, self.pool.view(nb * b, -1).to(dev)])
        checked = {n_cal + s * b + i: [] for s in {0, slot}
                   for i in range(b)}
        feats = reference_features(self.weights, cfg, seqs, prec, checked)
        bank = acam.build_bank(feats[:n_cal], self.cal_y,
                               cfg["num_classes"],
                               cfg["templates_per_class"],
                               cfg["kmeans_iters"])
        want = acam.classify(feats[n_cal:], bank).cpu().view(nb, b)
        wrong = sum(int((p.long() != want[s]).sum()) for s, p in self.answers)
        total = len(self.answers) * b
        feat_err, gap, ref_rows, flips, pairs = 0.0, 0, 0, 0, 0
        for s, got, got_rows, taps in (self.first, after):
            rows = n_cal + s * b
            feat_err = max(feat_err, compare.worst_row_gap(
                got.to(dev), feats[rows:rows + b]))
            ids = [torch.cat([checked[rows + i][j] for i in range(b)])
                   for j in range(len(got_rows))]
            for g, w in zip(taps["ids"], ids):
                flips += other_sets(g, w)
                pairs += w.shape[0]
            want_rows = held_rows(ids, cfg)
            gap += sum(abs(g - w) for gl, wl in zip(got_rows, want_rows)
                       for g, w in zip(gl, wl))
            ref_rows += sum(map(sum, want_rows))
        eq_flips, attn_gap_worst, attn_gap = equal_input_gaps(
            self.weights, cfg, [self.first[3], after[3]], prec, dev)
        self.notes = {"checked_slots": [0, slot], "reference_rows": ref_rows,
                      "route_gap": gap / max(ref_rows, 1),
                      "attn_gap_equal_input_worst_row": attn_gap_worst,
                      "predictions": total}
        numbers = {"feat_err": feat_err,
                   "route_flips": flips / max(pairs, 1),
                   "route_flips_equal_input": eq_flips,
                   "attn_gap_equal_input": attn_gap,
                   "pred_mismatch": wrong / total,
                   "dropped_slots": float(dropped)}
        return {k: (v, self.limits[k]) for k, v in numbers.items()}

