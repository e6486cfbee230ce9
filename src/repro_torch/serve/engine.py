"""Batched LM decode engine of the port: continuous batching over the zoo.

The JAX package's `repro.serve.engine`: requests (token prompts) are
admitted into a fixed-size batch; a group prefill builds the KV cache
(prompts left-padded to the group's longest), then the decode loop samples
one token per live slot per step until EOS or ``max_new_tokens``. When a
slot finishes mid-batch, the FIFO head of the queue joins it: a one-row
prefill left-padded to the batch's current length, spliced into slot ``i``
of the live cache. A slot that runs out of room (``max_len``) is
truncated. `BatchStats` counts group starts, joins, decode steps and live
slot-steps exactly as the JAX engine does.

Sampling: temperature 0 takes the argmax (the lowest index on ties), so
tokens and `BatchStats` equal the JAX engine's on the same weights.
Temperature > 0 keeps the JAX contract, not its stream: a request's t-th
token depends only on (seed, rid, t). It is drawn by the Gumbel-max trick
from a CPU `torch.Generator` seeded from those three numbers through
numpy's `SeedSequence` (torch cannot draw JAX's threefry streams), so batch
composition never changes which stream a request consumes, and the draw is
the same on the card and on the CPU.

The engine runs where its params live (`repro_torch.models.lm.init_params`
puts them on the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.models import lm


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    #: admission-order id, the per-request sampling stream selector.
    #: Assigned by `Engine.generate` when < 0; callers may pin it to replay
    #: a specific stream.
    rid: int = -1


@dataclasses.dataclass
class BatchStats:
    """Honest batch-fill accounting for the decode loop."""

    slots: int = 0  # engine batch size
    groups: int = 0  # batched group prefills (group starts)
    joins: int = 0  # mid-batch slot admissions (prefill-on-join)
    requests: int = 0  # requests served (initial fills + joins)
    decode_steps: int = 0  # batched decode dispatches
    slot_steps: int = 0  # slot-steps that carried a live request

    @property
    def occupancy(self) -> float:
        """Live-slot fraction across decode steps (1.0 = no idle slots)."""
        if self.decode_steps == 0 or self.slots == 0:
            return 0.0
        return self.slot_steps / (self.decode_steps * self.slots)

    def as_dict(self) -> dict:
        return {
            "slots": self.slots,
            "groups": self.groups,
            "joins": self.joins,
            "requests": self.requests,
            "decode_steps": self.decode_steps,
            "slot_steps": self.slot_steps,
            "occupancy": round(self.occupancy, 4),
        }


def _gumbel(seed: int, rid: int, t: int, vocab: int) -> torch.Tensor:
    """The Gumbel noise of request ``rid``'s t-th draw: a function of
    (seed, rid, t) alone."""
    state = np.random.SeedSequence([seed, rid, t]).generate_state(
        2, np.uint32)
    g = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
    u = torch.rand((vocab,), generator=g, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


class Engine:
    def __init__(self, cfg: lm.ArchConfig, params: lm.LM, *,
                 batch_size: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0):
        if not cfg.causal:
            raise ValueError("encoder-only architectures do not decode")
        self.cfg, self.params = cfg, params
        self.device = params.unembed.w.device
        self.batch_size, self.max_len = batch_size, max_len
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.stats = BatchStats(slots=batch_size)
        self._rid_counter = 0

    def _prefill(self, prompts: np.ndarray):
        return lm.prefill(self.params, self.cfg,
                          torch.as_tensor(prompts, device=self.device),
                          max_len=self.max_len)

    def _sample_slots(self, logits: torch.Tensor, slots) -> np.ndarray:
        """One token per row: the argmax at temperature 0, else the
        (seed, rid, t)-keyed draw, whatever batch the request rides in."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        vocab = logits.shape[-1]
        noise = torch.stack([
            _gumbel(self.seed, s.rid, len(s.out), vocab) if s is not None
            else torch.zeros((vocab,)) for s in slots]).to(logits.device)
        scaled = logits.to(torch.float32) / self.temperature
        return torch.argmax(scaled + noise, dim=-1).cpu().numpy()

    @staticmethod
    def _push_token(r: Request, t: int) -> None:
        r.out.append(t)
        if len(r.out) >= r.max_new_tokens or \
                (r.eos_id is not None and t == r.eos_id):
            r.done = True

    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve all requests with continuous batching: a batched group
        prefill seeds up to `batch_size` slots, the decode loop samples
        until EOS / max_new_tokens per slot (ragged finish), and a finished
        slot admits the FIFO head of the queue mid-batch via a
        prefill-on-join (left-padded to the group's current length). The
        queue head waits only when its prompt is longer than the current
        length or the remaining room cannot fit its budget; then the group
        drains and a fresh group prefill restarts at that prompt's length."""
        for r in requests:
            if r.rid < 0:
                r.rid = self._rid_counter
                self._rid_counter += 1
        queue = deque(requests)
        while queue:
            self._serve_group(queue)
        return requests

    def _can_join(self, r: Request, cur_len: int) -> bool:
        return (len(r.prompt) <= cur_len
                and cur_len + r.max_new_tokens <= self.max_len)

    def _serve_group(self, queue: deque) -> None:
        b = self.batch_size
        group = [queue.popleft() for _ in range(min(b, len(queue)))]
        slots: list[Request | None] = group + [None] * (b - len(group))
        self.stats.groups += 1
        self.stats.requests += len(group)

        plen = max(len(r.prompt) for r in group)
        prompts = np.zeros((b, plen), np.int32)
        for i, r in enumerate(group):
            prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad
        logits, cache = self._prefill(prompts)
        cur_len = plen
        tok = self._sample_slots(logits, slots)
        for i, r in enumerate(group):
            self._push_token(r, int(tok[i]))

        while True:
            # retire finished slots, then admit the queue head into any
            # free slot it fits (FIFO: only the head may join)
            for i in range(b):
                if slots[i] is not None and slots[i].done:
                    slots[i] = None
                if slots[i] is None and queue \
                        and self._can_join(queue[0], cur_len):
                    nxt = queue.popleft()
                    slots[i] = nxt
                    self.stats.joins += 1
                    self.stats.requests += 1
                    row = np.zeros((1, cur_len), np.int32)
                    row[0, cur_len - len(nxt.prompt):] = nxt.prompt
                    jlogits, jcache = self._prefill(row)
                    # splice every field of the one-row cache into slot i
                    # (batch axis 1); both caches sit at the same shared
                    # length, which stays the live one's
                    for f in lm.CACHE_FIELDS:
                        live = getattr(cache, f)
                        if live is not None:
                            live[:, i] = getattr(jcache, f)[:, 0]
                    jtok = self._sample_slots(jlogits, [nxt])
                    tok[i] = jtok[0]
                    self._push_token(nxt, int(jtok[0]))
                    if nxt.done:  # max_new_tokens == 1 / instant EOS
                        slots[i] = None
            live = [i for i in range(b) if slots[i] is not None]
            if not live or cur_len >= self.max_len:
                break
            logits, cache = lm.decode_step(
                self.params, self.cfg,
                torch.as_tensor(tok[:, None], device=self.device), cache)
            cur_len += 1
            self.stats.decode_steps += 1
            self.stats.slot_steps += len(live)
            tok = self._sample_slots(logits[:, 0], slots)
            for i in live:
                self._push_token(slots[i], int(tok[i]))
        for s in slots:  # out of room (cur_len hit max_len): truncate
            if s is not None:
                s.done = True
