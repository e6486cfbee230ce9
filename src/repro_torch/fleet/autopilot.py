"""The autopilot: evaluates the policy every K ticks and acts on it.

A twin of the JAX package's `repro/fleet/autopilot.py`. Everything the
pure controller (`repro_torch.fleet.policy`) cannot own lives here:
cadence, hysteresis, cooldown, and executing transitions through the
control plane. Driven by calling `observe_tick()` after every
`service.step()`, so "a tick happened" is its only clock (no wall time, no
threads: deterministic under test).

    ap = Autopilot(service, policy=PolicySpec(interval=8, hysteresis=2))
    for ...:
        service.step()
        ap.observe_tick()

Per evaluation (every ``policy.interval`` observed ticks, outside the
post-action ``policy.cooldown`` window): snapshot `view_of(service)`, run
`policy.explain`, and require the SAME proposal on ``policy.hysteresis``
consecutive evaluations before acting. Actions execute as:

  escalate_shards   the double-buffered rolling path: `reshard.prepare`
                    builds the shadow bank NOW (overlapped with serving)
                    and the flip lands at the next observed tick boundary,
                    with no drain. A flip that finds its buffer stale
                    (tenant churn won the race) re-prepares and retries at
                    the following boundary. (With ``mesh.install`` set,
                    one card without a forced mesh never proposes it:
                    `policy._shards_allowed`.)
  swap_backend /    the drained `reconfigure` path; the drained responses
  widen_slots       surface through `take_drained()`.
  compact           `service.compact_registry()`, taken when the policy
                    proposes no spec change but `should_compact` fires.

Every executed action emits a `policy_decision` event carrying the full
frozen view it decided from, so replaying `policy.explain` over the logged
views reproduces the action stream.
"""
from __future__ import annotations

from repro_torch.fleet import reshard as reshard_lib
from repro_torch.fleet.policy import (PolicySpec, explain, should_compact,
                                      view_of)
from repro_torch.serve.registry import RegistryError


class Autopilot:
    """Telemetry-driven controller loop over one `HybridService`."""

    def __init__(self, service, *, policy: PolicySpec = PolicySpec()):
        self.service = service
        self.policy = policy
        self.ticks = 0
        self.actions: list[dict] = []  # executed actions, for operators
        self.drained: list = []  # responses served by drained reconfigures
        self._streak_key = None
        self._streak = 0
        self._cooldown_until = -1
        self._pending: reshard_lib.PreparedReshard | None = None

    # -- the serving loop's hook -------------------------------------------

    def observe_tick(self) -> str | None:
        """Call after every `service.step()`. Returns the action executed
        at THIS boundary (a pending buffer flip landing included), or
        None."""
        self.ticks += 1
        if self._pending is not None:
            return self._flip_pending()
        if self.ticks % self.policy.interval:
            return None
        if self.ticks < self._cooldown_until:
            return None
        return self._evaluate()

    def take_drained(self) -> list:
        """Responses served inside autopilot-initiated drained
        reconfigures since the last call. Collect right after
        `observe_tick()`: the drained requests were the queue head, so
        appending them there keeps submission order."""
        out, self.drained = self.drained, []
        return out

    # -- internals ----------------------------------------------------------

    def _evaluate(self) -> str | None:
        view = view_of(self.service)
        action, reason, target = explain(view, self.policy)
        if action == "hold":
            if should_compact(view, self.policy):
                action, reason = "compact", (
                    f"occupancy {sum(view.shard_rows_used)}/"
                    f"{view.capacity_classes} rows below compaction "
                    "threshold")
            else:
                self._streak_key, self._streak = None, 0
                return None
        key = (action, target)
        self._streak = self._streak + 1 if key == self._streak_key else 1
        self._streak_key = key
        if self._streak < self.policy.hysteresis:
            return None

        if action == "escalate_shards":
            # double-buffered: build the shadow now, flip next boundary
            self._pending = reshard_lib.prepare(self.service, target)
        elif action == "compact":
            self.service.compact_registry()
        else:
            report = self.service.reconfigure(target)
            self.drained.extend(report.drained)
        self._record(action, reason, view, applied=True)
        self._streak_key, self._streak = None, 0
        self._cooldown_until = self.ticks + self.policy.cooldown
        return action

    def _flip_pending(self) -> str | None:
        prep = self._pending
        try:
            self.service.rolling_reshard(prep.spec, prepared=prep)
        except RegistryError:
            # tenant churn between prepare and flip: re-prepare against
            # the registry as it is now, flip at the next boundary
            try:
                self._pending = reshard_lib.prepare(self.service, prep.spec)
            except (RegistryError, ValueError):
                self._pending = None  # target no longer viable; re-evaluate
            return None
        self._pending = None
        self._cooldown_until = self.ticks + self.policy.cooldown
        return "buffer_flip"

    def _record(self, action: str, reason: str, view,
                applied: bool) -> None:
        entry = {"tick": self.ticks, "action": action, "reason": reason,
                 "applied": applied}
        self.actions.append(entry)
        self.service.obs.emit("policy_decision", view=view.to_dict(),
                              **entry)
