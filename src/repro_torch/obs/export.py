"""Exporters: JSONL event log, Prometheus text renderer, validators.

The event log is the service's black box: one JSON object per line,
appended and flushed per line so a SIGKILL mid-stream loses at most the
line being written — the chaos harness reads recovery timing and
in-flight loss out of this file from a *different process* after the
kill, which is the whole point. Every line carries `kind`, `ts`
(unix seconds), and `seq` (monotone per-log); per-kind payload fields
are specified in `EVENT_SCHEMA` and enforced by `validate_event` (the
CI `telemetry-smoke` job runs this module as a CLI over the emitted
file).

The Prometheus renderer is the pull-side twin: `render_prometheus`
turns a `MetricsRegistry` into text exposition format, and
`validate_prometheus_text` asserts the two operator-facing invariants —
no duplicate (name, labels) series, and bounded label cardinality.
"""
from __future__ import annotations

import io
import json
import os
import time

from .registry import MAX_LABEL_SETS, MetricsRegistry

# --------------------------------------------------------------------------
# Event schema
# --------------------------------------------------------------------------

#: required payload fields per event kind (every event also carries the
#: envelope fields `kind`, `ts`, `seq`). `validate_event` rejects unknown
#: kinds and missing fields; extra fields are allowed (forward compat).
EVENT_SCHEMA: dict[str, tuple[str, ...]] = {
    # one line per serving tick that did work (dispatched and/or resolved
    # expiries/sheds) — the stream bench rows are re-derived from
    "tick": ("tick_id", "fill", "served", "escalated", "shed", "expired",
             "dt_ms", "queue_depth", "shed_mode", "energy_j"),
    # lifecycle events, emitted by the control plane / service
    "reconfigure": ("actions", "drained", "duration_ms"),
    "reshard": ("bank_shards_from", "bank_shards_to"),
    "device_loss": ("lost", "survivors"),
    "device_heal": ("restored",),
    "snapshot": ("step", "path"),
    "restore": ("step", "resharded", "duration_ms"),
    "shed_on": ("queue_depth", "p99_ms"),
    "shed_off": ("queue_depth", "p99_ms"),
    # fleet lifecycle (the fleet slice of the port): the autopilot's black
    # box. Every policy_decision carries the FULL frozen registry view it decided
    # from plus the action taken, so the whole autopilot run is
    # reconstructible from the log alone (replay `policy.decide` over
    # the logged views and compare actions — tests/test_fleet.py does).
    "policy_decision": ("tick", "action", "reason", "applied", "view"),
    "manifest_apply": ("added", "evicted", "updated", "retuned",
                       "duration_ms"),
    "buffer_flip": ("bank_shards_from", "bank_shards_to", "tenants_moved",
                    "flip_ms", "build_ms"),
}

_ENVELOPE = ("kind", "ts", "seq")


def validate_event(event: dict) -> None:
    """Raise ValueError unless `event` is a well-formed log line."""
    for f in _ENVELOPE:
        if f not in event:
            raise ValueError(f"event missing envelope field {f!r}: {event}")
    kind = event["kind"]
    if kind not in EVENT_SCHEMA:
        raise ValueError(f"unknown event kind {kind!r} "
                         f"(known: {sorted(EVENT_SCHEMA)})")
    missing = [f for f in EVENT_SCHEMA[kind] if f not in event]
    if missing:
        raise ValueError(f"{kind!r} event missing fields {missing}: {event}")


class JsonlEventLog:
    """Append-only JSONL sink, one flush per line (crash-durable up to
    the line in flight). `None` path -> no-op sink, zero overhead."""

    def __init__(self, path: str | os.PathLike | None):
        self.path = str(path) if path is not None else None
        self.seq = 0
        self._fh: io.TextIOWrapper | None = None
        if self.path is not None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def emit(self, kind: str, **payload) -> None:
        if self._fh is None:
            return
        event = {"kind": kind, "ts": round(time.time(), 6),
                 "seq": self.seq, **payload}
        validate_event(event)  # never write a line the reader would reject
        self.seq += 1
        self._fh.write(json.dumps(event, sort_keys=True) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_events(path: str | os.PathLike,
                kind: str | None = None) -> list[dict]:
    """Load (and validate) an event log; optionally filter by kind. A
    truncated final line (SIGKILL mid-write) is tolerated and dropped."""
    events = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError:
                # a torn final line is expected after a crash; anything
                # earlier means corruption and should fail loudly
                rest = fh.read().strip()
                if rest:
                    raise ValueError(
                        f"{path}:{lineno}: unparseable non-final line")
                break
            validate_event(event)
            if kind is None or event["kind"] == kind:
                events.append(event)
    return events


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------

def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format."""
    lines = []
    for family, samples in registry.collect():
        if family.help:
            lines.append(f"# HELP {family.name} {family.help}")
        lines.append(f"# TYPE {family.name} {family.kind}")
        for s in samples:
            lines.append(f"{s.name}{_fmt_labels(s.labels)} "
                         f"{_fmt_value(s.value)}")
    return "\n".join(lines) + "\n"


def validate_prometheus_text(text: str,
                             max_label_sets: int = MAX_LABEL_SETS) -> dict:
    """Parse rendered exposition text and assert scraper invariants:
    every sample line parses, no duplicate (name, labels) series, and
    per-family series count stays under `max_label_sets`. Returns
    {"families": n, "series": n} on success, raises ValueError on any
    violation."""
    seen: set[tuple[str, str]] = set()
    per_family: dict[str, int] = {}
    families = 0
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            families += 1
            continue
        if line.startswith("#"):
            continue
        name_labels, _, value = line.rpartition(" ")
        if not name_labels:
            raise ValueError(f"line {lineno}: no value separator: {line!r}")
        try:
            float(value)
        except ValueError:
            raise ValueError(f"line {lineno}: bad value {value!r}") from None
        if "{" in name_labels:
            name, _, labels = name_labels.partition("{")
            if not labels.endswith("}"):
                raise ValueError(f"line {lineno}: unterminated labels")
        else:
            name, labels = name_labels, ""
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"line {lineno}: bad metric name {name!r}")
        key = (name, labels)
        if key in seen:
            raise ValueError(f"line {lineno}: duplicate series {key}")
        seen.add(key)
        base = name.rsplit("_bucket", 1)[0]
        per_family[base] = per_family.get(base, 0) + 1
        if per_family[base] > max_label_sets + 3:  # +sum/count/Inf slack
            raise ValueError(f"family {base!r} exceeds {max_label_sets} "
                             "series — label cardinality unbounded")
    return {"families": families, "series": len(seen)}


def write_prometheus(registry: MetricsRegistry,
                     path: str | os.PathLike) -> str:
    """Render + validate + atomically write a scrape file; returns the
    rendered text."""
    text = render_prometheus(registry)
    validate_prometheus_text(text)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
    os.replace(tmp, path)
    return text


__all__ = [
    "EVENT_SCHEMA", "JsonlEventLog", "read_events", "validate_event",
    "render_prometheus", "validate_prometheus_text", "write_prometheus",
]


def _main(argv: list[str]) -> int:
    """CLI for the CI telemetry-smoke job:

        python -m repro_torch.obs.export events.jsonl [metrics.prom]

    validates every JSONL line against EVENT_SCHEMA and, when given,
    the Prometheus scrape file against the exposition invariants."""
    if not argv:
        print("usage: python -m repro_torch.obs.export <events.jsonl> "
              "[metrics.prom]")
        return 2
    events = read_events(argv[0])
    kinds: dict[str, int] = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    print(f"{argv[0]}: {len(events)} events OK "
          f"({', '.join(f'{k}={v}' for k, v in sorted(kinds.items()))})")
    if len(argv) > 1:
        with open(argv[1], encoding="utf-8") as fh:
            stats = validate_prometheus_text(fh.read())
        print(f"{argv[1]}: {stats['families']} families, "
              f"{stats['series']} series OK")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main(sys.argv[1:]))
