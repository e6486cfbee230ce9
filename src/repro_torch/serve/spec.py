"""ServiceSpec: ONE declarative value object for the whole hybrid service.

    spec = ServiceSpec(
        registry=RegistrySpec(num_features=784),
        engine=EngineConfig(backend="kernel"),
        scheduler=SchedulerSpec(slots=64),
        cascade=CascadeSpec(tau=8.0, tau_units="count"),
    )
    spec.validate()                         # eager cross-field checks
    svc = HybridService.from_spec(spec)     # repro_torch.serve.control

The tree of NamedTuples is the JAX package's, field for field, so
``spec.to_json()`` is the same text in both packages and a spec file serves
either. Every leaf is a primitive or a NamedTuple of primitives (hashable),
and ``ServiceSpec.from_json(spec.to_json()) == spec``.

Tau carries explicit units (`CascadeSpec.tau_units`): "count" = match-count
margins (0..N, the feature-count backends), "fraction" = matchline-fraction
margins (0..1, the similarity method). The service converts the spec's
units to the backend's native units itself (`tau_scale`).

Not yet in the port: sharding the super-bank over several cards
(``MeshSpec.bank_shards > 1``, the multi-GPU slice) — `validate` raises.
"""
from __future__ import annotations

import json
from typing import NamedTuple

from repro_torch.core.acam import ACAMConfig
from repro_torch.match.config import EngineConfig


class MeshSpec(NamedTuple):
    """How the service's devices are laid out. The port serves from one
    card: ``bank_shards`` must be 1 until the multi-GPU slice, and the
    other fields ride along for the spec's JSON."""

    bank_shards: int = 1  # super-bank class-row shards (model-axis size)
    data_axis: str = "data"
    model_axis: str = "model"
    install: bool = True  # False: run against whatever mesh is installed


class RegistrySpec(NamedTuple):
    """`TemplateBankRegistry` sizing + capacity policy."""

    num_features: int = 64
    k_max: int = 2
    class_bucket: int = 16
    initial_classes: int = 128
    initial_tenants: int = 8


class SchedulerSpec(NamedTuple):
    """`MicroBatchScheduler` knobs (the micro-batch tick size)."""

    slots: int = 64


class CascadeSpec(NamedTuple):
    """Confidence cascade + paper §V-D energy attribution + the overload
    policy. The paper's asymmetry — E_backend (ACAM) is orders of magnitude
    below E_frontend (CNN) — is what makes graceful degradation cheap: when
    the service is overloaded it keeps answering every request from the
    ACAM stage alone (load-shed mode skips the CNN escalation), instead of
    queueing into a latency collapse.

    ``deadline_ms``   per-request deadline: queued requests older than this
                      at tick time are expired with an error response
                      instead of being served uselessly late (None: off).
    ``shed_queue``    queue depth at/past which the service enters load-shed
                      mode — ticks answer from the ACAM stage alone, no
                      escalation dispatch (None: never shed on depth).
    ``shed_p99_ms``   rolling p99 latency budget; exceeding it also enters
                      load-shed mode until the recent window recovers
                      (None: never shed on latency).
    ``backend``       what the expensive escalation stage *is*: "cnn" (the
                      paper's softmax head — `frontend_macs` et al. model
                      its §V-D cost) or "lm" (an LM decode backend
                      behind the semantic cache, a later slice of the port;
                      misses are charged the per-token decode cost model,
                      `core.energy.lm_decode_energy`, instead of the CNN
                      MAC count). Load-shed mode is a "cnn"-only
                      policy: a shed LM request cannot be answered from the
                      ACAM stage alone (there is no cached response for
                      it), so validate() rejects shed knobs under "lm"."""

    tau: float = 8.0  # accept threshold, in tau_units
    tau_units: str = "count"  # "count" (0..N) | "fraction" (0..1)
    max_queue: int = 4096  # admission bound
    frontend_macs: int = 23_785_120
    frontend_sparsity: float = 0.80
    softmax_head_ops: int = 7_850
    paper_faithful: bool = True
    deadline_ms: float | None = None  # per-request queue deadline
    shed_queue: int | None = None  # load-shed on queue depth
    shed_p99_ms: float | None = None  # load-shed on rolling p99
    backend: str = "cnn"  # "cnn" (softmax head) | "lm" (decode engine)


class RouterSpec(NamedTuple):
    """Semantic-cache router policy (the LM slice of the port), active
    when ``cascade.backend == "lm"``. The router fronts the LM decode
    engine with a per-tenant ACAM template bank: a confident match serves
    the cached response; a miss escalates to decode and (policy-gated)
    admits its embedding + response back into the bank.

    ``enabled``            False = escalate-everything shadow mode: every
                           prompt decodes, the match stage still runs (so
                           its telemetry is comparable) but no hit is ever
                           served and no template admitted — the bit-
                           identity baseline against `serve.Engine` alone.
    ``max_templates``      cached-template rows per tenant bank (k = 1).
                           Admission past this evicts the tenant's LRU
                           template (LRU order = the response store's).
    ``response_capacity``  global bound on stored responses; evicting a
                           response invalidates its template row (invariant:
                           a valid template always has a stored response).
    ``admit_on_miss``      False = read-only bank (no template churn).
    ``hit_score``          absolute winner-score floor for serving a hit,
                           as a fraction of a perfect match (0..1], or None
                           to gate on the margin alone. The Eq. 12 margin
                           is *relative*: a one-template bank has no
                           runner-up, so its margin clamps to the window
                           cap and would always read confident — the
                           absolute floor is what keeps a half-matching
                           prompt escalating to decode.
    ``featurizer``         how prompts embed into the matcher's N-feature
                           space: "hashing" (seeded token n-gram feature
                           hashing, dependency-free) or "embedding" (mean-
                           pooled model embedding rows through a seeded
                           random projection — the backbone→ACAM-head path).
    ``featurizer_seed``    seed for the featurizer's hash mix / projection.
    """

    enabled: bool = True
    max_templates: int = 32
    response_capacity: int = 1024
    admit_on_miss: bool = True
    hit_score: float | None = 0.9
    featurizer: str = "hashing"
    featurizer_seed: int = 0


class ObsSpec(NamedTuple):
    """Telemetry knobs for the service's flight recorder
    (`repro_torch.obs`).

    Telemetry is always on — the recorder is how `metrics()`/`health()`
    and the overload policy see anything at all — so this spec only
    shapes it: histogram resolution, the rolling-window length behind
    the shed_p99_ms signal, span sampling, and the optional sinks.

    ``latency_buckets_ms``  upper bounds (ms) of the request-latency
                            histogram; quantiles are exact from these
                            buckets, so resolution == bucket density.
    ``latency_window``      rolling-window length (observations) behind
                            `latency_p50/99_ms` and the shed_p99_ms
                            overload check; survives `reset_metrics()`.
    ``telemetry_dir``       when set, the service appends a JSONL event
                            log (`events.jsonl`: one line per serving
                            tick + every lifecycle event) under this
                            directory. None: no event log.
    ``span_sample``         fraction of requests carrying a full span
                            (deterministic in the request id); span
                            *conservation counters* always run.
    ``profile_annotations`` wrap the fused dispatch in a
                            `torch.profiler.record_function` so device
                            traces show serving-tick boundaries."""

    latency_buckets_ms: tuple = ()  # () -> repro_torch.obs default buckets
    latency_window: int = 256
    telemetry_dir: str | None = None
    span_sample: float = 1.0
    profile_annotations: bool = False


TAU_UNITS = ("count", "fraction")
CASCADE_BACKENDS = ("cnn", "lm")
FEATURIZERS = ("hashing", "embedding")


class ServiceSpec(NamedTuple):
    """The one front door: everything needed to build (and live-retarget)
    a `HybridService`, as a single hashable value."""

    registry: RegistrySpec = RegistrySpec()
    engine: EngineConfig = EngineConfig()
    mesh: MeshSpec = MeshSpec()
    scheduler: SchedulerSpec = SchedulerSpec()
    cascade: CascadeSpec = CascadeSpec()
    obs: ObsSpec = ObsSpec()
    router: RouterSpec = RouterSpec()

    # -- validation ---------------------------------------------------------

    def validate(self) -> "ServiceSpec":
        """Eager cross-field validation; returns self so call sites chain."""
        from repro_torch.match import backend_names
        from repro_torch.match.config import validate as validate_engine

        validate_engine(self.engine, backend_names())
        reg, mesh, sched, casc = (self.registry, self.mesh, self.scheduler,
                                  self.cascade)
        if reg.num_features < 1:
            raise ValueError(f"num_features must be >= 1, got "
                             f"{reg.num_features}")
        if reg.k_max < 1 or reg.class_bucket < 1 or reg.initial_tenants < 1:
            raise ValueError("k_max, class_bucket and initial_tenants must "
                             f"be >= 1, got {reg}")
        if mesh.bank_shards < 1:
            raise ValueError(f"bank_shards must be >= 1, got "
                             f"{mesh.bank_shards}")
        if mesh.bank_shards > 1:
            raise NotImplementedError(
                f"bank_shards={mesh.bank_shards}: sharding the super-bank "
                "over several cards comes with the multi-GPU slice of the "
                "port")
        align = mesh.bank_shards * reg.class_bucket
        if reg.initial_classes < 1 or reg.initial_classes % align:
            raise ValueError(
                f"registry capacity ({reg.initial_classes} classes) must cut "
                f"into {mesh.bank_shards} shards of whole "
                f"{reg.class_bucket}-row buckets (a multiple of {align})")
        if mesh.data_axis == mesh.model_axis:
            raise ValueError(f"mesh axes must differ, got "
                             f"{mesh.data_axis!r} twice")
        if sched.slots < 1:
            raise ValueError(f"slots must be >= 1, got {sched.slots}")
        if casc.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {casc.max_queue}")
        if casc.deadline_ms is not None and casc.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0 (or None), got "
                             f"{casc.deadline_ms}")
        if casc.shed_queue is not None and not (
                1 <= casc.shed_queue <= casc.max_queue):
            raise ValueError(
                f"shed_queue must sit inside the admission bound "
                f"[1, {casc.max_queue}], got {casc.shed_queue} (a shed "
                "threshold past max_queue can never trigger)")
        if casc.shed_p99_ms is not None and casc.shed_p99_ms <= 0:
            raise ValueError(f"shed_p99_ms must be > 0 (or None), got "
                             f"{casc.shed_p99_ms}")
        if casc.backend not in CASCADE_BACKENDS:
            raise ValueError(f"unknown cascade backend {casc.backend!r}; "
                             f"use {CASCADE_BACKENDS}")
        if casc.backend == "lm" and (casc.shed_queue is not None
                                     or casc.shed_p99_ms is not None):
            raise ValueError(
                'cascade.backend="lm" cannot load-shed: a shed request has '
                "no cached response to fall back on (shed_queue and "
                "shed_p99_ms must be None; bound load with max_queue / "
                "deadline_ms instead)")
        rtr = self.router
        if rtr.max_templates < 1:
            raise ValueError(f"router.max_templates must be >= 1, got "
                             f"{rtr.max_templates}")
        if rtr.response_capacity < rtr.max_templates:
            raise ValueError(
                f"router.response_capacity ({rtr.response_capacity}) below "
                f"max_templates ({rtr.max_templates}): a single tenant's "
                "bank could hold templates whose responses were evicted")
        if rtr.hit_score is not None and not 0.0 < rtr.hit_score <= 1.0:
            raise ValueError(f"router.hit_score must be in (0, 1] or None, "
                             f"got {rtr.hit_score}")
        if rtr.featurizer not in FEATURIZERS:
            raise ValueError(f"unknown router featurizer "
                             f"{rtr.featurizer!r}; use {FEATURIZERS}")
        if casc.tau_units not in TAU_UNITS:
            raise ValueError(f"unknown tau_units {casc.tau_units!r}; "
                             f"use {TAU_UNITS}")
        cap = (float(reg.num_features)
               if self.native_tau_units == "count" else 1.0)
        if casc.tau * self.tau_scale() > cap:
            raise ValueError(
                f"tau={casc.tau} {casc.tau_units} converts past the "
                f"served margin cap ({cap} {self.native_tau_units}); every "
                "request would escalate")
        if not 0.0 <= casc.frontend_sparsity <= 1.0:
            raise ValueError(f"frontend_sparsity must be in [0, 1], got "
                             f"{casc.frontend_sparsity}")
        obs = self.obs
        b = obs.latency_buckets_ms
        if b and (list(b) != sorted(set(b)) or b[0] <= 0):
            raise ValueError(
                f"latency_buckets_ms must be strictly increasing and "
                f"positive, got {b}")
        if obs.latency_window < 1:
            raise ValueError(f"latency_window must be >= 1, got "
                             f"{obs.latency_window}")
        if not 0.0 <= obs.span_sample <= 1.0:
            raise ValueError(f"span_sample must be in [0, 1], got "
                             f"{obs.span_sample}")
        dev = self.engine.device or ACAMConfig()
        if (self.engine.backend == "device" and mesh.bank_shards > 1
                and dev.sigma_program > 0.0
                and self.engine.device_noise != "per_shard"):
            raise ValueError(
                f"device backend with sigma_program={dev.sigma_program} "
                f"cannot shard the bank over {mesh.bank_shards} shards "
                'under device_noise="global" (one physical array draws one '
                'noise field); set engine.device_noise="per_shard" to '
                "program one array per shard")
        hash(self)  # fail fast: specs must stay usable as cache/jit keys
        return self

    # -- unit conversion ----------------------------------------------------

    @property
    def native_tau_units(self) -> str:
        """The units the served margins actually arrive in: matchline
        fractions (0..1) for the device backend and the similarity method,
        match counts (0..N) for the digital feature-count paths."""
        if self.engine.backend == "device" \
                or self.engine.method == "similarity":
            return "fraction"
        return "count"

    def tau_scale(self) -> float:
        """Multiplier taking a tau in `cascade.tau_units` to native units."""
        given, native = self.cascade.tau_units, self.native_tau_units
        if given == native:
            return 1.0
        n = float(self.registry.num_features)
        return 1.0 / n if native == "fraction" else n

    # -- JSON ---------------------------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "registry": self.registry._asdict(),
            "engine": self.engine._asdict(),
            "mesh": self.mesh._asdict(),
            "scheduler": self.scheduler._asdict(),
            "cascade": self.cascade._asdict(),
            "obs": self.obs._asdict(),
            "router": self.router._asdict(),
        }
        eng = d["engine"]
        if eng["block"] is not None:
            eng["block"] = list(eng["block"])
        if eng["device"] is not None:
            eng["device"] = self.engine.device._asdict()
        d["obs"]["latency_buckets_ms"] = list(self.obs.latency_buckets_ms)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceSpec":
        eng = dict(d.get("engine", {}))
        if eng.get("block") is not None:
            eng["block"] = tuple(int(b) for b in eng["block"])
        if eng.get("device") is not None:
            eng["device"] = ACAMConfig(**eng["device"])
        obs = dict(d.get("obs", {}))
        if "latency_buckets_ms" in obs:
            obs["latency_buckets_ms"] = tuple(
                float(x) for x in obs["latency_buckets_ms"])
        return cls(
            registry=RegistrySpec(**d.get("registry", {})),
            engine=EngineConfig(**eng),
            mesh=MeshSpec(**d.get("mesh", {})),
            scheduler=SchedulerSpec(**d.get("scheduler", {})),
            cascade=CascadeSpec(**d.get("cascade", {})),
            obs=ObsSpec(**obs),
            router=RouterSpec(**d.get("router", {})),
        )

    def to_json(self, *, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ServiceSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "ServiceSpec":
        with open(path) as f:
            return cls.from_json(f.read())


def aligned_classes(bank_shards: int, *, class_bucket: int = 16,
                    base: int = 128) -> int:
    """The registry's default class capacity (``base``) rounded up to cut
    into ``bank_shards`` shards of whole ``class_bucket``-row buckets."""
    align = max(1, bank_shards) * class_bucket
    return -(-base // align) * align
