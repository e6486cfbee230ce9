"""Per-tick energy ledger: the paper's SS V-D attribution, aggregated.

Each `ClassifyResponse` already carries its own energy attribution
(E_backend = ACAM array energy for the rows it searched; E_frontend
added when the cascade escalated to the CNN head; shed responses are
costed ACAM-only — that asymmetry IS the load-shed valve, since
E_backend = 1.45 nJ << E_frontend = 96.23 nJ per the paper). The ledger
folds those per-response joules into per-tenant and fleet-wide totals
with the backend/frontend split preserved, so "what is this fleet
spending per request" is one read instead of a sum over response
objects you had to keep around.

Bit-exactness contract: `add()` accumulates with plain float `+=` in
response order, which is the same left-fold `sum()` performs over the
response list — so `ledger.fleet_j()` equals
`sum(r.energy_j for r in responses)` EXACTLY, not approximately. The
telemetry test asserts `==`, not `pytest.approx`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

NJ = 1e9  # joules -> nanojoules


@dataclass
class _Cell:
    backend_j: float = 0.0
    frontend_j: float = 0.0
    #: accumulated as `+= (backend + frontend)` per response — the same
    #: float op chain as summing `r.energy_j` over the response list, so
    #: it stays bit-exact with that sum (NOT backend_j + frontend_j, which
    #: rounds differently)
    total_j: float = 0.0
    requests: int = 0
    escalated: int = 0
    shed: int = 0


@dataclass
class EnergyLedger:
    """Fleet + per-tenant accumulation of SS V-D energy attributions."""

    _fleet: _Cell = field(default_factory=_Cell)
    _tenants: dict[str, _Cell] = field(default_factory=dict)

    def add(self, tenant_id: str, backend_j: float, frontend_j: float,
            *, escalated: bool = False, shed: bool = False) -> None:
        """Fold one response's attribution in, fleet first then tenant,
        each with a single `+=` per component (see module docstring).
        ``backend_j + frontend_j`` here is the identical float expression
        the service used to build `ClassifyResponse.energy_j`, so the
        running `total_j` reproduces `sum(r.energy_j)` exactly."""
        cell = self._tenants.get(tenant_id)
        if cell is None:
            cell = self._tenants[tenant_id] = _Cell()
        for c in (self._fleet, cell):
            c.backend_j += backend_j
            c.frontend_j += frontend_j
            c.total_j += backend_j + frontend_j
            c.requests += 1
            c.escalated += int(escalated)
            c.shed += int(shed)

    # -- reads ----------------------------------------------------------

    def fleet_j(self) -> float:
        return self._fleet.total_j

    def backend_j(self) -> float:
        return self._fleet.backend_j

    def frontend_j(self) -> float:
        return self._fleet.frontend_j

    def tenant_j(self, tenant_id: str) -> float:
        cell = self._tenants.get(tenant_id)
        return cell.total_j if cell else 0.0

    def fleet(self) -> dict:
        """The operator's one-glance summary (nJ units, like the paper)."""
        c = self._fleet
        n = max(c.requests, 1)
        return {
            "requests": c.requests,
            "escalated": c.escalated,
            "shed": c.shed,
            "backend_nj": c.backend_j * NJ,
            "frontend_nj": c.frontend_j * NJ,
            "total_nj": c.total_j * NJ,
            "nj_per_request": c.total_j * NJ / n,
            "backend_share": (c.backend_j / c.total_j) if c.total_j else 0.0,
        }

    def per_tenant(self) -> dict[str, dict]:
        out = {}
        for tid in sorted(self._tenants):
            c = self._tenants[tid]
            n = max(c.requests, 1)
            out[tid] = {
                "requests": c.requests,
                "escalated": c.escalated,
                "shed": c.shed,
                "backend_nj": c.backend_j * NJ,
                "frontend_nj": c.frontend_j * NJ,
                "total_nj": c.total_j * NJ,
                "nj_per_request": c.total_j * NJ / n,
            }
        return out

    def clear(self) -> None:
        """Ledger totals are counters, so `reset_metrics()` clears them."""
        self._fleet = _Cell()
        self._tenants.clear()
