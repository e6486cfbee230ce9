"""The multi-tenant ACAM serving tier: registry, scheduler, spec, service,
control plane."""
