"""The serving tier: the multi-tenant ACAM service (registry, scheduler,
spec, service, control plane), the LM decode engine, and the semantic
cache that puts the first in front of the second."""
