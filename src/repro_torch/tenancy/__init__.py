"""Multi-tenant QoS serving subsystem (DESIGN.md §8; port of
``repro.tenancy``).

PFCS makes tenant isolation a *theorem* instead of a policy: every
tenant draws its primes from a disjoint family of contiguous value
blocks (:class:`~repro_torch.tenancy.namespace.TenantNamespace`), so the gcd
of any two tenants' composites is identically 1 and no composite can
ever encode a cross-tenant relationship — discovery, and therefore
prefetch, cannot leak across tenants by construction.

On top of the namespace layer, :mod:`repro_torch.tenancy.qos` enforces
per-tenant HBM-page and prefetch-budget quotas as int32 array state
inside the serving caches (scalar oracle twin kept bit-exact), and
``ServingEngine(tenants=...)`` / ``SlotMachine(tenants=...)`` thread
per-request tenant ids through the continuous-batching loop.  Every
cache takes ``device`` (default ``"cuda"``): the sharded and elastic
tenanted caches rebuild their successor tables through the discovery
kernels there.
"""

from .namespace import (IsolationReport, StripedPrimePool, TenantAssigner,
                        TenantNamespace)
from .qos import (QuotaState, TenantQoSConfig, TenantedExpertCache,
                  TenantedPagedKVCache, TenantedShardedPagedKVCache,
                  TenantedVectorizedExpertCache,
                  TenantedVectorizedPagedKVCache, weighted_quotas)

__all__ = [
    "TenantNamespace", "TenantAssigner", "StripedPrimePool",
    "IsolationReport",
    "TenantQoSConfig", "QuotaState", "weighted_quotas",
    "TenantedPagedKVCache", "TenantedVectorizedPagedKVCache",
    "TenantedShardedPagedKVCache",
    "TenantedExpertCache", "TenantedVectorizedExpertCache",
]
