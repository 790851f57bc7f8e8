"""Distribution and fault tolerance (port of :mod:`repro.distributed`; the
serving part of ``fault`` so far).  The reference's sharding constraints
(``ctx.shard_act``) have no effect on one card and come with the
``distributed/`` slice."""
from .fault import (
    DegradationEvent, Heartbeats, PROFILING_LADDER, ProfilingSupervisor,
    RetryPolicy, StragglerReport, Watchdog, retry_with_backoff,
)

__all__ = ["DegradationEvent", "Heartbeats", "PROFILING_LADDER",
           "ProfilingSupervisor", "RetryPolicy", "StragglerReport",
           "Watchdog", "retry_with_backoff"]
