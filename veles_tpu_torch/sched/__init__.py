"""Multi-tenant cooperative device scheduler (see scheduler.py).

One device, N tenants, mixed workloads: trainers, the serving planes
and unit-graph workflows time-slice the same device at their natural
dispatch boundaries, with priorities, weighted fair queuing, deadline
boosts and starvation aging — and bit-identical
per-tenant trajectories (leases are revocable only between quanta).
"""

from veles_tpu_torch.sched.scheduler import (DeviceLease, Scheduler,
                                             SchedulerStopped,
                                             TenantHandle,
                                             attach_workflow,
                                             detach_workflow,
                                             quantum_or_null)

__all__ = ["DeviceLease", "Scheduler", "SchedulerStopped",
           "TenantHandle", "attach_workflow", "detach_workflow",
           "quantum_or_null"]
