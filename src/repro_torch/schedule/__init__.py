"""repro_torch.schedule -- the exchange-scheduling layer of the round
engine, the port of ``repro.schedule``: WHICH exchange tensor each
client consumes at each step.  Built-ins: sync (paper-literal), stale_k
(ring-buffered stale exchanges), double_buffer (round-pipelined
two-slot), partial (per-round participation masks).  See registry.py
for the spec grammar and engine.py for the impl contract.
"""
from repro_torch.schedule.registry import (  # noqa: F401
    SCHEDULES, Schedule, ScheduleEntry, get_schedule, register_schedule,
    schedule_names,
)
from repro_torch.schedule.engine import (  # noqa: F401
    PARTICIPATION_TAG, DoubleBufferImpl, LaneScheduleImpl,
    make_sched_step_fn, make_schedule_impl, participation_mask,
    promote_sync, stack_lane_states,
)
