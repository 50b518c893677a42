"""repro_torch.faults -- deterministic fault injection, the exchange
guard and divergence recovery: the port of ``repro.faults``.

Spec strings ("crash:0.2+corrupt:0.05", "straggle:0.5:2", ...) parse
into :class:`FaultPlan` records; :func:`make_fault_impl` wraps the
resolved schedule impl so injected adversity rides the round's carried
state; the guard screen is
:func:`repro_torch.core.exchange.screen_exchange`; :class:`RetryPolicy`
drives ``Session.run``'s rollback-and-reseed watchdog.
``fault="none"`` never touches the engine: the protocol keeps its sync
code path, bit for bit.
"""
from repro_torch.faults.engine import (CORRUPT_SCALE, FAULT_TAG, GUARD_MAX,
                                       FaultImpl, make_fault_impl)
from repro_torch.faults.recovery import (RESEED_TAG, DivergenceError,
                                         RetryPolicy, diverged)
from repro_torch.faults.registry import (FAULTS, FaultEntry, FaultPlan,
                                         fault_names, get_fault_plan,
                                         register_fault)

__all__ = [
    "CORRUPT_SCALE", "FAULT_TAG", "GUARD_MAX", "RESEED_TAG",
    "DivergenceError", "FAULTS", "FaultEntry", "FaultImpl",
    "FaultPlan", "RetryPolicy", "diverged", "fault_names",
    "get_fault_plan", "make_fault_impl", "register_fault",
]
