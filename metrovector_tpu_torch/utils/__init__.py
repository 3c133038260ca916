"""Host-side utilities: transfer, timing and tracing on the card, filter
planes, logging, tuning hints."""

from .timing import PhaseTimer, device_trace, sync_time

__all__ = ["PhaseTimer", "device_trace", "sync_time"]
