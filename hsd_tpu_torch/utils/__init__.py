"""Telemetry and profiling utilities."""
from .profiling import StageClock, Timer, trace

__all__ = ["StageClock", "Timer", "trace"]
