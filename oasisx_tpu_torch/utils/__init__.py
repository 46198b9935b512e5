"""Utilities: timers, profiling."""

from .timers import Timer, profiler_trace, reset_timings, timing, timing_table

__all__ = ["Timer", "profiler_trace", "reset_timings", "timing", "timing_table"]
