"""Utilities: host-side phase timing."""

from .profiling import PhaseTimer
