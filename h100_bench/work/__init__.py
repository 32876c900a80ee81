"""Least bytes and operations of the benchmark's units of work, counted
from shapes (see ``PERF.md``, "Counting rule")."""
