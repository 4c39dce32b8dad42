"""Resilience layer: durable writes, digests, typed errors, fault and
crash injection, bounded retry, preemption and lease heartbeats."""
