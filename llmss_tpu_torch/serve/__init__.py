"""Batch serving: wire schema, in-process broker, worker."""
