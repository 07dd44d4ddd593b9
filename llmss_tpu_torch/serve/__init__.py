"""Serving: wire schema, brokers (in-process and Redis), workers,
supervisor, and the HTTP producer."""
