"""Dense ring-buffer KV cache and the decode engine."""
