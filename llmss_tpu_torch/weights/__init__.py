"""Checkpoint reading (safetensors, pure Python)."""
