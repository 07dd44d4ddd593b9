"""Model configuration, the unified decoder and the checkpoint registry."""
