"""Host-side helpers shared by the serving modules."""
