"""Host runtime pieces of the port (only the checkpoint file format so far)."""
