"""Host-side infrastructure: the serve-path metrics registry."""
