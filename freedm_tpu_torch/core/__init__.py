"""Host-side infrastructure: the serve-path metrics registry and the
reference's device-layer constants (:mod:`.config`)."""
