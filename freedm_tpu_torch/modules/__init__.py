"""On-device DGI modules of the port (so far: gradient Volt-VAR control)."""
