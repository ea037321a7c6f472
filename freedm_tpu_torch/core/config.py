"""Constants of the reference system the port's device layer needs.

The port's own copy of the two constants of ``freedm_tpu/core/config.py``
that :mod:`freedm_tpu_torch.devices` reads.
"""

from __future__ import annotations

# Sentinel for "no command" on a device signal.
# Reference: device::IAdapter NULL_COMMAND = 1e8
# (Broker/src/device/IAdapter.hpp).
NULL_COMMAND: float = 1.0e8

# Nominal system frequency, rad/s. Reference: hard-coded in the LB
# frequency invariant for its 7-node PSCAD model
# (Broker/src/lb/LoadBalance.cpp:1237-1277).
OMEGA_NOMINAL: float = 376.8
