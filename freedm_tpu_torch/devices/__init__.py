"""The device layer of the port: the schema compiler and the device tensor
(the reference's ``freedm_tpu/devices/schema.py`` and ``tensor.py``)."""

from freedm_tpu_torch.devices.schema import (  # noqa: F401
    DEFAULT_TYPES,
    DeviceType,
    SignalLayout,
    compile_layout,
    parse_device_xml,
)
from freedm_tpu_torch.devices.tensor import DeviceTensor  # noqa: F401
