"""Device-class schema and tensor-layout compiler.

Port of ``freedm_tpu/devices/schema.py``: the reference's ``device.xml``
device classes (``CDeviceBuilder``, ``Broker/src/device/
CDeviceBuilder.hpp:46-67``) compile into a *tensor layout* — a global
signal vocabulary (columns) plus per-type signal masks — so a whole fleet
of devices is one padded ``[device, signal]`` tensor with masks
(:mod:`freedm_tpu_torch.devices.tensor`).  Host-side: numpy only.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np

from freedm_tpu_torch.utils.textio import read_source


@dataclass(frozen=True)
class DeviceType:
    """One device class: its state and command signal names.

    Reference: ``<deviceType><id>Sst</id><state>gateway</state>...``.
    A signal may be both state and command (e.g. Sst gateway).
    """

    id: str
    states: Tuple[str, ...] = ()
    commands: Tuple[str, ...] = ()

    @property
    def signals(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(self.states + self.commands))


# The reference's sample device classes (device.xml), used as defaults so
# in-process setups need no XML file.  The per-phase Sst_x/Pload_x types
# are the VVC deployment's additions (``Broker_s1/config/device.xml``).
DEFAULT_TYPES: Tuple[DeviceType, ...] = (
    DeviceType("Sst", states=("gateway",), commands=("gateway",)),
    DeviceType("Desd", states=("storage",), commands=("storage",)),
    DeviceType("Drer", states=("generation",)),
    DeviceType("Load", states=("drain",)),
    DeviceType("Fid", states=("state",)),
    DeviceType("Logger", states=("dgiEnable",), commands=("groupStatus",)),
    DeviceType("Omega", states=("frequency",)),
    DeviceType("Sst_a", states=("gateway",), commands=("gateway",)),
    DeviceType("Sst_b", states=("gateway",), commands=("gateway",)),
    DeviceType("Sst_c", states=("gateway",), commands=("gateway",)),
    DeviceType("Pload_a", states=("pload",), commands=("pload",)),
    DeviceType("Pload_b", states=("pload",), commands=("pload",)),
    DeviceType("Pload_c", states=("pload",), commands=("pload",)),
)


def read_xml_source(source: Union[str, Path]) -> str:
    """Accept a path or raw XML text; return the XML text."""
    return read_source(source, "<")


def parse_device_xml(source: Union[str, Path]) -> Tuple[DeviceType, ...]:
    """Parse a reference-format ``device.xml`` (a path or raw XML text)
    into device types."""
    root = ET.fromstring(read_xml_source(source))
    types = []
    for node in root.findall("deviceType"):
        tid = node.findtext("id")
        if not tid:
            raise ValueError("deviceType without <id>")
        states = tuple(e.text for e in node.findall("state"))
        commands = tuple(e.text for e in node.findall("command"))
        if not states and not commands:
            raise ValueError(f"device type {tid!r} has no signals")
        types.append(DeviceType(tid, states, commands))
    if not types:
        raise ValueError("no <deviceType> entries found")
    return tuple(types)


@dataclass(frozen=True)
class SignalLayout:
    """Compiled tensor layout for a set of device types.

    - ``signals``: global column vocabulary (union of all signals);
    - ``type_ids``: type name → small int;
    - ``state_mask`` / ``command_mask``: ``[n_types, n_signals]`` 0/1 —
      which columns exist (as state / as command) for each type.
    """

    types: Tuple[DeviceType, ...]
    signals: Tuple[str, ...]
    type_ids: Dict[str, int] = field(default_factory=dict)
    state_mask: np.ndarray = None
    command_mask: np.ndarray = None

    @property
    def n_signals(self) -> int:
        return len(self.signals)

    @property
    def n_types(self) -> int:
        return len(self.types)

    def type_of(self, name: str) -> DeviceType:
        return self.types[self.type_ids[name]]

    def signal_index(self, signal: str) -> int:
        return self.signals.index(signal)


def compile_layout(types: Tuple[DeviceType, ...] = DEFAULT_TYPES) -> SignalLayout:
    """Compile device types into a :class:`SignalLayout`."""
    ids = {t.id: i for i, t in enumerate(types)}
    if len(ids) != len(types):
        raise ValueError("duplicate device type id")
    signals = list(dict.fromkeys(s for t in types for s in t.signals))
    smask = np.zeros((len(types), len(signals)), dtype=np.float32)
    cmask = np.zeros((len(types), len(signals)), dtype=np.float32)
    for i, t in enumerate(types):
        for s in t.states:
            smask[i, signals.index(s)] = 1.0
        for s in t.commands:
            cmask[i, signals.index(s)] = 1.0
    return SignalLayout(
        types=tuple(types),
        signals=tuple(signals),
        type_ids=ids,
        state_mask=smask,
        command_mask=cmask,
    )
