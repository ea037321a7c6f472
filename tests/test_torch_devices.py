"""The port's device layer (``freedm_tpu_torch.devices``) against
``freedm_tpu.devices``: the schema compiler, the device tensor's masked
reductions and command writes, and ``net_value`` over a node axis (the
reference's ``vmap``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.core.config import NULL_COMMAND as REF_NULL
from freedm_tpu.core.config import OMEGA_NOMINAL as REF_OMEGA
from freedm_tpu.devices import compile_layout as ref_compile
from freedm_tpu.devices import parse_device_xml as ref_parse
from freedm_tpu.devices import tensor as rdt
from freedm_tpu_torch.core.config import NULL_COMMAND, OMEGA_NOMINAL
from freedm_tpu_torch.devices import compile_layout, parse_device_xml
from freedm_tpu_torch.devices import tensor as dt

DEVICE_XML = """
<root>
  <deviceType><id>Sst</id><state>gateway</state><command>gateway</command></deviceType>
  <deviceType><id>Drer</id><state>generation</state></deviceType>
</root>
"""


def test_constants_match_reference():
    assert NULL_COMMAND == REF_NULL and OMEGA_NOMINAL == REF_OMEGA


def test_schema_compile_and_xml_match_reference():
    types = parse_device_xml(DEVICE_XML)
    assert [t.id for t in types] == ["Sst", "Drer"]
    assert ([(t.id, t.states, t.commands, t.signals) for t in types]
            == [(t.id, t.states, t.commands, t.signals)
                for t in ref_parse(DEVICE_XML)])
    for src in (types, None):
        lay = compile_layout(types) if src else compile_layout()
        want = ref_compile(ref_parse(DEVICE_XML)) if src else ref_compile()
        assert lay.signals == want.signals and lay.type_ids == want.type_ids
        np.testing.assert_array_equal(lay.state_mask, want.state_mask)
        np.testing.assert_array_equal(lay.command_mask, want.command_mask)
    default = compile_layout()
    for t in ("Sst", "Desd", "Drer", "Load", "Fid", "Logger", "Omega"):
        assert t in default.type_ids
    for bad, match in (("<root/>", "no <deviceType>"),
                       ("<root><deviceType><id>X</id></deviceType></root>",
                        "no signals"),
                       ("<root><deviceType><state>a</state></deviceType>"
                        "</root>", "without <id>")):
        with pytest.raises(ValueError, match=match):
            parse_device_xml(bad)


def fleet(lay, rng, cap=8):
    names = ["Sst", "Sst", "Drer", "Drer", "Load"]
    states = rng.normal(0, 5, (len(names), lay.n_signals))
    return names, states


def test_tensor_aggregations_match_reference():
    lay, rlay = compile_layout(), ref_compile()
    sst, drer = lay.type_ids["Sst"], lay.type_ids["Drer"]
    gw, gen = lay.signal_index("gateway"), lay.signal_index("generation")
    rng = np.random.default_rng(0)
    names, states = fleet(lay, rng)
    t = dt.from_host(lay, 8, names, states, device="cpu")
    r = rdt.from_host(rlay, 8, names, states)
    alive = t.alive.clone()
    alive[3] = 0.0  # row 3 dead
    t = t._replace(alive=alive)
    r = r._replace(alive=r.alive.at[3].set(0.0))
    for tid, sig in ((sst, gw), (drer, gen)):
        assert float(dt.net_value(t, tid, sig)) == pytest.approx(
            float(rdt.net_value(r, tid, sig)), rel=1e-6)
        assert int(dt.count_devices(t, tid)) == int(rdt.count_devices(r, tid))
        np.testing.assert_array_equal(dt.type_mask(t, tid).numpy(),
                                      np.asarray(rdt.type_mask(r, tid)))
    rows = np.asarray([1, 0, 1, 1, 1, 0, 0, 0], np.float32)
    for kw in ({}, {"rows": rows}):
        t2 = dt.set_commands(t, sst, gw, 1.5, **{k: torch.as_tensor(v)
                                                 for k, v in kw.items()})
        r2 = rdt.set_commands(r, sst, gw, 1.5, **{k: jnp.asarray(v)
                                                  for k, v in kw.items()})
        np.testing.assert_array_equal(t2.command.numpy(),
                                      np.asarray(r2.command))
        np.testing.assert_array_equal(dt.commanded(t2).numpy(),
                                      np.asarray(rdt.commanded(r2)))
        assert float(dt.commanded(dt.clear_commands(t2)).sum()) == 0.0
    assert float(dt.commanded(t).sum()) == 0.0  # set_commands copies
    with pytest.raises(ValueError, match="exceed capacity"):
        dt.from_host(lay, 2, names, states, device="cpu")


def test_net_value_over_a_node_axis_matches_vmap():
    lay, rlay = compile_layout(), ref_compile()
    rng = np.random.default_rng(1)
    names, _ = fleet(lay, rng)
    n = 6
    states = rng.normal(0, 5, (n, len(names), lay.n_signals))
    ts = [dt.from_host(lay, 8, names, states[k], device="cpu")
          for k in range(n)]
    rs = [rdt.from_host(rlay, 8, names, states[k]) for k in range(n)]
    t = dt.DeviceTensor(*(torch.stack([getattr(x, f) for x in ts])
                          for f in dt.DeviceTensor._fields))
    r = rdt.DeviceTensor(*(jnp.stack([getattr(x, f) for x in rs])
                           for f in rdt.DeviceTensor._fields))
    for tname, sname in (("Drer", "generation"), ("Load", "drain"),
                         ("Sst", "gateway")):
        tid, sig = lay.type_ids[tname], lay.signal_index(sname)
        want = jax.vmap(lambda x: rdt.net_value(x, tid, sig))(r)
        got = dt.net_value(t, tid, sig)
        assert got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_array_equal(
            dt.count_devices(t, tid).numpy(),
            np.asarray(jax.vmap(lambda x: rdt.count_devices(x, tid))(r)))
