"""The port's state collection (``freedm_tpu_torch.modules.sc``) against
``freedm_tpu.modules.sc``: ``collect`` (one ``torch.matmul`` of the group
mask with the stacked signals) and ``invariant_total`` within 1e-6
relative in float32 (another summation order), and the snapshot
invariant under migrations (``tests/test_gm_sc_lb.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.modules import sc as ref
from freedm_tpu_torch.modules import lb, sc


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_collect_equals_reference(dtype):
    rng = np.random.default_rng(0)
    n = 40
    g = rng.integers(0, 5, n)
    mask = (g[:, None] == g[None, :]).astype(np.float32)
    sig = [rng.normal(0, 10, n).astype(dtype) for _ in range(6)]
    want = ref.collect(jnp.asarray(mask), *(jnp.asarray(s) for s in sig))
    got = sc.collect(torch.as_tensor(mask), *(torch.as_tensor(s) for s in sig))
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    for name, a, b in zip(ref.CollectedState._fields, want, got):
        if name == "members":
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert b.dtype == torch.int32
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                       atol=rtol * 10 * np.abs(sig[0]).max(),
                                       err_msg=name)
            assert b.dtype == torch.from_numpy(sig[0]).dtype
    np.testing.assert_allclose(sc.invariant_total(got).numpy(),
                               np.asarray(ref.invariant_total(want)),
                               rtol=rtol, atol=rtol * 100)


def test_collect_sums_within_group_only():
    group = np.zeros((4, 4), np.float32)
    group[:2, :2] = 1
    group[2:, 2:] = 1
    z = torch.zeros(4)
    cs = sc.collect(torch.as_tensor(group), torch.tensor([1.0, 2.0, 4.0, 8.0]),
                    z, z, z, z, z)
    np.testing.assert_allclose(cs.gateway.numpy(), [3.0, 3.0, 12.0, 12.0])
    assert cs.members.tolist() == [2, 2, 2, 2]


def test_snapshot_invariant_under_migrations():
    # Σ gateway + Σ in-transit seen by a cut at a round boundary equals
    # the pre-round Σ gateway, for any malicious mix (the Chandy-Lamport
    # channel-state equivalence LB's Synchronize relies on).
    rng = np.random.default_rng(1)
    n = 6
    netgen = rng.normal(0, 4, n).astype(np.float32)
    malicious = (rng.uniform(size=n) < 0.3).astype(np.float32)
    group = torch.ones(n, n)
    gw = torch.zeros(n)
    for _ in range(10):
        before = float(gw.sum())
        out = lb.lb_round(netgen, gw, group, 0.5, malicious=malicious,
                          device="cpu")
        z = torch.zeros(n)
        cs = sc.collect(group, out.gateway, z, z, z, z, out.intransit)
        np.testing.assert_allclose(sc.invariant_total(cs).numpy(),
                                   np.full(n, before), atol=1e-5)
        gw = out.gateway
