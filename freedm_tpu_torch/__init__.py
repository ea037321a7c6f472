"""PyTorch/CUDA port of ``freedm_tpu``: the served dense Newton AC power flow.

This package runs the batched AC power-flow path behind ``POST /v1/pf``
on an NVIDIA Hopper card through hand-written kernels
(:mod:`freedm_tpu_torch.kernels`).  Its modules mirror the JAX
package's names (``grid/bus.py``, ``pf/newton.py``, ``serve/service.py``,
...) so each counterpart is easy to find; inside, it is plain PyTorch:
functions on tensors with an explicit ``device`` and ``dtype``.

Ground rules:

- imports ``torch``, never ``jax``, and nothing of ``freedm_tpu``;
- entry points run on ``cuda`` unless the caller passes
  ``device="cpu"`` (:func:`freedm_tpu_torch.device.resolve_device`);
- on a CUDA tensor a kernel wrapper launches its kernel or raises — the
  plain PyTorch versions beside each kernel run only for CPU tensors.
"""

__version__ = "0.1.0"
