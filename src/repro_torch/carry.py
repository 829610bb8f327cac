"""Carrying the reference's state across: data and plans.

The system has no weights; what crosses between ``repro`` (JAX) and
``repro_torch`` is the data, as numpy arrays, and the sort plan, as the dict
``SortPlan.to_dict()`` gives.  The dtype is kept exactly, bfloat16 included
(numpy holds it as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses, so it travels as its 16-bit pattern).

``as_tensor`` is how the front doors place numpy arrays and lists: on
``device``, which defaults to the card, and with no card that raises rather
than running on the CPU.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

__all__ = ["as_tensor", "plan_from_reference", "tensor_from_reference", "tensor_to_reference"]

# local-sort names that differ between the packages: the reference's Pallas
# kernel is the port's hand-written CUDA kernel
_IMPL_NAMES = {"pallas": "kernel"}


def tensor_from_reference(a: np.ndarray, device="cuda") -> torch.Tensor:
    """A numpy array as a tensor of the same dtype and bits on ``device``.

    >>> t = tensor_from_reference(np.array([1.5, -0.0], np.float32), "cpu")
    >>> t.dtype, t.tolist()
    (torch.float32, [1.5, -0.0])
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    a = np.require(a, requirements=["C", "W"])  # torch needs writable memory
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_reference(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same dtype and bits (host copy).

    >>> tensor_to_reference(torch.tensor([2, 1], dtype=torch.int32)).tolist()
    [2, 1]
    """
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 type; needed only for this dtype

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def as_tensor(x, device="cuda") -> torch.Tensor:
    """``x`` itself if it is a tensor (it runs where it lives), else ``x`` as
    an array placed on ``device``.

    >>> as_tensor([3, 1], "cpu").tolist()
    [3, 1]
    """
    if isinstance(x, torch.Tensor):
        return x
    return tensor_from_reference(np.asarray(x), device)


def plan_from_reference(d: dict):
    """The port's ``SortPlan`` for a reference ``SortPlan.to_dict()``.

    >>> plan_from_reference({"strategy": "shared", "local_impl": "pallas"}).local_impl
    'kernel'
    """
    from repro_torch.engine.planner import SortPlan  # engine imports this module

    plan = SortPlan.from_dict(d)
    return replace(plan, local_impl=_IMPL_NAMES.get(plan.local_impl, plan.local_impl))
