"""Runtime bring-up (port of ``analytics_zoo_tpu.common.nncontext``).

One global context, created idempotently under a lock, holding the device,
the in-process mesh (:class:`~analytics_zoo_tpu_torch.mesh.slots.SlotMesh`:
``mesh_shape`` slots dealt over the context's device kind, one slot by
default), the dtype policy, a root ``torch.Generator`` seeded from the
config (the parameters' draws) and the step generator (the training draws,
dropout).
The default device is ``cuda``; without a card, ``init_nncontext()`` raises
rather than carrying on quietly on the CPU. Pass ``device="cpu"`` to run
there on purpose.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.config import ZooConfig

logger = logging.getLogger("analytics_zoo_tpu_torch")

_CONTEXT_LOCK = threading.Lock()
_GLOBAL_CONTEXT: Optional["NNContext"] = None


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype '{name}'")
    return dt


class NNContext:
    """Global runtime context: device + slot mesh + dtype policy + root and
    step generators."""

    def __init__(self, conf: Optional[ZooConfig] = None):
        self.conf = conf or ZooConfig()
        self.device = torch.device(self.conf.device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "init_nncontext: CUDA is not available; pass device='cpu' "
                "to run the port on the CPU")
        # Full-precision float32: no TF32 in matmuls or cuDNN convolutions
        # (the JAX package's f32 numerics are the reference).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from analytics_zoo_tpu_torch.mesh.slots import SlotMesh

        self.mesh = SlotMesh.deal(self.conf.mesh_shape,
                                  self.conf.mesh_axis_names, self.device)
        # the slot count: what batch geometry divides by, as the JAX
        # package's divides by its mesh's devices
        self.num_devices = self.mesh.size
        self.default_dtype = _torch_dtype(self.conf.default_dtype)
        self.param_dtype = _torch_dtype(self.conf.param_dtype)
        # A CPU generator: the same seed gives the same weights whichever
        # device the model is served on.
        self.generator = torch.Generator().manual_seed(int(self.conf.seed))
        # The stream of training draws, standing in for the JAX package's
        # next_rng_key(s): one generator on the device, so a dropout mask
        # is drawn where it is used; its position is saved and restored
        # with step_generator.get_state() / set_state().
        self.step_generator = torch.Generator(
            device=self.device).manual_seed(int(self.conf.seed))
        logger.info("Initialized NNContext on %s, mesh %s", self.device,
                    self.mesh)

    @property
    def data_axis(self) -> str:
        """Name of the mesh axis batches shard over (the first)."""
        return self.mesh.axis_names[0]


def host_to_device(a, device) -> torch.Tensor:
    """A new tensor on ``device`` holding the host array ``a``: a copy,
    never an alias (the caller may reuse its arrays at once), with float64
    made float32 as the JAX package makes it (x64 off). Integer dtypes stay
    as they are: the losses and the embedding lookup take int64."""
    arr = np.asarray(a)
    return torch.tensor(arr, device=device, dtype=(
        torch.float32 if arr.dtype == np.float64 else None))


def init_nncontext(conf: Optional[ZooConfig] = None, **kwargs) -> NNContext:
    """Create (or fetch) the global :class:`NNContext`.

    Extra ``kwargs`` override :class:`ZooConfig` fields, e.g.
    ``init_nncontext(device="cpu", seed=3)`` or, for eight CPU slots,
    ``init_nncontext(device="cpu", mesh_shape=(2, 1, 4),
    mesh_axis_names=("data", "model", "seq"))``.
    """
    global _GLOBAL_CONTEXT
    with _CONTEXT_LOCK:
        if _GLOBAL_CONTEXT is not None:
            if conf is not None or kwargs:
                logger.warning(
                    "init_nncontext called again; returning existing context "
                    "(new conf ignored)")
            return _GLOBAL_CONTEXT
        if conf is None:
            conf = ZooConfig(**kwargs)
        elif kwargs:
            conf = conf.replace(**kwargs)
        _GLOBAL_CONTEXT = NNContext(conf)
        return _GLOBAL_CONTEXT


def get_nncontext() -> NNContext:
    """Return the global context, creating a default one if needed."""
    if _GLOBAL_CONTEXT is None:
        return init_nncontext()
    return _GLOBAL_CONTEXT


def stop_nncontext() -> None:
    """Drop the global context (mainly for tests)."""
    global _GLOBAL_CONTEXT
    with _CONTEXT_LOCK:
        _GLOBAL_CONTEXT = None
