"""Runtime bring-up (port of ``analytics_zoo_tpu.common.nncontext``).

One global context, created idempotently under a lock, holding the device,
the dtype policy, a root ``torch.Generator`` seeded from the config (the
parameters' draws) and the step generator (the training draws, dropout).
The default device is ``cuda``; without a card, ``init_nncontext()`` raises
rather than carrying on quietly on the CPU. Pass ``device="cpu"`` to run
there on purpose.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

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
    """Global runtime context: device + dtype policy + root and step
    generators."""

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
        logger.info("Initialized NNContext on %s", self.device)


def init_nncontext(conf: Optional[ZooConfig] = None, **kwargs) -> NNContext:
    """Create (or fetch) the global :class:`NNContext`.

    Extra ``kwargs`` override :class:`ZooConfig` fields, e.g.
    ``init_nncontext(device="cpu", seed=3)``.
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
