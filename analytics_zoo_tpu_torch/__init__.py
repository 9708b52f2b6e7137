"""analytics_zoo_tpu_torch — the PyTorch/CUDA port of analytics_zoo_tpu.

Module paths and class names mirror the JAX package so each counterpart is
easy to find (``analytics_zoo_tpu.X.Y`` ↔ ``analytics_zoo_tpu_torch.X.Y``).
The port imports torch and numpy only; it never imports jax or the JAX
package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.

Ported so far: BERT-base serving — the context, the layer base, Dense,
the attention stack, ``BERTClassifierNet`` and ``InferenceModel`` — with
attention on a hand-written CUDA flash-attention forward kernel
(``csrc/flash_attention_fwd.cu``).
"""

__version__ = "0.1.0"

from analytics_zoo_tpu_torch.common.nncontext import (
    get_nncontext,
    init_nncontext,
    stop_nncontext,
)

__all__ = ["init_nncontext", "get_nncontext", "stop_nncontext",
           "__version__"]
