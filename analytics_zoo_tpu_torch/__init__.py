"""analytics_zoo_tpu_torch — the PyTorch/CUDA port of analytics_zoo_tpu.

Module paths and class names mirror the JAX package so each counterpart is
easy to find (``analytics_zoo_tpu.X.Y`` ↔ ``analytics_zoo_tpu_torch.X.Y``).
The port imports torch and numpy only; it never imports jax or the JAX
package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.

Ported so far: BERT-base serving and training — the context, the layer
base, Dense, the attention stack, ``BERTClassifierNet``, ``InferenceModel``,
and the training surface (objectives, SGD/Adam, metrics, triggers, feature
sets, ``Estimator.train``, ``KerasNet.compile``/``fit``) — with attention on
hand-written CUDA flash-attention kernels, forward
(``csrc/flash_attention_fwd.cu``) and backward (``csrc/flash_attention_bwd.cu``:
dq; dk, dv and dbias); and ResNet-50 and LeNet-5 training and serving — the
functional graph (``Input``, ``Model``, ``Sequential``), convolution,
pooling, core layers and batch norm with its moving statistics as model
state, on PyTorch's cuDNN and cuBLAS calls.
"""

__version__ = "0.1.0"

from analytics_zoo_tpu_torch.common.nncontext import (
    get_nncontext,
    init_nncontext,
    stop_nncontext,
)

__all__ = ["init_nncontext", "get_nncontext", "stop_nncontext",
           "__version__"]
