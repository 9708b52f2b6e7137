"""Exact integer products for calibrated int8 inference: int8 operands,
int32 accumulation, on the card and on the CPU alike.

The JAX package computes them with ``lax.dot_general`` and
``lax.conv_general_dilated`` at ``preferred_element_type=int32``
(``analytics_zoo_tpu/inference/calibration.py``), outside any Pallas
kernel, and leaves them to its compiler. Here both go through the
library's int8 GEMM, ``torch._int_mm`` (cuBLASLt on the card; exact int32
accumulation on both devices). No shape ever falls back to a float matmul
or convolution.

``torch._int_mm`` on CUDA takes m > 16 rows, and k and n multiples of 8
(a ResNet-50 stem has k = 7 * 7 * 3 = 147; a batch-1 head has m = 1), with
the first operand row-major and the second column-major. :func:`int8_matmul`
pads with zeros, which is exact, on every device, so the CPU runs the
card's shapes.

A 2-D convolution is im2col then one GEMM (:func:`int8_conv2d`): the
padded int8 input is cut into its kh * kw strided windows, stacked as
(rows, kh * kw * cin) in the HWIO kernel's (kh, kw, cin) order, and
multiplied with the kernel reshaped to (kh * kw * cin, cout). The windows
are strided slices of the int8 tensor itself, so no float copy is made
(PyTorch's CPU ``F.unfold`` refuses int8, and ``F.conv2d`` on int8 wraps
instead of widening).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a @ b_t.T`` in int32, exactly: ``a`` (m, k) int8, ``b_t`` (n, k)
    int8 (the second operand given row by output column). Pads with
    zeros, rows to a multiple of 8 and at least 24 (CUDA takes m > 16), k
    and n to multiples of 8, and calls ``torch._int_mm`` with a row-major
    first and a column-major second operand."""
    if a.dtype != torch.int8 or b_t.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b_t.dtype}")
    m, k = a.shape
    n = b_t.shape[0]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    a = F.pad(a, (0, kp - k, 0, mp - m)) if (mp, kp) != (m, k) else \
        a.contiguous()
    b_t = F.pad(b_t, (0, kp - k, 0, np_ - n)) if (np_, kp) != (n, k) else \
        b_t.contiguous()
    out = torch._int_mm(a, b_t.t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_dense(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq @ wq`` contracting the last dim of ``xq`` (any rank) with the
    first of the (in, out) kernel ``wq``; int8 in, int32 out."""
    lead = xq.shape[:-1]
    y = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq.t())
    return y.reshape(*lead, wq.shape[1])


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, strides: Sequence[int],
                dilation: Sequence[int],
                pads: Sequence[Tuple[int, int]],
                ordering: str = "tf") -> torch.Tensor:
    """A 2-D convolution of int8 ``xq`` (NHWC for ``ordering`` "tf", NCHW
    for "th") with the HWIO int8 kernel ``wq``, accumulated in int32 and
    returned in ``xq``'s layout. ``pads`` is (low, high) per spatial dim,
    applied as zeros (XLA's SAME padding, or none for VALID)."""
    x = xq.permute(0, 2, 3, 1) if ordering == "th" else xq
    (hlo, hhi), (wlo, whi) = pads
    if hlo or hhi or wlo or whi:
        x = F.pad(x, (0, 0, wlo, whi, hlo, hhi))
    kh, kw, cin, cout = wq.shape
    sh, sw = strides
    dh, dw = dilation
    b, h, w, _ = x.shape
    ho = (h - dh * (kh - 1) - 1) // sh + 1
    wo = (w - dw * (kw - 1) - 1) // sw + 1
    windows = [x[:, i * dh: i * dh + sh * (ho - 1) + 1: sh,
                 j * dw: j * dw + sw * (wo - 1) + 1: sw, :]
               for i in range(kh) for j in range(kw)]
    cols = (windows[0] if len(windows) == 1
            else torch.stack(windows, dim=3)).reshape(b * ho * wo,
                                                      kh * kw * cin)
    y = int8_matmul(cols, wq.reshape(kh * kw * cin, cout).t())
    y = y.reshape(b, ho, wo, cout)
    return y.permute(0, 3, 1, 2) if ordering == "th" else y
