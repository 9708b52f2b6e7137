"""Recurrent layers (port of ``analytics_zoo_tpu.keras.layers.recurrent``):
``SimpleRNN``, ``LSTM``, ``GRU``, ``ConvLSTM2D``, the ``Bidirectional``
and ``TimeDistributed`` wrappers, and the module's two dense layers,
``Highway`` and ``MaxoutDense``.

Keras-1 semantics, as in the JAX package: input (batch, time, dim);
``return_sequences``; activation tanh and inner activation hard_sigmoid
(``clip(0.2 x + 0.5, 0, 1)``); LSTM gates in the order i, f, c, o with
the forget-gate bias initialised to 1; GRU gates z, r, h, by default with
the split recurrent kernels ``U`` (z, r) and ``U_h`` (h), or with
``reset_after=True`` the tf.keras layout (one ``U`` and a recurrent bias
``b_rec``). PyTorch's ``nn.LSTM``/``nn.GRU`` (and cuDNN's RNN) use the
sigmoid and other gate layouts, so they cannot compute these cells: each
step is written out from the JAX ``step``.

:meth:`_RNNBase.run` hoists the input projection out of the time loop (one
``(B*T, D) x (D, G*U)`` matmul), then runs the cell once per step in a
Python loop with the carry in and out explicit, as the JAX ``lax.scan``
body does. ``go_backwards`` runs the reversed sequence and returns the
outputs in scan order. A timestep ``mask`` (B, T), 1 = valid, holds the
state at masked steps and repeats the previous output there, with the
JAX package's arithmetic blend ``m * new + (1 - m) * old`` (not a select:
the parity tests hold carries to the JAX package within a tolerance, and
a select would differ from the blend in the sign of a zero).

Dtypes follow the JAX package's promotion: the initial carry is float32
whatever the compute dtype, so under bf16 compute the input projection is
bf16 and the recurrence (the carry times the bf16 recurrent kernels, the
gates, the outputs) runs in float32.

``ConvLSTM2D`` takes (batch, time, channels, H, W) and runs its gates as
two SAME convolutions a step, the input's hoisted out of the time loop
(one convolution over batch x time) and the carry's once per step in a
Python loop with no host read, so a CUDA graph can capture it. Its
carry is float32 as the JAX package's ``jnp.zeros`` carry is, so under
bf16 compute the recurrence runs in float32 and the layer returns
float32: the carry meets the bf16 recurrent kernel through the
convolutions' promotion (``keras.layers.convolutional``). JAX's own layer
raises there (``lax.conv_general_dilated`` takes one dtype): the port
follows what ``jnp`` promotion gives.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.tree import tree_map
from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Shape,
    mask_pair_main_shape,
)
from analytics_zoo_tpu_torch.keras.layers.convolutional import (
    _conv_weight,
    _padding,
)
from analytics_zoo_tpu_torch.keras.layers.core import (
    get_activation,
    matmul,
    promoted,
)


class _RNNBase(KerasLayer):
    n_gates = 1

    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 go_backwards=False, W_regularizer=None, U_regularizer=None,
                 b_regularizer=None, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.output_dim = int(output_dim)
        self.activation = get_activation(activation)
        self.inner_activation = get_activation(inner_activation)
        self.activation_name = (activation if isinstance(activation, str)
                                else None)
        self.inner_activation_name = (inner_activation
                                      if isinstance(inner_activation, str)
                                      else None)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.W_regularizer = W_regularizer
        self.U_regularizer = U_regularizer
        self.b_regularizer = b_regularizer

    def _weight(self, name, shape, init):
        """``add_weight`` with the regularizer of the leaf's kind (W, U or
        b)."""
        reg = {"W": self.W_regularizer, "U": self.U_regularizer,
               "b": self.b_regularizer}[name[0]]
        self.add_weight(name, shape, init, regularizer=reg)

    @staticmethod
    def _main_shape(input_shape: Shape) -> Shape:
        return mask_pair_main_shape(input_shape)

    @staticmethod
    def _split_mask(x):
        """Unpack a ``[x, mask]`` input pair; mask is (B, T), 1 = valid."""
        if isinstance(x, (list, tuple)):
            if len(x) != 2:
                raise ValueError(
                    f"RNN layers take one input or [x, mask]; got {len(x)}")
            return x[0], x[1]
        return x, None

    def build(self, input_shape: Shape):
        dim = self._main_shape(input_shape)[-1]
        u = self.output_dim
        self._weight("W", (dim, self.n_gates * u), "glorot_uniform")
        self._weight("U", (u, self.n_gates * u), "orthogonal")
        self._weight("b", (self.n_gates * u,), self._bias_init())

    def _bias_init(self):
        return "zeros"

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        input_shape = self._main_shape(input_shape)
        if self.return_sequences:
            return (input_shape[0], input_shape[1], self.output_dim)
        return (input_shape[0], self.output_dim)

    def initial_carry(self, batch: int, device=None,
                      dtype=torch.float32):
        """Zero carry for ``batch`` rows (a tensor, or LSTM's (h, c))."""
        raise NotImplementedError

    def step(self, params, carry, z):
        """One cell step. ``z`` is this timestep's input projection
        (batch, n_gates * units). Returns (new_carry, output)."""
        raise NotImplementedError

    def run(self, params, x, carry0=None, mask=None):
        """The whole sequence with explicit carry in and out: returns
        (outputs (B, T, U), final carry). Seq2seq passes encoder state to
        the decoder through it. With ``go_backwards`` the sequence runs
        reversed and the outputs come in scan order (reversed time).

        ``mask`` (B, T), 1 = valid: at a masked step the state is held and
        the output repeats the previous one, so the final carry and the
        last output are those of the last valid step."""
        if self.go_backwards:
            x = x.flip(1)
            if mask is not None:
                mask = mask.flip(1)
        # the input projection of every step in one matmul
        z_all = matmul(x, params["W"]) + params["b"]
        if carry0 is None:
            carry0 = self.initial_carry(x.shape[0], x.device)
        carry, ys = carry0, []
        if mask is None:
            for t in range(z_all.shape[1]):
                carry, y = self.step(params, carry, z_all[:, t])
                ys.append(y)
            return torch.stack(ys, dim=1), carry
        m_t = mask.to(z_all.dtype)
        y = torch.zeros((x.shape[0], self.output_dim), dtype=z_all.dtype,
                        device=x.device)
        for t in range(z_all.shape[1]):
            mb = m_t[:, t, None]
            new_carry, y_new = self.step(params, carry, z_all[:, t])
            carry = tree_map(lambda n, o: mb * n + (1.0 - mb) * o,
                             new_carry, carry)
            y = mb * y_new + (1.0 - mb) * y
            ys.append(y)
        return torch.stack(ys, dim=1), carry

    def step_once(self, params, carry, x_t):
        """Single timestep on (B, D) input — the greedy-decode
        primitive."""
        z = matmul(x_t, params["W"]) + params["b"]
        return self.step(params, carry, z)

    def call(self, params, x, **kw):
        x, mask = self._split_mask(x)
        ys, _ = self.run(params, x, mask=mask)
        if self.return_sequences:
            return ys
        return ys[:, -1]


def _zeros(batch, units, device, dtype):
    return torch.zeros((batch, units), device=device, dtype=dtype)


class SimpleRNN(_RNNBase):
    n_gates = 1

    def initial_carry(self, batch, device=None, dtype=torch.float32):
        return _zeros(batch, self.output_dim, device, dtype)

    def step(self, params, h, z):
        h_new = self.activation(z + matmul(h, params["U"]))
        return h_new, h_new


class LSTM(_RNNBase):
    """Ref keras/layers/LSTM.scala. Gate order i, f, c, o (Keras-1)."""

    n_gates = 4

    def _bias_init(self):
        u = self.output_dim

        def init(generator, shape, dtype=torch.float32):
            b = torch.zeros(shape, dtype=dtype)
            b[u:2 * u] = 1.0  # forget-gate bias 1
            return b

        return init

    def initial_carry(self, batch, device=None, dtype=torch.float32):
        return (_zeros(batch, self.output_dim, device, dtype),
                _zeros(batch, self.output_dim, device, dtype))

    def step(self, params, carry, z):
        h, c = carry
        u = self.output_dim
        z = z + matmul(h, params["U"])
        i = self.inner_activation(z[:, :u])
        f = self.inner_activation(z[:, u:2 * u])
        g = self.activation(z[:, 2 * u:3 * u])
        o = self.inner_activation(z[:, 3 * u:])
        c_new = f * c + i * g
        h_new = o * self.activation(c_new)
        return (h_new, c_new), h_new


class GRU(_RNNBase):
    """Ref keras/layers/GRU.scala. Gate order z, r, h (Keras-1 semantics
    by default). ``reset_after=True`` is the tf.keras-default variant
    (separate input and recurrent biases; the reset gate applies after the
    recurrent matmul)."""

    n_gates = 3

    def __init__(self, output_dim: int, *args, reset_after: bool = False,
                 **kw):
        super().__init__(output_dim, *args, **kw)
        self.reset_after = reset_after

    def build(self, input_shape: Shape):
        dim = self._main_shape(input_shape)[-1]
        u = self.output_dim
        self._weight("W", (dim, 3 * u), "glorot_uniform")
        if self.reset_after:
            # the full recurrent kernel and a separate recurrent bias; run()
            # hoists x @ W + b, so b stays the input bias
            self._weight("U", (u, 3 * u), "orthogonal")
            self._weight("b", (3 * u,), "zeros")
            self._weight("b_rec", (3 * u,), "zeros")
        else:
            self._weight("U", (u, 2 * u), "orthogonal")
            self._weight("U_h", (u, u), "orthogonal")
            self._weight("b", (3 * u,), "zeros")

    def initial_carry(self, batch, device=None, dtype=torch.float32):
        return _zeros(batch, self.output_dim, device, dtype)

    def step(self, params, h, zin):
        u = self.output_dim
        if self.reset_after:
            rec = matmul(h, params["U"]) + params["b_rec"]
            z_gate = self.inner_activation(zin[:, :u] + rec[:, :u])
            r_gate = self.inner_activation(zin[:, u:2 * u] + rec[:, u:2 * u])
            hh = self.activation(zin[:, 2 * u:] + r_gate * rec[:, 2 * u:])
            h_new = z_gate * h + (1.0 - z_gate) * hh
            return h_new, h_new
        rz = zin[:, :2 * u] + matmul(h, params["U"])
        z_gate = self.inner_activation(rz[:, :u])
        r_gate = self.inner_activation(rz[:, u:])
        hh = self.activation(zin[:, 2 * u:]
                             + matmul(r_gate * h, params["U_h"]))
        h_new = z_gate * h + (1.0 - z_gate) * hh
        return h_new, h_new


class Highway(KerasLayer):
    """Gated identity-transform layer: ``t * act(x W + b) + (1 - t) * x``
    with the gate ``t = sigmoid(x W_carry + b_carry)``, ``b_carry``
    initialised to -2."""

    def __init__(self, activation=None, bias=True, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.activation = get_activation(activation)
        self.bias = bias

    def build(self, input_shape: Shape):
        d = input_shape[-1]
        self.add_weight("W", (d, d), "glorot_uniform")
        self.add_weight("W_carry", (d, d), "glorot_uniform")
        if self.bias:
            self.add_weight("b", (d,), "zeros")
            self.add_weight("b_carry", (d,),
                            lambda generator, shape, dtype=torch.float32:
                            torch.full(shape, -2.0, dtype=dtype))

    def call(self, params, x, **kw):
        t = matmul(x, params["W_carry"])
        h = matmul(x, params["W"])
        if self.bias:
            t = t + params["b_carry"]
            h = h + params["b"]
        t = torch.sigmoid(t)
        return t * self.activation(h) + (1.0 - t) * x


class MaxoutDense(KerasLayer):
    """The max over ``nb_feature`` dense maps: leaves ``W`` (nb_feature,
    in, out) and ``b`` (nb_feature, out)."""

    def __init__(self, output_dim: int, nb_feature: int = 4, bias=True,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.bias = bias

    def build(self, input_shape: Shape):
        d = input_shape[-1]
        self.add_weight("W", (self.nb_feature, d, self.output_dim),
                        "glorot_uniform")
        if self.bias:
            self.add_weight("b", (self.nb_feature, self.output_dim),
                            "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], self.output_dim)

    def call(self, params, x, **kw):
        y = matmul(x[:, None, None, :], params["W"][None])[:, :, 0]
        if self.bias:
            y = y + params["b"]
        return torch.amax(y, dim=1)


class ConvLSTM2D(KerasLayer):
    """Convolutional LSTM over (batch, time, channels, H, W) ("th"), SAME
    padding and stride 1 as BigDL's: leaves ``W`` (k, k, C, 4F) and ``U``
    (k, k, F, 4F) in HWIO, ``b`` (4F,); gates i, f, c, o; the default
    inner activation is Keras's ``hard_sigmoid``, not ``F.hardsigmoid``.
    See the module docstring for the hoisted input convolution and the
    float32 carry."""
    rank = 2

    def __init__(self, nb_filter: int, nb_kernel: int, activation="tanh",
                 inner_activation="hard_sigmoid", border_mode="same",
                 subsample=1, return_sequences=False, go_backwards=False,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter = int(nb_filter)
        self.nb_kernel = int(nb_kernel)
        self.activation = get_activation(activation)
        self.inner_activation = get_activation(inner_activation)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        if border_mode != "same" or subsample != 1:
            raise NotImplementedError(
                f"{type(self).__name__} supports same/stride-1 (as BigDL)")

    def build(self, input_shape: Shape):
        c, k, f = input_shape[2], self.nb_kernel, self.nb_filter
        self.add_weight("W", (k,) * self.rank + (c, 4 * f), "glorot_uniform")
        self.add_weight("U", (k,) * self.rank + (f, 4 * f), "orthogonal")
        self.add_weight("b", (4 * f,), "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        b, t, _, *spatial = input_shape
        if self.return_sequences:
            return (b, t, self.nb_filter, *spatial)
        return (b, self.nb_filter, *spatial)

    def _conv(self, x, kernel):
        """SAME, stride-1 convolution of NC(D)HW ``x`` by a (spatial...,
        in, out) kernel, operands promoted to one dtype."""
        x, kernel = promoted(x, kernel)
        k = tuple(kernel.shape[:self.rank])
        ones = (1,) * self.rank
        x, padding = _padding(x, "same", k, ones, ones, "th")
        conv = F.conv2d if self.rank == 2 else F.conv3d
        return conv(x, _conv_weight(kernel, torch.contiguous_format),
                    padding=padding)

    def call(self, params, x, **kw):
        if self.go_backwards:
            x = x.flip(1)
        b, t, f = x.shape[0], x.shape[1], self.nb_filter
        spatial = tuple(x.shape[3:])
        # every step's input convolution at once, plus the bias
        zx = self._conv(x.reshape((b * t,) + tuple(x.shape[2:])),
                        params["W"])
        zx = zx.reshape((b, t) + tuple(zx.shape[1:]))
        bias = params["b"].reshape((1, -1) + (1,) * self.rank)
        h = torch.zeros((b, f) + spatial, device=x.device)
        c = torch.zeros_like(h)
        ys = []
        for step in range(t):
            z = zx[:, step] + self._conv(h, params["U"]) + bias
            # the inner activation of all four gates in one call (the c
            # gate's share unused): the same values as three calls, with a
            # third of the launches
            gates = self.inner_activation(z)
            i, fg, o = gates[:, :f], gates[:, f:2 * f], gates[:, 3 * f:]
            g = self.activation(z[:, 2 * f:3 * f])
            c = fg * c + i * g
            h = o * self.activation(c)
            ys.append(h)
        if self.return_sequences:
            return torch.stack(ys, dim=1)
        return ys[-1]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


class Bidirectional(KerasLayer):
    """Ref keras/layers/Bidirectional.scala — merge_mode concat, sum, mul
    or ave. The backward layer is a copy of the forward one with
    ``go_backwards`` flipped; its outputs are re-reversed before the
    merge."""

    def __init__(self, layer: _RNNBase, merge_mode: str = "concat",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.forward_layer = layer
        self.backward_layer = copy.deepcopy(layer)
        self.backward_layer.name = layer.name + "_reverse"
        self.backward_layer.go_backwards = not layer.go_backwards
        self.merge_mode = merge_mode

    def build(self, input_shape: Shape):
        self.forward_layer.ensure_built(input_shape)
        self.backward_layer.ensure_built(input_shape)

    def param_specs(self):
        return {"forward": self.forward_layer.param_specs(),
                "backward": self.backward_layer.param_specs()}

    def regularization_loss(self, params):
        return (self.forward_layer.regularization_loss(
            params.get("forward", {}))
            + self.backward_layer.regularization_loss(
                params.get("backward", {})))

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        out = self.forward_layer.compute_output_shape(input_shape)
        if self.merge_mode == "concat":
            return tuple(out[:-1]) + (out[-1] * 2,)
        return out

    def call(self, params, x, **kw):
        fwd = self.forward_layer.call(params["forward"], x, **kw)
        bwd = self.backward_layer.call(params["backward"], x, **kw)
        if self.forward_layer.return_sequences:
            bwd = bwd.flip(1)
        if self.merge_mode == "concat":
            return torch.cat([fwd, bwd], dim=-1)
        if self.merge_mode == "sum":
            return fwd + bwd
        if self.merge_mode == "mul":
            return fwd * bwd
        if self.merge_mode == "ave":
            return 0.5 * (fwd + bwd)
        raise ValueError(f"Unknown merge_mode {self.merge_mode}")


class TimeDistributed(KerasLayer):
    """Apply an inner layer to every timestep (ref TimeDistributed.scala),
    with time folded into the batch for the inner call."""

    def __init__(self, layer: KerasLayer, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.layer = layer

    def build(self, input_shape: Shape):
        self.layer.ensure_built((input_shape[0],) + tuple(input_shape[2:]))

    def param_specs(self):
        return {"inner": self.layer.param_specs()}

    def regularization_loss(self, params):
        return self.layer.regularization_loss(params.get("inner", {}))

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        inner_out = self.layer.compute_output_shape(
            (input_shape[0],) + tuple(input_shape[2:]))
        return (input_shape[0], input_shape[1]) + tuple(inner_out[1:])

    def call(self, params, x, **kw):
        b, t = x.shape[0], x.shape[1]
        y = self.layer.call(params["inner"],
                            x.reshape((b * t,) + tuple(x.shape[2:])), **kw)
        return y.reshape((b, t) + tuple(y.shape[1:]))

