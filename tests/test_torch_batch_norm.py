"""The port's batch norm against the JAX package's, on the same numpy
inputs: the ``batch_norm_train`` op (forward ``y``, ``mean``, ``var``;
backward ``dx``, ``dgamma``, ``dbeta`` against ``jax.grad`` through the
JAX ``custom_vjp``) on NHWC, NCHW and 2-D inputs in f32 and bf16, and the
``BatchNormalization`` layer's moving-average update and eval path, and
``LayerNorm``.

Tolerances:
- f32: ``rtol = atol = 1e-5`` (the same one-pass f32 sums in another
  order; inputs of mean 2 and scale 3, so E[x^2] - E[x]^2 cancels about
  one digit).
- bf16: the output and ``dx`` are bf16 on both sides (8 significant bits)
  from the same f32 statistics; they may differ by one bf16 rounding of
  values up to about 4, 2^-6 absolute: ``BF16_TOL`` = 2e-2. The
  statistics and ``dgamma``/``dbeta`` are f32 sums of the same bf16
  values: 1e-4 relative and absolute (``BF16_STAT_TOL``), against values
  near 1 to 10 summed over up to 288 elements. Measured: bf16 ``y``,
  ``dx``, ``mean``, ``dgamma`` and ``dbeta`` bitwise equal, ``var`` within
  6e-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras.layers import BatchNormalization as JaxBN
from analytics_zoo_tpu.keras.layers import LayerNorm as JaxLayerNorm
from analytics_zoo_tpu.ops.batch_norm import batch_norm_train as jax_bn
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.layers import BatchNormalization
from analytics_zoo_tpu_torch.keras.layers import LayerNorm
from analytics_zoo_tpu_torch.ops.batch_norm import batch_norm_train

EPS = 1e-3
F32_TOL = 1e-5
BF16_TOL, BF16_STAT_TOL = 2e-2, 1e-4
CASES = {"nhwc": ((8, 6, 6, 5), (0, 1, 2)),
         "nchw": ((8, 5, 6, 6), (0, 2, 3)),
         "dense": ((16, 7), (0,))}


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _inputs(shape, axes, seed=0):
    rng = np.random.default_rng(seed)
    nfeat = [s for i, s in enumerate(shape) if i not in axes][0]
    x = rng.normal(2.0, 3.0, size=shape).astype(np.float32)
    g = rng.normal(1.0, 0.1, size=(nfeat,)).astype(np.float32)
    b = rng.normal(size=(nfeat,)).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    return x, g, b, cot


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_batch_norm_train_matches_jax(case, dtype):
    shape, axes = CASES[case]
    x, g, b, cot = _inputs(shape, axes)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jx, jg, jb = (jnp.asarray(a).astype(jdt) for a in (x, g, b))

    def jloss(xx, gg, bb):
        y, mean, var = jax_bn(xx, gg, bb, axes, EPS)
        return jnp.sum(y.astype(jnp.float32) * cot), (y, mean, var)

    (jgrads, (jy, jmean, jvar)) = jax.grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jx, jg, jb)
    tx, tg, tb = (torch.tensor(a).to(tdt).requires_grad_(True)
                  for a in (x, g, b))
    ty, tmean, tvar = batch_norm_train(tx, tg, tb, axes, EPS)
    assert ty.dtype == tdt and tmean.dtype == tvar.dtype == torch.float32
    assert not tmean.requires_grad and not tvar.requires_grad
    (ty.float() * torch.tensor(cot)).sum().backward()
    out_tol = F32_TOL if dtype == "float32" else BF16_TOL
    stat_tol = F32_TOL if dtype == "float32" else BF16_STAT_TOL
    for got, want, tol in ((ty, jy, out_tol), (tmean, jmean, stat_tol),
                           (tvar, jvar, stat_tol),
                           (tx.grad, jgrads[0], out_tol),
                           (tg.grad, jgrads[1], stat_tol),
                           (tb.grad, jgrads[2], stat_tol)):
        assert got.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_batch_norm_train_saves_x_in_its_own_dtype():
    """The backward keeps x as given (bf16), not an f32 copy of it."""
    shape, axes = CASES["nhwc"]
    x, g, b, _ = _inputs(shape, axes)
    tx = torch.tensor(x).bfloat16().requires_grad_(True)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        batch_norm_train(tx, torch.tensor(g), torch.tensor(b), axes, EPS)
    big = [dt for s, dt in saved if s == shape]
    assert big == [torch.bfloat16], saved


@pytest.mark.parametrize("ordering,shape", [("tf", (6, 6, 4)),
                                            ("th", (4, 6, 6)),
                                            ("tf", (4,))])
def test_batch_normalization_layer_matches_jax(ordering, shape):
    """Two training calls (the moving averages with momentum 0.9), then the
    eval path on the updated statistics, in f32 and bf16."""
    jlayer = JaxBN(dim_ordering=ordering, momentum=0.9)
    tlayer = BatchNormalization(dim_ordering=ordering, momentum=0.9)
    jlayer.ensure_built((None,) + shape)
    tlayer.ensure_built((None,) + shape)
    rng = np.random.default_rng(3)
    nfeat = shape[0] if ordering == "th" or len(shape) == 1 else shape[-1]
    jparams = {"gamma": rng.normal(1.0, 0.2, nfeat).astype(np.float32),
               "beta": rng.normal(0.0, 0.5, nfeat).astype(np.float32)}
    tparams = load_jax_params(tlayer, jparams)
    jstate, tstate = jlayer.init_state(), tlayer.init_state()
    assert set(tstate) == {"moving_mean", "moving_var"}
    for k in tstate:
        np.testing.assert_array_equal(tstate[k].numpy(), jstate[k])
        assert tstate[k].dtype == torch.float32
    for step in range(2):
        x = rng.normal(5.0, 2.0, size=(16,) + shape).astype(np.float32)
        jy, jstate = jlayer.call(jparams, jnp.asarray(x), state=jstate,
                                 training=True)
        ty, tstate = tlayer.call(tparams, torch.tensor(x), state=tstate,
                                 training=True)
        np.testing.assert_allclose(ty.numpy(), jy, rtol=F32_TOL,
                                   atol=F32_TOL)
        for k in tstate:
            assert not tstate[k].requires_grad
            np.testing.assert_allclose(tstate[k].numpy(), jstate[k],
                                       rtol=F32_TOL, atol=F32_TOL)
    assert np.all(tstate["moving_mean"].numpy() > 0.5)  # 0 -> ~0.19 * 5
    x = rng.normal(5.0, 2.0, size=(4,) + shape).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        jy, jst = jlayer.call(
            {k: jnp.asarray(v).astype(dt) for k, v in jparams.items()},
            jnp.asarray(x).astype(dt), state=jstate, training=False)
        ty, tst = tlayer.call(
            {k: v.to(getattr(torch, dt)) for k, v in tparams.items()},
            torch.tensor(x).to(getattr(torch, dt)), state=tstate,
            training=False)
        assert tst is tstate and ty.dtype == getattr(torch, dt)
        tol = F32_TOL if dt == "float32" else BF16_TOL
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)


def test_layer_norm_matches_jax():
    x = np.random.default_rng(4).normal(1.0, 2.0, (3, 5, 8)).astype(
        np.float32)
    jlayer, tlayer = JaxLayerNorm(), LayerNorm()
    jlayer.ensure_built((None, 5, 8))
    tlayer.ensure_built((None, 5, 8))
    rng = np.random.default_rng(5)
    jparams = {"gamma": rng.normal(1.0, 0.2, 8).astype(np.float32),
               "beta": rng.normal(0.0, 0.5, 8).astype(np.float32)}
    tparams = load_jax_params(tlayer, jparams)
    np.testing.assert_allclose(
        tlayer.call(tparams, torch.tensor(x)).numpy(),
        jlayer.call(jparams, jnp.asarray(x)), rtol=F32_TOL, atol=F32_TOL)
