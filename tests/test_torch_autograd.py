"""The port's ``autograd`` against the JAX package's: every math op on
Variables (a graph ``Model`` of both packages fed the same numpy inputs)
and on plain tensors (values and the gradient of ``sum(out * cot)``
against ``jax.vjp``), ``Parameter``, ``CustomLoss`` in its function and
Variable forms, and the two programs built on them, as the port's
``chip_smoke.py`` builds them: ``examples/autograd/custom.py`` (both loss
forms) and ``apps/variational-autoencoder/vae.py`` (``build_vae`` and its
loss, the app's own functions on the JAX side), each held to the JAX
package over its first 3 steps.

JAX conventions kept: dim 0 is the batch and ``sum``/``mean`` default to
``axis=0``; ``l2_normalize`` and ``batch_dot(normalize=True)`` add 1e-12
to the norm; ``batch_dot``'s axes count the batch (its per-sample axes
are ``axes[i] - 1``); ``abs`` has the derivative 1 at 0 (``jnp.abs``'s);
a ``CustomLoss`` function's per-row result is reduced by the train step
over the valid rows of the tail mask, the Variable form returns the mean.

Tolerance: f32, ``1e-5`` (values and gradients; sums over at most 256
terms in another order); trajectories ``1e-5`` on losses and weights.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.autograd as jA
import analytics_zoo_tpu.keras.layers as jl
from analytics_zoo_tpu.data.feature_set import ArrayFeatureSet as JArrayFS
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.keras.optimizers import SGD as JSGD
from analytics_zoo_tpu.keras.optimizers import Adam as JAdam
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.autograd as tA
import analytics_zoo_tpu_torch.keras.layers as tl
import chip_smoke as cs
from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.optimizers import SGD, Adam

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=tol,
                               atol=tol)


# (name, op(A, a, b), shape of a, shape of b or None, positive inputs)
OPS = [
    ("abs", lambda A, a, b: A.abs(a), (3, 4), None, False),
    ("square", lambda A, a, b: A.square(a), (3, 4), None, False),
    ("sqrt", lambda A, a, b: A.sqrt(a), (3, 4), None, True),
    ("log", lambda A, a, b: A.log(a), (3, 4), None, True),
    ("exp", lambda A, a, b: A.exp(a), (3, 4), None, False),
    ("erf", lambda A, a, b: A.erf(a), (3, 4), None, False),
    ("softsign", lambda A, a, b: A.softsign(a), (3, 4), None, False),
    ("softplus", lambda A, a, b: A.softplus(a), (3, 4), None, False),
    ("maximum", lambda A, a, b: A.maximum(a, b), (3, 4), (3, 4), False),
    ("minimum", lambda A, a, b: A.minimum(a, b), (3, 4), (3, 4), False),
    ("maximum-scalar", lambda A, a, b: A.maximum(a, 0.2), (3, 4), None,
     False),
    ("minimum-scalar-left", lambda A, a, b: A.minimum(-0.1, a), (3, 4),
     None, False),
    ("sum", lambda A, a, b: A.sum(a, axis=1), (3, 4), None, False),
    ("sum-keepdims", lambda A, a, b: A.sum(a, axis=2, keepdims=True),
     (3, 4), None, False),
    ("mean", lambda A, a, b: A.mean(a, axis=2), (3, 4), None, False),
    ("mean-keepdims", lambda A, a, b: A.mean(a, axis=1, keepdims=True),
     (3, 4), None, False),
    ("clip", lambda A, a, b: A.clip(a, -0.5, 0.7), (3, 4), None, False),
    ("pow", lambda A, a, b: A.pow(a, 2.5), (3, 4), None, True),
    ("neg", lambda A, a, b: A.neg(a), (3, 4), None, False),
    ("expand-dims", lambda A, a, b: A.expand_dims(a, 1), (3, 4), None,
     False),
    ("contiguous", lambda A, a, b: A.contiguous(a), (3, 4), None, False),
    ("mm", lambda A, a, b: A.mm(a, b), (3, 4), (4, 5), False),
    ("mm-axes", lambda A, a, b: A.mm(a, b, axes=(2, 2)), (3, 4), (5, 4),
     False),
    ("batch-dot", lambda A, a, b: A.batch_dot(a, b), (4,), (4,), False),
    ("batch-dot-axes", lambda A, a, b: A.batch_dot(a, b, axes=(2, 2)),
     (3, 4), (5, 4), False),
    ("batch-dot-axes-12", lambda A, a, b: A.batch_dot(a, b, axes=(1, 2)),
     (3, 4), (5, 3), False),
    ("batch-dot-normalize", lambda A, a, b: A.batch_dot(
        a, b, axes=(2, 2), normalize=True), (3, 4), (5, 4), False),
    ("l2-normalize", lambda A, a, b: A.l2_normalize(a, axis=2), (3, 4),
     None, False),
    ("l2-normalize-default", lambda A, a, b: A.l2_normalize(a), (6,), None,
     False),
]


def _inputs(shape_a, shape_b, positive, seed=0):
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.standard_normal((4,) + shape).astype(np.float32)
        return np.abs(x) + 0.5 if positive else x

    a = draw(shape_a)
    a.reshape(-1)[:2] = 0.0  # abs and the reductions at 0
    return a, (draw(shape_b) if shape_b is not None else None)


@pytest.mark.parametrize("name,op,sa,sb,pos", [
    pytest.param(*c, id=c[0]) for c in OPS])
def test_op_on_variables_matches_jax(name, op, sa, sb, pos):
    a, b = _inputs(sa, sb, pos)

    def model(A, topo):
        va = topo.Input(sa)
        ins = [va] + ([topo.Input(sb)] if sb is not None else [])
        return topo.Model(ins if sb is not None else va,
                          op(A, va, ins[-1] if sb is not None else None))

    jnet, tnet = model(jA, jtopo), model(tA, ttopo)
    x = [a, b] if sb is not None else a
    want = jax.jit(lambda x: jnet.apply({}, {}, x)[0])(x)
    got = tnet.apply({}, {}, [torch.tensor(v) for v in x]
                     if sb is not None else torch.tensor(x))[0]
    assert tuple(got.shape[1:]) == tuple(tnet.get_output_shape()[1:]) \
        or tuple(want.shape[1:]) != tuple(jnet.get_output_shape()[1:])
    _close(got, want)


@pytest.mark.parametrize("name,op,sa,sb,pos", [
    pytest.param(*c, id=c[0]) for c in OPS] + [
    pytest.param("sum-batch-axis", lambda A, a, b: A.sum(a), (3, 4), None,
                 False, id="sum-batch-axis"),
    pytest.param("mean-batch-axis", lambda A, a, b: A.mean(a), (3, 4), None,
                 False, id="mean-batch-axis")])
def test_op_on_tensors_matches_jax_with_gradients(name, op, sa, sb, pos):
    a, b = _inputs(sa, sb, pos, seed=1)
    args = [a] + ([b] if b is not None else [])

    def jf(*xs):
        return op(jA, xs[0], xs[1] if len(xs) > 1 else None)

    def out_and_grads(cot, *xs):  # one compiled program, not op by op
        out, vjp = jax.vjp(jf, *xs)
        return out, vjp(cot)

    cot = np.random.default_rng(2).standard_normal(
        jax.eval_shape(jf, *args).shape).astype(np.float32)
    jout, jgrads = jax.jit(out_and_grads)(cot, *args)
    targs = [torch.tensor(v, requires_grad=True) for v in args]
    tout = op(tA, targs[0], targs[1] if len(targs) > 1 else None)
    assert isinstance(tout, torch.Tensor)
    _close(tout.detach(), jout)
    (tout * torch.tensor(cot)).sum().backward()
    for t, g in zip(targs, jgrads):
        _close(t.grad, g)


def test_stack_on_variables_matches_jax():
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((2, 3, 4)).astype(np.float32)
          for _ in range(3)]

    def model(A, topo):
        ins = [topo.Input((3, 4)) for _ in range(3)]
        return topo.Model(ins, A.stack(ins, axis=2))

    jnet, tnet = model(jA, jtopo), model(tA, ttopo)
    want = jnet.apply({}, {}, xs)[0]
    got = tnet.apply({}, {}, [torch.tensor(x) for x in xs])[0]
    assert tuple(got.shape) == (2, 3, 3, 4) == want.shape
    _close(got, want)


def _parameter_model(A, L, topo):
    x = topo.Input((4,))
    w = A.Parameter((4,), init="ones", name="scale")
    y = L.Dense(2, name="head")(x * w + A.Parameter((1, 4), name="shift"))
    return topo.Model(x, y)


def test_parameter_is_a_trainable_graph_source():
    jbase.reset_name_counts()
    jnet = _parameter_model(jA, jl, jtopo)
    tnet = _parameter_model(tA, tl, ttopo)
    jp, js = jnet.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(0, 0.3, v.shape)).astype(
            np.float32), jp)
    tp = load_jax_params(tnet, jp)
    assert set(tp["scale"]) == {"value"} and tp["shift"]["value"].shape \
        == (1, 4)
    assert tnet.layers()[0].trainable
    x = rng.standard_normal((3, 4)).astype(np.float32)
    _close(tnet.apply(tp, {}, torch.tensor(x))[0], jnet.apply(jp, js, x)[0])
    frozen = tA.Parameter((2, 3), init="zeros", trainable=False)
    assert frozen.shape == (2, 3)
    assert not frozen.node.layer.weight_specs[0].trainable


def _mae(A):
    return cs.custom_loss(A)


def _custom_pair():
    jbase.reset_name_counts()
    reset_name_counts()
    jnet, tnet = cs.custom_model(jl, jtopo), cs.custom_model(tl, ttopo)
    est = jnet._get_estimator()
    est._ensure_state()
    load_jax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                 est.tstate.params))
    return jnet, tnet


def _jax_losses(net):
    return [v for _, v in net.get_train_summary("Loss")]


@pytest.mark.parametrize("form", ["function", "CustomLoss"])
def test_custom_py_first_three_steps_match_jax(form, tmp_path):
    x, y = cs.custom_data()
    x, y = x[:20], y[:20]  # 3 steps of 8, the last a wrap-padded tail
    jnet, tnet = _custom_pair()
    jloss, tloss = _mae(jA), _mae(tA)
    if form == "CustomLoss":
        jloss, tloss = jA.CustomLoss(jloss), tA.CustomLoss(tloss)
    jnet.compile(optimizer=JSGD(lr=1e-2), loss=jloss)
    tnet.compile(optimizer=SGD(lr=1e-2), loss=tloss)
    jnet.set_tensorboard(str(tmp_path), "jax")
    jnet.fit(x, y, batch_size=8, nb_epoch=1)
    tnet.fit(x, y, batch_size=8, nb_epoch=1)
    want = _jax_losses(jnet)
    assert len(want) == 3
    _close(tnet._estimator.train_losses, want)
    tw, jw = tnet.get_weights(), jnet.get_weights()
    for layer, leaves in jw.items():
        for k, v in leaves.items():
            _close(tw[layer][k], v)


def test_custom_loss_forms_agree_and_reduce_per_row():
    rng = np.random.default_rng(5)
    yt = rng.standard_normal((6, 3)).astype(np.float32)
    yp = rng.standard_normal((6, 3)).astype(np.float32)
    fn = tA.CustomLoss(_mae(tA))(torch.tensor(yt), torch.tensor(yp))
    assert tuple(fn.shape) == (6,)  # one value per row
    _close(fn, jA.CustomLoss(_mae(jA))(yt, yp))

    def variable_form(A, topo):
        p, t = topo.Input((3,)), topo.Input((3,))
        return A.CustomLoss(A.mean(A.abs(t - p), axis=1), p, t)

    got = variable_form(tA, ttopo)(torch.tensor(yt), torch.tensor(yp))
    want = variable_form(jA, jtopo)(yt, yp)
    assert got.dim() == 0  # the Variable form's mean, as in JAX
    _close(got, want)
    _close(got, fn.mean())
    with pytest.raises(ValueError):
        tA.CustomLoss(tA.mean(ttopo.Input((3,)), axis=1))
    p = ttopo.Input((3,))
    with pytest.raises(ValueError):  # a weighted expression
        tA.CustomLoss(tl.Dense(2)(p), p, ttopo.Input((2,)))


def _vae_app():
    path = ROOT / "apps" / "variational-autoencoder" / "vae.py"
    spec = importlib.util.spec_from_file_location("vae_app", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vae_first_three_steps_match_jax(tmp_path):
    app = _vae_app()
    assert (app.LATENT, app.SIDE) == (cs.VAE_LATENT, cs.VAE_SIDE)
    xv = cs.synth_digits(24)
    np.testing.assert_array_equal(xv, app.synth_digits(24))
    jbase.reset_name_counts()
    reset_name_counts()
    jnet = app.build_vae()
    tnet = cs.build_vae(tA, tl, ttopo)
    est = jnet._get_estimator()
    est._ensure_state()
    load_jax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                 est.tstate.params))
    eps = np.random.default_rng(6).normal(size=(24, cs.VAE_LATENT)).astype(
        np.float32)
    # the packed forward, and the app's loss against the port's
    packed = np.asarray(jnet.predict([xv, eps], batch_size=8))
    got = tnet.predict([xv, eps], batch_size=8)
    _close(got, packed)
    _close(cs.vae_loss(torch.tensor(xv), torch.tensor(got)),
           app.vae_loss(xv, packed), tol=1e-4)
    jnet.compile(optimizer=JAdam(lr=cs.VAE_LR), loss=jA.CustomLoss(
        app.vae_loss))
    tnet.compile(optimizer=Adam(lr=cs.VAE_LR), loss=tA.CustomLoss(
        cs.vae_loss))
    jnet.set_tensorboard(str(tmp_path), "jax")
    jnet.fit(JArrayFS([xv, eps], xv), batch_size=8, nb_epoch=1)
    tnet.fit(ArrayFeatureSet([xv, eps], xv), batch_size=8, nb_epoch=1)
    want = _jax_losses(jnet)
    assert len(want) == 3
    np.testing.assert_allclose(tnet._estimator.train_losses, want,
                               rtol=TOL, atol=0)
    tw, jw = tnet.get_weights(), jnet.get_weights()
    for layer, leaves in jw.items():
        for k, v in leaves.items():
            _close(tw[layer][k], v)


def test_vae_feed_draws_fresh_eps_per_batch():
    fs = cs.vae_feature_set(cs.synth_digits(16), seed=3)
    a = fs.take(np.arange(8))
    b = fs.take(np.arange(8))
    np.testing.assert_array_equal(a[0][0], b[0][0])
    assert not np.array_equal(a[0][1], b[0][1])
    assert a[0][1].shape == (8, cs.VAE_LATENT)
