"""The port's layer library against the JAX package's, layer by layer: the
same seeded numpy input through both, and the same weights: normal draws
with numpy in the JAX layer's weight shapes (so ones and zeros are not
special), carried into the port's by ``interop.load_jax_params``. Each case holds the forward values, the
gradient of ``sum(out * cot)`` with respect to the input and to every
weight against ``jax.vjp``, and the output shape against the JAX layer's
``compute_output_shape``. Layers with both dim orderings run in both.

The traps named here each have their cases: ``Deconvolution2D`` (a
``(kh, kw, out, in)`` kernel and ``lax.conv_transpose(...,
transpose_kernel=True)``) at strides 1 and 2; ``ResizeBilinear`` growing
and shrinking (``jax.image.resize`` antialiases when it shrinks) and
corner-aligned; ``LRN2D`` and ``WithinChannelLRN2D`` with JAX's windows
and alpha scaling; negative dims of ``Select``/``Narrow``/``ExpandDim``;
``Masking`` on rows that are all the mask value.

The random layers are held equal to JAX in inference mode, by
statistics in training mode (mean and variance, whole channels dropped,
slopes within bounds), and drawing only from the generator passed in.
The initializers are held by shape, bounds and moments against JAX's own
draws, and by their exact properties.

Tolerance: f32, ``rtol = atol = 1e-5`` (the same f32 sums in another
order: at most 3 * 3 * 3 * 3 products a convolution output, 2 * 5 * 5 * 5
positions a weight gradient); ``ResizeBilinear``'s antialiased shrink
``1e-5`` too (the same normalised triangle weights, computed apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.autograd as jA
import analytics_zoo_tpu.keras.layers as jl
from analytics_zoo_tpu.keras.engine import base as jbase
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.autograd as tA
import analytics_zoo_tpu_torch.keras.layers as tl
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine import base as tbase

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    tbase.reset_name_counts()


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=tol,
                               atol=tol)


def _input(rng, shape, kind):
    if kind == "pos":
        return rng.uniform(0.5, 2.0, (2,) + shape).astype(np.float32)
    if kind.startswith("int"):
        return rng.integers(0, int(kind[3:]), (2,) + shape).astype(np.int32)
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    if kind == "masked":  # whole steps equal to the mask value
        x[:, 1] = 0.0
        x[1, 3] = 0.0
    return x


def _pair(make, in_shapes, seed=0):
    """The same layer in both packages, built on ``in_shapes`` (one
    batch-free shape, or a list for a multi-input layer), with normal
    weights in the JAX layer's shapes carried into the port's."""
    jlayer, tlayer = make(jl), make(tl)
    full = ([(None,) + s for s in in_shapes] if isinstance(in_shapes, list)
            else (None,) + in_shapes)
    jlayer.ensure_built(full)
    tlayer.ensure_built(full)
    rng = np.random.default_rng(seed)
    jparams = {spec.name: rng.normal(0, 0.5, spec.shape).astype(np.float32)
               for spec in jlayer.weight_specs}
    tparams = load_jax_params(tlayer, jparams)
    assert tlayer.output_shape == jlayer.output_shape
    return jlayer, tlayer, jparams, tparams


def _check(make, in_shapes, kind="normal", seed=0, tol=TOL):
    """Forward, input and weight gradients against ``jax.vjp``."""
    jlayer, tlayer, jparams, tparams = _pair(make, in_shapes, seed)
    rng = np.random.default_rng(seed + 1)
    multi = isinstance(in_shapes, list)
    kinds = kind if isinstance(kind, list) else [kind] * (
        len(in_shapes) if multi else 1)
    xs = [_input(rng, s, k) for s, k in zip(
        in_shapes if multi else [in_shapes], kinds)]
    floats = [i for i, x in enumerate(xs) if x.dtype == np.float32]

    def jcall(p, fx):
        full = list(xs)
        for i, v in zip(floats, fx):
            full[i] = v
        return jlayer.call(p, full if multi else full[0])

    cot = np.random.default_rng(7).standard_normal(
        jax.eval_shape(jcall, jparams, [xs[i] for i in floats]).shape
    ).astype(np.float32)

    @jax.jit
    def jfwd_bwd(p, fx):
        out, vjp = jax.vjp(jcall, p, fx)
        if not jnp.issubdtype(out.dtype, jnp.floating):
            return out, None
        return out, vjp(cot.astype(out.dtype))

    jout, jgrads = jfwd_bwd(jparams, [xs[i] for i in floats])
    tp = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tx = [torch.tensor(x, requires_grad=x.dtype == np.float32) for x in xs]
    tout = tlayer.call(tp, tx if multi else tx[0])
    assert tuple(tout.shape) == jout.shape
    # the declared shape holds where the JAX layer's holds (ExpandDim(-1)
    # declares its axis one place off, on both sides)
    assert ((tuple(tout.shape[1:]) == tuple(tlayer.output_shape[1:]))
            == (jout.shape[1:] == tuple(jlayer.output_shape[1:])))
    assert str(tout.dtype).replace("torch.", "").startswith(
        "int" if jnp.issubdtype(jout.dtype, jnp.integer) else "float")
    _close(tout.detach(), jout, tol)
    if not jnp.issubdtype(jout.dtype, jnp.floating):
        return
    jgp, jgx = jgrads
    if not tout.requires_grad:  # a step function: no gradient either side
        for g in jax.tree_util.tree_leaves((jgp, jgx)):
            assert not np.asarray(g).any()
        return
    (tout * torch.tensor(cot)).sum().backward()
    for i, g in zip(floats, jgx):
        _close(tx[i].grad if tx[i].grad is not None
               else torch.zeros(xs[i].shape), g, tol)
    for k in jparams:
        _close(tp[k].grad if tp[k].grad is not None
               else torch.zeros(jparams[k].shape), jgp[k], tol)


def _orders(cases):
    """Each (id, make(lib, order), shape(order), kind) case in "th" and
    "tf"."""
    out = []
    for cid, make, shape, kind in cases:
        for order in ("th", "tf"):
            out.append(pytest.param(
                (lambda lib, m=make, o=order: m(lib, o)), shape(order), kind,
                id=f"{cid}-{order}"))
    return out


def _img(c, h, w):
    return lambda o: (c, h, w) if o == "th" else (h, w, c)


def _vol(c, d, h, w):
    return lambda o: (c, d, h, w) if o == "th" else (d, h, w, c)


CASES = [
    # -- core -----------------------------------------------------------
    ("permute", lambda L: L.Permute((2, 3, 1)), (3, 4, 5), "normal"),
    ("repeat-vector", lambda L: L.RepeatVector(3), (4,), "normal"),
    ("squeeze", lambda L: L.Squeeze(2), (3, 1, 4), "normal"),
    ("expand-dim", lambda L: L.ExpandDim(1), (3, 4), "normal"),
    ("expand-dim-neg", lambda L: L.ExpandDim(-1), (3, 4), "normal"),
    ("masking", lambda L: L.Masking(0.0), (5, 3), "masked"),
    ("select", lambda L: L.Select(2, 1), (3, 4), "normal"),
    ("select-neg-index", lambda L: L.Select(1, -1), (3, 4), "normal"),
    ("narrow", lambda L: L.Narrow(1, 1, 2), (4, 3), "normal"),
    ("narrow-neg-offset", lambda L: L.Narrow(2, -3, 2), (3, 5), "normal"),
    ("leaky-relu", lambda L: L.LeakyReLU(0.2), (3, 4), "normal"),
    ("elu", lambda L: L.ELU(0.7), (3, 4), "normal"),
    ("thresholded-relu", lambda L: L.ThresholdedReLU(0.5), (3, 4),
     "normal"),
    ("srelu", lambda L: L.SReLU(), (3, 4), "normal"),
    ("prelu", lambda L: L.PReLU(), (3, 4), "normal"),
    ("gaussian-noise-eval", lambda L: L.GaussianNoise(0.3), (3, 4),
     "normal"),
    ("gaussian-dropout-eval", lambda L: L.GaussianDropout(0.3), (3, 4),
     "normal"),
    ("spatial-dropout1d-eval", lambda L: L.SpatialDropout1D(0.3), (5, 4),
     "normal"),
    ("spatial-dropout3d-eval", lambda L: L.SpatialDropout3D(0.4),
     (2, 3, 3, 3), "normal"),
    ("dense-regularized", lambda L: L.Dense(
        3, W_regularizer=L.L1L2(0.1, 0.2), activation="tanh"), (4,),
     "normal"),
    # top-1 routing with over-capacity drops (12 tokens, 4 experts, 3
    # slots each) and ample capacity
    ("moe-drops", lambda L: L.MoE(4, 16, capacity_factor=1.0), (6, 8),
     "normal"),
    ("moe", lambda L: L.MoE(3, 8, capacity_factor=2.0), (5, 4), "normal"),
    # -- convolutional ----------------------------------------------------
    ("conv1d-alias", lambda L: L.Conv1D(4, 3, border_mode="same"), (7, 3),
     "normal"),
    ("zero-padding1d", lambda L: L.ZeroPadding1D(2), (5, 3), "normal"),
    ("zero-padding1d-pair", lambda L: L.ZeroPadding1D((1, 3)), (5, 3),
     "normal"),
    ("cropping1d", lambda L: L.Cropping1D((1, 2)), (6, 3), "normal"),
    ("upsampling1d", lambda L: L.UpSampling1D(3), (4, 2), "normal"),
    ("locally-connected1d", lambda L: L.LocallyConnected1D(
        4, 3, activation="relu"), (7, 3), "normal"),
    ("locally-connected1d-stride2", lambda L: L.LocallyConnected1D(
        4, 2, subsample_length=2, bias=False), (7, 3), "normal"),
    # -- recurrent module's dense layers, normalization -------------------
    ("highway", lambda L: L.Highway(activation="relu"), (5,), "normal"),
    ("highway-no-bias", lambda L: L.Highway(bias=False), (5,), "normal"),
    ("maxout-dense", lambda L: L.MaxoutDense(3, nb_feature=4), (5,),
     "normal"),
    ("within-channel-lrn2d", lambda L: L.WithinChannelLRN2D(
        size=3, alpha=0.5), (2, 5, 6), "normal"),
    ("within-channel-lrn2d-even", lambda L: L.WithinChannelLRN2D(
        size=4, alpha=2.0, beta=0.5), (2, 5, 5), "normal"),
]

ORDERED = _orders([
    ("spatial-dropout2d-eval", lambda L, o: L.SpatialDropout2D(
        0.3, dim_ordering=o), _img(3, 4, 4), "normal"),
    ("conv3d-same", lambda L, o: L.Convolution3D(
        3, 3, 3, 3, border_mode="same", dim_ordering=o, activation="relu"),
     _vol(2, 5, 5, 5), "normal"),
    ("conv3d-valid-stride2", lambda L, o: L.Conv3D(
        3, (3, 2, 3), subsample=2, dim_ordering=o, bias=False),
     _vol(2, 6, 5, 7), "normal"),
    ("conv3d-same-even-stride2", lambda L, o: L.Convolution3D(
        2, 2, 2, 2, subsample=2, border_mode="same", dim_ordering=o),
     _vol(2, 6, 6, 5), "normal"),
    ("deconv2d-stride1", lambda L, o: L.Deconvolution2D(
        3, 3, 2, dim_ordering=o), _img(2, 4, 5), "normal"),
    ("deconv2d-stride2", lambda L, o: L.Deconvolution2D(
        3, 3, 3, subsample=(2, 2), dim_ordering=o, activation="relu"),
     _img(2, 4, 4), "normal"),
    ("deconv2d-stride21", lambda L, o: L.Deconvolution2D(
        2, 2, 3, subsample=(2, 1), dim_ordering=o, bias=False),
     _img(3, 3, 4), "normal"),
    ("maxpool3d", lambda L, o: L.MaxPooling3D(2, dim_ordering=o),
     _vol(2, 4, 5, 4), "normal"),
    ("maxpool3d-same", lambda L, o: L.MaxPooling3D(
        3, strides=2, border_mode="same", dim_ordering=o),
     _vol(2, 4, 5, 6), "normal"),
    ("avgpool3d", lambda L, o: L.AveragePooling3D(
        (2, 2, 1), dim_ordering=o), _vol(2, 4, 5, 4), "normal"),
    ("avgpool3d-same", lambda L, o: L.AveragePooling3D(
        3, strides=2, border_mode="same", dim_ordering=o),
     _vol(2, 4, 5, 6), "normal"),
    ("global-maxpool3d", lambda L, o: L.GlobalMaxPooling3D(
        dim_ordering=o), _vol(3, 2, 3, 4), "normal"),
    ("global-avgpool3d", lambda L, o: L.GlobalAveragePooling3D(
        dim_ordering=o), _vol(3, 2, 3, 4), "normal"),
    ("zero-padding3d", lambda L, o: L.ZeroPadding3D(
        (1, 0, 2), dim_ordering=o), _vol(2, 2, 3, 3), "normal"),
    ("cropping2d", lambda L, o: L.Cropping2D(
        ((1, 0), (2, 1)), dim_ordering=o), _img(2, 5, 6), "normal"),
    ("upsampling3d", lambda L, o: L.UpSampling3D(
        (2, 1, 3), dim_ordering=o), _vol(2, 2, 3, 2), "normal"),
])


@pytest.mark.parametrize("make,shape,kind", [
    pytest.param(m, s, k, id=c) for c, m, s, k in CASES] + ORDERED)
def test_layer_matches_jax(make, shape, kind):
    _check(make, shape, kind)


def test_deconvolution2d_output_size_and_kernel_layout():
    """(h - 1) * stride + k, and the kernel leaf (kh, kw, out, in)."""
    _, tlayer, _, tparams = _pair(
        lambda L: L.Deconvolution2D(5, 3, 2, subsample=(2, 3)), (4, 6, 7))
    assert tlayer.output_shape == (None, 5, 13, 20)
    assert tuple(tparams["kernel"].shape) == (3, 2, 5, 4)


def test_layer_exports_equal_the_jax_package_less_moe():
    assert set(tl.__all__) == set(jl.__all__)
    assert set(tA.__all__) == set(jA.__all__)
    for name in tA.__all__:
        assert hasattr(tA, name), name
    for alias, cls in (("Conv1D", "Convolution1D"), ("Conv2D",
                                                     "Convolution2D"),
                       ("Conv3D", "Convolution3D")):
        assert getattr(tl, alias) is getattr(tl, cls)
        assert getattr(jl, alias) is getattr(jl, cls)
    from analytics_zoo_tpu_torch.keras import regularizers  # noqa: F401


@pytest.mark.parametrize("dim,num", [(1, 2), (2, 3), (-1, 3)])
def test_split_tensor_matches_jax(dim, num):
    from analytics_zoo_tpu.keras.engine.topology import Input as JInput
    from analytics_zoo_tpu.keras.engine.topology import Model as JModel
    from analytics_zoo_tpu_torch.keras.engine.topology import Input, Model

    def model(L, inp, mdl):
        x = inp((4, 6))
        return mdl(x, L.Merge(mode="concat", concat_axis=1)(
            L.split_tensor(x, dim, num)[::-1]))

    x = np.random.default_rng(0).standard_normal((2, 4, 6)).astype(
        np.float32)
    want = model(jl, JInput, JModel).apply({}, {}, x)[0]
    got = model(tl, Input, Model).apply({}, {}, torch.tensor(x))[0]
    assert tuple(got.shape) == want.shape
    _close(got, want)
    with pytest.raises(ValueError):
        tl.split_tensor(Input((5,)), 1, 2)


# -- the random layers in training mode --------------------------------------


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _train(layer, x, seed=0):
    layer.ensure_built((None,) + tuple(x.shape[1:]))
    return layer.call({}, x, training=True, rng=_gen(seed))


def test_random_layers_draw_only_from_the_generator_given():
    x = torch.randn(64, 8, 6, 5)
    m, lv = torch.randn(4, 5), torch.randn(4, 5)
    state = torch.random.get_rng_state()
    layers = [tl.GaussianNoise(0.5), tl.GaussianDropout(0.4),
              tl.SpatialDropout2D(0.5), tl.SpatialDropout3D(0.5),
              tl.RReLU()]
    for layer in layers:
        a = _train(layer, x if not isinstance(layer, tl.SpatialDropout3D)
                   else x[..., None], seed=3)
        b = _train(layer, x if not isinstance(layer, tl.SpatialDropout3D)
                   else x[..., None], seed=3)
        assert torch.equal(a, b), layer
    s = tl.GaussianSampler()
    s.ensure_built([(None, 5), (None, 5)])
    assert torch.equal(s.call({}, [m, lv], training=True, rng=_gen(2)),
                       s.call({}, [m, lv], training=True, rng=_gen(2)))
    assert torch.equal(torch.random.get_rng_state(), state)


def test_gaussian_noise_and_dropout_statistics():
    z = _train(tl.GaussianNoise(0.5), torch.zeros(400, 500))
    assert abs(z.mean().item()) < 0.01 and abs(z.std().item() - 0.5) < 0.01
    p = 0.3
    d = _train(tl.GaussianDropout(p), torch.ones(400, 500))
    assert abs(d.mean().item() - 1.0) < 0.01
    assert abs(d.var().item() - p / (1 - p)) < 0.01


@pytest.mark.parametrize("kind", ["1d", "2d-th", "2d-tf", "3d-th", "3d-tf"])
def test_spatial_dropout_drops_whole_channels(kind):
    p = 0.4
    if kind == "1d":
        layer, x, ch = tl.SpatialDropout1D(p), torch.rand(200, 6, 40) + 1, 2
    elif kind.startswith("2d"):
        o = kind[-2:]
        layer = tl.SpatialDropout2D(p, dim_ordering=o)
        x = torch.rand(200, 40, 3, 3) + 1
        x, ch = (x, 1) if o == "th" else (x.permute(0, 2, 3, 1), 3)
    else:
        o = kind[-2:]
        layer = tl.SpatialDropout3D(p, dim_ordering=o)
        x = torch.rand(200, 40, 2, 2, 2) + 1
        x, ch = (x, 1) if o == "th" else (x.permute(0, 2, 3, 4, 1), 4)
    y = _train(layer, x)
    dims = [d for d in range(1, x.dim()) if d != ch]
    zero = (y == 0).all(dim=dims) if dims else (y == 0)
    kept = (y != 0).all(dim=dims) if dims else (y != 0)
    assert bool((zero | kept).all())  # a channel is dropped whole or kept
    assert abs(zero.float().mean().item() - p) < 0.03
    scaled = y / x
    assert torch.allclose(scaled[y != 0], torch.tensor(1 / (1 - p)))


def test_rrelu_slopes_within_bounds():
    lower, upper = 0.1, 0.4
    x = -torch.rand(300, 400) - 0.1
    y = _train(tl.RReLU(lower, upper), x)
    slopes = y / x
    assert slopes.min() >= lower - 1e-6 and slopes.max() < upper + 1e-6
    assert abs(slopes.mean().item() - (lower + upper) / 2) < 0.005
    pos = torch.rand(10, 10)
    assert torch.equal(_train(tl.RReLU(lower, upper), pos), pos)


def test_gaussian_sampler_statistics():
    s = tl.GaussianSampler()
    s.ensure_built([(None, 300), (None, 300)])
    m = torch.randn(200, 300)
    lv = torch.randn(200, 300) * 0.5
    out = s.call({}, [m, lv], training=True, rng=_gen(5))
    eps = (out - m) / torch.exp(lv * 0.5)
    assert abs(eps.mean().item()) < 0.01 and abs(eps.std().item() - 1) < 0.01
