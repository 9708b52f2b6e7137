"""The port's linear-chain CRF (``keras/layers/crf.py``) against the JAX
package and against brute force, on the CPU.

- ``crf_log_likelihood`` equal to JAX's and to the exact enumeration of
  every tag path on tiny shapes, unmasked and masked;
- ``crf_nll``'s gradient to the emissions and the transitions against
  ``jax.grad``, through the packed layout (masked and unmasked);
- ``viterbi_decode``/``crf_decode`` paths equal to JAX's, unmasked and
  masked, on random scores and on tied ones (zero transitions, emissions
  from a few values: the first-index argmax and the identity backpointer
  of padded steps decide them);
- the ``CRF`` layer's packing, shapes and validation against JAX's.

Tolerances, absolute, f32: log-likelihoods 1e-5 (sums of S logsumexps of
O(1) terms in another order); gradients 1e-5; brute force 1e-4 (numpy's
enumeration sums exp of scores in float64 against float32). Paths are
compared exactly.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras.layers import crf as jcrf
from analytics_zoo_tpu_torch.keras.layers import crf as tcrf

LL_TOL = 1e-5
GRAD_TOL = 1e-5
BRUTE_TOL = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _case(seed, b=3, s=5, t=4, masked=False):
    rng = np.random.default_rng(seed)
    em = rng.standard_normal((b, s, t)).astype(np.float32)
    tr = rng.standard_normal((t, t)).astype(np.float32)
    tags = rng.integers(0, t, (b, s)).astype(np.int32)
    mask = None
    if masked:
        lengths = rng.integers(1, s + 1, b)
        lengths[0] = s
        mask = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
    return em, tr, tags, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_likelihood_matches_jax(seed, masked):
    em, tr, tags, mask = _case(seed, masked=masked)
    want = np.asarray(jcrf.crf_log_likelihood(
        jnp.asarray(em), jnp.asarray(tr), jnp.asarray(tags),
        None if mask is None else jnp.asarray(mask)))
    got = tcrf.crf_log_likelihood(_t(em), _t(tr), _t(tags),
                                  None if mask is None else _t(mask))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LL_TOL)


def _path_score(em, tr, b, path, length):
    s = sum(em[b, i, path[i]] for i in range(length))
    return s + sum(tr[path[i - 1], path[i]] for i in range(1, length))


@pytest.mark.parametrize("masked", [False, True])
def test_log_likelihood_and_viterbi_match_brute_force(masked):
    """The exact partition function and the best path by enumerating all
    T^S paths (as tests/test_text_models.py does for the JAX package);
    masked rows enumerate only their real steps."""
    em, tr, tags, mask = _case(7, b=3, s=4, t=3, masked=masked)
    lengths = (np.full(3, 4) if mask is None
               else mask.sum(1).astype(int))
    ll = tcrf.crf_log_likelihood(_t(em), _t(tr), _t(tags),
                                 None if mask is None else _t(mask)).numpy()
    vit = tcrf.viterbi_decode(_t(em), _t(tr),
                              None if mask is None else _t(mask)).numpy()
    for b in range(3):
        n = lengths[b]
        scores = {p: _path_score(em.astype(np.float64), tr, b, p, n)
                  for p in itertools.product(range(3), repeat=n)}
        log_z = np.log(sum(np.exp(v) for v in scores.values()))
        expect = _path_score(em.astype(np.float64), tr, b,
                             tuple(tags[b]), n) - log_z
        np.testing.assert_allclose(ll[b], expect, rtol=0, atol=BRUTE_TOL)
        best = max(scores, key=scores.get)
        assert tuple(vit[b, :n]) == best
        # padded steps repeat the last real tag (identity backpointers)
        assert (vit[b, n:] == vit[b, n - 1]).all()


def _packed(em, tr, mask):
    """The layer's packing, built in numpy: (B, S+T, T[+1])."""
    b, s, t = em.shape
    packed = np.concatenate([em, np.broadcast_to(tr, (b, t, t))], 1)
    if mask is not None:
        col = np.concatenate([mask, np.zeros((b, t), np.float32)], 1)
        packed = np.concatenate([packed, col[..., None]], -1)
    return np.ascontiguousarray(packed, np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_nll_gradient_matches_jax_grad(masked):
    """crf_nll through the packed tensor: its value and its gradient to
    the emissions and (summed over the tiled rows) the transitions."""
    em, tr, tags, mask = _case(11, b=4, s=6, t=5, masked=masked)
    t = em.shape[-1]

    def jloss(e, r):
        b = e.shape[0]
        packed = jnp.concatenate([e, jnp.broadcast_to(r, (b, t, t))], 1)
        if mask is not None:
            col = jnp.concatenate([jnp.asarray(mask),
                                   jnp.zeros((b, t), jnp.float32)], 1)
            packed = jnp.concatenate([packed, col[..., None]], -1)
        return jcrf.crf_nll(t)(jnp.asarray(tags), packed)

    jv, (jge, jgr) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(em), jnp.asarray(tr))

    e = _t(em).requires_grad_()
    r = _t(tr).requires_grad_()
    layer = tcrf.CRF(t, use_mask=masked)
    layer.ensure_built([(None, 6, t), (None, 6)] if masked else (None, 6, t))
    packed = layer.call({"transitions": r},
                        [e, _t(mask)] if masked else e)
    np.testing.assert_array_equal(packed.detach().numpy(),
                                  _packed(em, tr, mask))
    loss = tcrf.crf_nll(t)(_t(tags), packed)
    ge, gr = torch.autograd.grad(loss, (e, r))
    assert abs(loss.item() - float(jv)) <= LL_TOL
    np.testing.assert_allclose(ge.numpy(), np.asarray(jge), rtol=0,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(jgr), rtol=0,
                               atol=GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_viterbi_and_crf_decode_match_jax(seed, tied, masked):
    """Paths equal to JAX's. Tied cases: zero transitions (the layer's
    initial value) and emissions from three values, so most backpointers
    and last tags are decided by the first-index rule."""
    em, tr, _, mask = _case(20 + seed, b=6, s=7, t=5, masked=masked)
    if tied:
        em = np.round(em).clip(-1, 1).astype(np.float32)
        tr = np.zeros_like(tr)
    want = np.asarray(jcrf.viterbi_decode(
        jnp.asarray(em), jnp.asarray(tr),
        None if mask is None else jnp.asarray(mask)))
    got = tcrf.viterbi_decode(_t(em), _t(tr),
                              None if mask is None else _t(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    packed = _packed(em, tr, mask)
    jdec = np.asarray(jcrf.crf_decode(jnp.asarray(packed), 5))
    np.testing.assert_array_equal(tcrf.crf_decode(packed, 5).numpy(), jdec)
    np.testing.assert_array_equal(jdec, want)
    if masked:  # an explicit mask overrides the packed one
        ones = np.ones_like(mask)
        np.testing.assert_array_equal(
            tcrf.crf_decode(packed, 5, mask=_t(ones)).numpy(),
            np.asarray(jcrf.crf_decode(jnp.asarray(packed), 5,
                                       mask=jnp.asarray(ones))))


def test_single_step_sequences():
    """S = 1: no loop runs; the likelihood is a softmax over one step and
    the path its argmax (first index on ties), as in JAX."""
    em = np.array([[[0.5, 0.5, -1.0]], [[0.0, 2.0, 2.0]]], np.float32)
    tr = np.zeros((3, 3), np.float32)
    tags = np.array([[1], [2]], np.int32)
    got = tcrf.crf_log_likelihood(_t(em), _t(tr), _t(tags)).numpy()
    want = np.asarray(jcrf.crf_log_likelihood(jnp.asarray(em),
                                              jnp.asarray(tr),
                                              jnp.asarray(tags)))
    np.testing.assert_allclose(got, want, rtol=0, atol=LL_TOL)
    np.testing.assert_array_equal(
        tcrf.viterbi_decode(_t(em), _t(tr)).numpy(),
        np.asarray(jcrf.viterbi_decode(jnp.asarray(em), jnp.asarray(tr))))


@pytest.mark.parametrize("use_mask", [False, True])
def test_crf_layer_matches_jax(use_mask):
    shape = [(None, 6, 4), (None, 6)] if use_mask else (None, 6, 4)
    jl, tl = jcrf.CRF(4, use_mask=use_mask), tcrf.CRF(4, use_mask=use_mask)
    jl.ensure_built(shape)
    tl.ensure_built(shape)
    assert tl.output_shape == jl.output_shape
    spec = tl.weight_specs[0]
    assert spec.name == "transitions" and spec.shape == (4, 4)
    params = tl.init_params(torch.Generator().manual_seed(0))
    assert not params["transitions"].any()  # zeros, as JAX's init
    em, tr, _, mask = _case(3, b=2, s=6, t=4, masked=use_mask)
    jout = np.asarray(jl.call(
        {"transitions": jnp.asarray(tr)},
        [jnp.asarray(em), jnp.asarray(mask)] if use_mask
        else jnp.asarray(em)))
    tout = tl.call({"transitions": _t(tr)},
                   [_t(em), _t(mask)] if use_mask else _t(em))
    np.testing.assert_array_equal(tout.numpy(), jout)
    with pytest.raises(ValueError, match="emission scores"):
        tcrf.CRF(5).ensure_built((None, 6, 4))
