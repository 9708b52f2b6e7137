"""int8 inference of whole models in the port: weight-only
``do_quantize`` of a small BERT held against the JAX package's (the
``__q8__`` tensors and scales bitwise, the outputs within ``OUT_TOL`` in
float32), and the three accuracy cases of the JAX package's
``tests/test_quantization_accuracy.py`` (``:34``, ``:85``, ``:141``) on the
port, with their bars: at most one argmax flip over 512 samples, a mean
probability error under 0.02 (weight-only) and 0.03 (calibrated), the
int8 bytes under 1/3.2 of the float32 ones; and the fourth, int8 of a
converted keras.applications model loaded by ``from_pretrained``
(``:176``), with its bars (the qleaf arithmetic is held to the JAX
package's bitwise in ``tests/test_torch_quantization.py``).
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.tfpark.bert import BERTClassifierNet as JaxBERT
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.keras.layers as tl
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.inference.inference_model import param_bytes
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet
from test_torch_quantization import (
    OUT_TOL,
    _jax_model,
    _qleaves,
    _random_params,
    _same_qleaves,
)

BERT = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
            intermediate_size=64, hidden_drop=0.0, attn_drop=0.0)


@pytest.fixture(autouse=True)
def _contexts():
    zoo.init_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def test_do_quantize_bert_matches_jax():
    jnet = JaxBERT(num_classes=3, **BERT)
    params = _random_params(jnet, 3)
    jim = _jax_model(jnet, params)
    net = BERTClassifierNet(num_classes=3, **BERT)
    load_jax_params(net, params)
    jnet.compute_dtype = net.compute_dtype = None  # f32 compute
    im = InferenceModel().do_load_keras(net)
    f32_bytes = param_bytes(im.params)
    jim.do_quantize()
    im.do_quantize()
    _same_qleaves(jim.params, im.params)
    assert f32_bytes / param_bytes(im.params) >= 3.2
    rng = np.random.default_rng(5)
    mask = np.ones((4, 16), np.float32)
    mask[2:, 9:] = 0.0
    x = [(rng.integers(1, 50, (4, 16)) * mask).astype(np.int32),
         np.zeros((4, 16), np.int32), mask]
    np.testing.assert_allclose(im.do_predict(x), np.asarray(jim.do_predict(x)),
                               rtol=0, atol=OUT_TOL)


# -- accuracy (tests/test_quantization_accuracy.py on the port) -----------


def _planted(seed, n=512):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4, n).astype(np.int32)
    x = rng.normal(0, 0.25, (n, 16, 16, 1)).astype(np.float32)
    for i, k in enumerate(y):
        x[i, 2 + 3 * k: 5 + 3 * k, 2:14, 0] += 1.0
    return x, y


def _trained_cnn(seed):
    from analytics_zoo_tpu_torch.keras.optimizers import Adam

    x, y = _planted(seed)
    reset_name_counts()
    m = ttopo.Sequential(name="acc_cnn")
    m.add(tl.Convolution2D(8, (3, 3), activation="relu", border_mode="same",
                           dim_ordering="tf", input_shape=(16, 16, 1)))
    m.add(tl.MaxPooling2D((2, 2), dim_ordering="tf"))
    m.add(tl.Flatten())
    m.add(tl.Dense(32, activation="relu"))
    m.add(tl.Dense(4, activation="softmax"))
    m.compile(optimizer=Adam(lr=0.01),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    m.fit(x, y, batch_size=64, nb_epoch=8)
    assert m.evaluate(x, y, batch_size=64)["accuracy"] > 0.97
    return m, x, y


def test_int8_accuracy_within_point1_percent():
    m, x, y = _trained_cnn(0)
    inf = InferenceModel().do_load_keras(m)
    f32_bytes = param_bytes(inf.params)
    p_f32 = inf.do_predict(x)
    inf.do_quantize()
    q_bytes = param_bytes(inf.params)
    p_q = inf.do_predict(x)
    flipped = int(np.sum(p_f32.argmax(-1) != p_q.argmax(-1)))
    assert flipped <= 1, flipped
    assert q_bytes < f32_bytes / 3.2, (f32_bytes, q_bytes)
    assert float(np.mean(np.abs(p_q - p_f32))) < 0.02


def test_calibrated_int8_cnn_accuracy():
    m, x, y = _trained_cnn(1)
    inf = InferenceModel().do_load_keras(m)
    p_f32 = inf.do_predict(x)
    inf.do_calibrate([x[:128], x[128:256]])
    assert inf._calibrated
    assert len(_qleaves(inf.params)) == 3  # conv + 2 dense
    p_q = inf.do_predict(x)
    flipped = int(np.sum(p_f32.argmax(-1) != p_q.argmax(-1)))
    assert flipped <= 1, flipped
    assert float(np.mean(np.abs(p_q - p_f32))) < 0.03
    p_orig = np.asarray(m.predict(x, batch_size=64)).reshape(p_f32.shape)
    np.testing.assert_allclose(p_orig, p_f32, atol=1e-6)


def test_calibrated_int8_ncf_accuracy():
    """NCF through calibration: the embedding lookups and the merge stay
    float, the Dense tower runs integer; the ranking holds."""
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF

    rng = np.random.default_rng(2)
    n_users, n_items, n = 30, 40, 600
    reset_name_counts()
    ncf = NeuralCF(user_count=n_users, item_count=n_items, class_num=2,
                   hidden_layers=(16, 8))
    pairs = np.stack([rng.integers(1, n_users + 1, n),
                      rng.integers(1, n_items + 1, n)],
                     axis=1).astype(np.int32)
    y = ((pairs[:, 0] + pairs[:, 1]) % 2).astype(np.int32)
    m = ncf.model
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    m.fit(pairs, y, batch_size=64, nb_epoch=40)
    assert m.evaluate(pairs, y, batch_size=64)["accuracy"] > 0.95
    inf = InferenceModel().do_load_keras(m)
    p_f32 = inf.do_predict(pairs)
    inf.do_calibrate([pairs[:256]])
    p_q = inf.do_predict(pairs)
    flipped = int(np.sum(p_f32.argmax(-1) != p_q.argmax(-1)))
    assert flipped <= max(1, n // 1000), flipped
    assert float(np.mean(np.abs(p_q - p_f32))) < 0.03


def test_int8_parity_on_converted_applications_model(tmp_path):
    """The JAX package's fourth case: a keras.applications MobileNetV2
    (96x96, head biases spread so its predictions are decisive) through
    from_pretrained(whole-model .h5) -> do_load_keras, then (a) weight-only
    do_quantize and (b) calibrated int8 on a fresh load, each against the float32
    predictions with the JAX test's bars."""
    tf = pytest.importorskip("tensorflow")
    tf.config.set_visible_devices([], "GPU")
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier,
        imagenet_preprocess,
    )

    tf.keras.utils.set_random_seed(33)
    km = tf.keras.applications.MobileNetV2(weights=None,
                                           input_shape=(96, 96, 3))
    head = km.layers[-1]
    k, b = head.get_weights()
    b += np.random.RandomState(5).normal(0, 3.0, b.shape).astype(b.dtype)
    head.set_weights([k, b])
    hp = str(tmp_path / "mnv2_full.h5")
    km.save(hp)

    clf = ImageClassifier.from_pretrained("mobilenet-v2", hp)
    imgs = np.random.RandomState(2).randint(
        0, 256, (16, 96, 96, 3)).astype(np.uint8)
    x = imagenet_preprocess(imgs, clf.preprocess_mode)
    inf = InferenceModel().do_load_keras(clf.model)
    p_f32 = inf.do_predict(x)
    inf.do_quantize()
    assert len(_qleaves(inf.params)) >= 30
    p_q = inf.do_predict(x)
    assert int(np.sum(p_f32.argmax(-1) != p_q.argmax(-1))) == 0
    assert float(np.mean(np.abs(p_q - p_f32))) < 0.02

    inf2 = InferenceModel().do_load_keras(clf.model)
    inf2.do_calibrate([x[:8], x[8:]])
    assert len(_qleaves(inf2.params)) >= 30
    p_c = inf2.do_predict(x)
    assert int(np.sum(p_f32.argmax(-1) != p_c.argmax(-1))) == 0
    assert float(np.mean(np.abs(p_c - p_f32))) < 0.03
