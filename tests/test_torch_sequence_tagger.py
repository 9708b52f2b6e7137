"""The port's ``SequenceTagger`` (``tfpark/text.py``; the softmax head,
the CRF head, and the CRF head without chars) against the JAX package, on
the CPU: the forward, ``default_loss()``, ``predict_chunk_tags``, a 3-step
``fit`` trajectory and a save/load round trip, by the tests and the
tolerances of ``test_torch_text_tagging.py`` over this file's cases."""

import pytest

from analytics_zoo_tpu_torch import tfpark as ttfpark
from analytics_zoo_tpu_torch.tfpark import text as ttext

import test_torch_text_tagging as tagging
from test_torch_text_tagging import _port_context  # noqa: F401 (fixture)

TAGGERS = [k for k in tagging.ALL_CASES if k.startswith("tagger")]


@pytest.mark.parametrize("name", TAGGERS)
def test_forward_loss_and_decode_match_jax(name):
    tagging.test_forward_loss_and_decode_match_jax(name)


@pytest.mark.parametrize("name", TAGGERS)
def test_three_step_fit_matches_jax(name, tmp_path):
    tagging.test_three_step_fit_matches_jax(name, tmp_path)


@pytest.mark.parametrize("name", ["tagger-crf"])
def test_save_load_round_trips(name, tmp_path):
    tagging.test_save_load_round_trips(name, tmp_path)


def test_pos_tagger_is_sequence_tagger():
    assert ttfpark.POSTagger is ttfpark.SequenceTagger is ttext.SequenceTagger
