"""The port's synthetic training data against the JAX package's, on the
CPU: the same seed gives the same identifier pairs (``data_synth``), the
same paraphrase lexicon, pairs and fixture (``paraphrase_synth``,
``TRAIN_SEED`` included) and the same chat-LM episodes and samples, byte
for byte (``lm_synth``, rendered through each package's own serving code:
a drift between the training and serving formats would show here). The
paraphrase fixture's own invariants run on the port as the cases of
``tests/models/test_paraphrase_synth.py``."""

import dataclasses

import pytest

from youtu_rag_tpu.models import data_synth as jax_data
from youtu_rag_tpu.models import lm_synth as jax_lm_synth
from youtu_rag_tpu.models import paraphrase_synth as jax_para
from youtu_rag_tpu_torch.models import data_synth as port_data
from youtu_rag_tpu_torch.models import lm_synth as port_lm_synth
from youtu_rag_tpu_torch.models import paraphrase_synth as port_para
from torch_native_helpers import jax_tracer_restored  # noqa: F401 - a fixture
from torch_port_cases import port_cases

pytestmark = pytest.mark.usefixtures("jax_tracer_restored")

globals().update(port_cases("models/test_paraphrase_synth.py"))


@pytest.mark.parametrize("groups,siblings,seed", [(64, 4, 0), (17, 3, 5), (1, 8, 101)])
def test_identifier_pairs_equal_jax(groups, siblings, seed):
    assert port_data.gen_identifier_pairs(groups, siblings, seed) == \
        jax_data.gen_identifier_pairs(groups, siblings, seed)


def test_paraphrase_data_equals_jax():
    assert port_para.TRAIN_SEED == jax_para.TRAIN_SEED
    assert port_para.TRAIN_PAIRS_DEFAULT == jax_para.TRAIN_PAIRS_DEFAULT
    assert port_para.paraphrase_lexicon() == jax_para.paraphrase_lexicon()
    pairs, used = port_para.gen_paraphrase_pairs(300, seed=port_para.TRAIN_SEED)
    assert (pairs, used) == jax_para.gen_paraphrase_pairs(300, seed=jax_para.TRAIN_SEED)
    assert port_para.gen_paraphrase_fixture(40, exclude=used) == \
        jax_para.gen_paraphrase_fixture(40, exclude=used)


@pytest.mark.parametrize("seed", [0, 7])
def test_lm_synth_samples_equal_jax_byte_for_byte(seed):
    samples, episodes = port_lm_synth.synth_corpus(24, seed=seed)
    want_samples, want_episodes = jax_lm_synth.synth_corpus(24, seed=seed)
    assert samples == want_samples
    assert [dataclasses.asdict(e) for e in episodes] == \
        [dataclasses.asdict(e) for e in want_episodes]
    assert all(s.encode() == w.encode() for pair, want in zip(samples, want_samples)
               for s, w in zip(pair, want))


def test_lm_synth_tool_schemas_and_instructions_equal_jax():
    from youtu_rag_tpu_torch import cli_chat

    assert port_lm_synth._tool_schemas() == jax_lm_synth._tool_schemas()
    assert port_lm_synth.DEFAULT_KB_INSTRUCTIONS == jax_lm_synth.DEFAULT_KB_INSTRUCTIONS
    assert cli_chat.DEFAULT_KB_INSTRUCTIONS == jax_lm_synth.DEFAULT_KB_INSTRUCTIONS
    for easy in (True, False, None):
        import random

        want = jax_lm_synth.synth_episode(random.Random(3), top_k=5, easy=easy)
        got = port_lm_synth.synth_episode(random.Random(3), top_k=5, easy=easy)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        tools = port_lm_synth._tool_schemas()
        assert port_lm_synth.render_episode_samples(got, tools, "Be brief.") == \
            jax_lm_synth.render_episode_samples(want, tools, "Be brief.")
