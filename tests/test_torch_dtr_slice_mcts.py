"""The 23 fixture questions of ``tests/test_torch_dtr_slice.py`` through
the ``mcts`` planner of both packages: the same per-question answers, LLM
calls, depth rewards, plans, step code and events, and accuracy."""

import pytest

from test_torch_dtr_slice import jax_bench, questions  # noqa: F401 - fixtures
from test_torch_dtr_slice import test_fixture_questions_match_jax as check
from torch_native_helpers import jax_lib, jax_tracer_restored  # noqa: F401 - fixtures

pytestmark = pytest.mark.usefixtures("jax_lib", "jax_tracer_restored")


def test_fixture_questions_match_jax_mcts(questions, jax_bench):  # noqa: F811
    check("mcts", questions, jax_bench)
