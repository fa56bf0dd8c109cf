"""The cases of ``tests/api/test_replay.py`` on the port.

Replay server card conversion (ref: scripts/utils/replay_server.py)."""

from youtu_rag_tpu_torch import replay_server
from youtu_rag_tpu_torch.db.models import TrajectoryRecord


def test_cards_mirror_live_protocol():
    rec = TrajectoryRecord(
        trace_id="t1",
        input="q",
        output="the answer",
        trajectory=[
            {"role": "user", "content": "q"},
            {"role": "tool", "name": "kb_embedding_search", "arguments": "{}", "output": "hits"},
            {"role": "assistant", "content": "draft"},
        ],
    )
    cards = replay_server.cards_from_trajectory(rec)
    types = [c["type"] for c in cards]
    assert types == ["plan", "tool_call", "tool_output", "text_delta", "final"]
    assert cards[1]["name"] == "kb_embedding_search"
    assert cards[-1]["content"] == "the answer"


def test_error_run_emits_error_card():
    rec = TrajectoryRecord(trace_id="t2", input="q", error="boom", trajectory=[])
    assert replay_server.cards_from_trajectory(rec)[-1]["type"] == "error"
