"""The cases of ``tests/eval/test_retrieval_eval.py`` on the port's
``eval/retrieval_eval.py`` (``tests/torch_port_cases.py``: the same tests,
their asserts as they are, over ``youtu_rag_tpu_torch``). The KB runs on
the CPU (the port's KB defaults to the card)."""

from torch_port_cases import port_cases

globals().update(port_cases("eval/test_retrieval_eval.py", edits=(
    ('kb = KnowledgeBase("releval", cfg)', 'kb = KnowledgeBase("releval", cfg, device="cpu")'),)))
