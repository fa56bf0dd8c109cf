"""The cases of ``tests/test_dtr.py`` on the port's ``integrations/dtr/``
(``tests/torch_port_cases.py``: the same tests, their asserts as they are,
over ``youtu_rag_tpu_torch``). The experience case's memory toolkit runs
on the CPU (the port's store defaults to the card)."""

from torch_port_cases import port_cases

globals().update(port_cases("test_dtr.py", edits=(
    ('VectorMemoryToolkit({"user_id": "dtr"})',
     'VectorMemoryToolkit({"user_id": "dtr", "device": "cpu"})'),)))
