"""The cases of ``tests/eval/test_benchmark.py`` on the port's ``eval/``
(``tests/torch_port_cases.py``: the same tests, their asserts as they
are, over ``youtu_rag_tpu_torch``)."""

from torch_port_cases import port_cases

globals().update(port_cases("eval/test_benchmark.py"))
