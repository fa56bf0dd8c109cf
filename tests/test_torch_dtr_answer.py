"""The cases of ``tests/test_dtr_answer.py`` on the port's
``integrations/dtr/`` (``tests/torch_port_cases.py``: the same tests, their
asserts as they are, over ``youtu_rag_tpu_torch``)."""

from torch_port_cases import port_cases

globals().update(port_cases("test_dtr_answer.py"))
