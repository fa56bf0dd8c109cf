"""The cases of ``tests/index/test_warm.py`` on the port's index
(``tests/torch_port_cases.py``: the same tests, their asserts as they are,
over ``youtu_rag_tpu_torch``; the index made with ``device="cpu"``, where
the port's default is the card): the warm trigger at 75 % full, the
signatures and append buckets it warms, a search after the growth."""

from torch_port_cases import port_cases

globals().update(port_cases("index/test_warm.py", edits=(
    ('IndexConfig(min_capacity=128, block_rows=64))',
     'IndexConfig(min_capacity=128, block_rows=64), device="cpu")'),
    ('IndexConfig(min_capacity=128, block_rows=64, storage_dtype="int8"))',
     'IndexConfig(min_capacity=128, block_rows=64, storage_dtype="int8"), device="cpu")'),
)))
