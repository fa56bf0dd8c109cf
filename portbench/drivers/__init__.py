"""One module a kind of traffic (``traffic/<mix>.json``'s ``kind``),
found by file name (``bench/spec.py``)."""
