"""The cases of ``tests/api/test_state_registry.py`` on the port (its ``ApiState`` on the CPU).

API state registry lifecycle: KBs built via the API must be visible
to agent KB toolkits (GLOBAL_KB_REGISTRY) and fully unregistered on
delete (registry + global + monitor)."""

import tempfile

import pytest

from youtu_rag_tpu_torch.api.state import ApiState
from youtu_rag_tpu_torch.retrieval.kb import GLOBAL_KB_REGISTRY
from torch_api_helpers import port_registry  # noqa: F401 - a fixture

# the KBs a test registers leave the port's process-wide registry with it
pytestmark = pytest.mark.usefixtures("port_registry")


def test_api_kbs_reach_global_registry_and_unregister():
    with tempfile.TemporaryDirectory() as d:
        state = ApiState(device="cpu", data_dir=d)
        name = "reg-lifecycle-test-kb"
        try:
            state.get_or_create_kb(name)
            # agent toolkits resolve through the GLOBAL registry — an
            # API-built KB must be visible there or chat-over-KB fails
            assert GLOBAL_KB_REGISTRY.get(name) is not None
            assert name in state.monitor.monitors

            assert state.remove_kb(name) is True
            assert GLOBAL_KB_REGISTRY.get(name) is None
            assert name not in state.monitor.monitors  # no stale backend row
            assert state.kbs.get(name) is None
        finally:
            GLOBAL_KB_REGISTRY.remove(name)
