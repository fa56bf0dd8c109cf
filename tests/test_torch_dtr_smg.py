"""The cases of ``tests/test_dtr_smg.py`` on the port's
``integrations/dtr/`` (``tests/torch_port_cases.py``: the same tests, their
asserts as they are, over ``youtu_rag_tpu_torch``)."""

import asyncio
import os
import tempfile
import time

import pandas as pd
import pytest

from torch_port_cases import port_cases
from youtu_rag_tpu_torch.integrations.dtr.smg import SheetStateMachine, _ForkServer

globals().update(port_cases("test_dtr_smg.py"))


# The port's sandbox repairs, on the fork-server and on the cold path
# (YRT_DTR_FORKSERVER=0): a timeout kills the step's process group and
# leaves no temporary file; a step killed by SIGKILL reads as a crash.

@pytest.fixture(params=["1", "0"], ids=["forkserver", "cold"])
def sandbox(request, tmp_path, monkeypatch):
    """A one-sheet machine whose fork-server (started anew) and cold
    subprocess put their temporary files under ``tmp_path/tmp``."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    sheet = tmp_path / "t.csv"
    pd.DataFrame({"a": [1, 2]}).to_csv(sheet, index=False)
    monkeypatch.setenv("YRT_DTR_FORKSERVER", request.param)
    monkeypatch.setenv("TMPDIR", str(tmp))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    _ForkServer._shutdown()
    _ForkServer._proc = None
    yield SheetStateMachine(str(sheet), exec_timeout=6.0), tmp
    _ForkServer._shutdown()
    _ForkServer._proc = None


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_timeout_kills_the_steps_process_group(sandbox, tmp_path):
    smg, tmp = sandbox
    pid_file = tmp_path / "grandchild.pid"
    code = (
        "import os, time\n"
        "pid = os.fork()\n"
        "if pid == 0:\n"
        "    null = os.open(os.devnull, os.O_RDWR)\n"
        "    os.dup2(null, 1); os.dup2(null, 2)  # holds no pipe of the step\n"
        "    time.sleep(60)\n"
        "    os._exit(0)\n"
        f"open({str(pid_file)!r}, 'w').write(str(pid))\n"
        "time.sleep(60)\n"
    )
    out, state = asyncio.run(smg.execute_step(code))
    assert out == "Error: execution timed out" and state == {}
    grandchild = int(pid_file.read_text())
    deadline = time.time() + 5
    while _alive(grandchild) and time.time() < deadline:
        time.sleep(0.05)
    assert not _alive(grandchild)
    assert os.listdir(tmp) == []


def test_sigkilled_step_reads_as_a_crash(sandbox):
    smg, tmp = sandbox
    script = "import os, signal\nprint('before')\nos.kill(os.getpid(), signal.SIGKILL)\n"
    out, err, rc, timed_out = asyncio.run(smg._run_script(script))
    assert (rc, timed_out) == (-9, False)
    out, state = asyncio.run(
        smg.execute_step("import os, signal\nos.kill(os.getpid(), signal.SIGKILL)"))
    assert "timed out" not in out and "Error" in out
    assert os.listdir(tmp) == []
