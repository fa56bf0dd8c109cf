"""The cases of ``tests/api/test_file_store.py`` on the port.

LocalFileStore path-safety tests (ADVICE r1: assert-based startswith
guard was bypassable via sibling-prefix dirs and stripped under -O)."""

import pytest

from youtu_rag_tpu_torch.api.state import LocalFileStore


@pytest.fixture
def store(tmp_path):
    return LocalFileStore(tmp_path)


def test_traversal_rejected(store):
    for name in ("../evil", "../../etc/passwd", "a/../../evil", "..", "."):
        with pytest.raises(ValueError):
            store.upload("uploads", name, b"x")
        with pytest.raises(ValueError):
            store.download("uploads", name)


def test_sibling_prefix_dir_rejected(store, tmp_path):
    # '..%2Fuploads-x%2Ff' decoded: resolves to a *sibling* of the bucket
    # dir that passes a bare startswith() check
    (tmp_path / "uploads-x").mkdir()
    with pytest.raises(ValueError):
        store.upload("uploads", "../uploads-x/f", b"x")
    assert not (tmp_path / "uploads-x" / "f").exists()


def test_nested_names_still_work(store):
    meta = store.upload("uploads", "derived/sub/ok.md", b"hello")
    assert meta["size"] == 5
    assert store.download("uploads", "derived/sub/ok.md") == b"hello"
    assert store.stat("uploads", "derived/sub/ok.md")["etag"] == meta["etag"]
