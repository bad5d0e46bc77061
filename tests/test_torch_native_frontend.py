"""The port's native C++ frontend (``instsearch_torch/data/native_frontend.py``
over ``instsearch_torch/csrc/frontend.cc``) against the reference's
(``instsearch_tpu/data/native_frontend.py`` over ``native/frontend.cc``):
the same source built by the same compiler, so every comparison is bit for
bit. The port's library is built into ``instsearch_torch/_build/`` and
nothing is written into ``native/``. The port's ``batch_paths`` streams
through it as the reference's ``_iter_images`` does, so both packages'
batches are equal (before the port preferred the native decoder, its
``batch_paths`` decoded with cv2 and differed by a grey level on ~10% of
the pixels of a resized image). Corrupt and missing files are quarantined;
threaded decoding equals single-threaded decoding."""
import os

import numpy as np
import pytest

from instsearch_tpu.data import frontend as jfrontend
from instsearch_tpu.data import native_frontend as jnf
from instsearch_tpu.eval import make_mini_dataset
from instsearch_torch.data import frontend
from instsearch_torch.data import native_frontend as nf

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return make_mini_dataset(str(tmp_path_factory.mktemp("mini_tnf")),
                             n_instances=2, n_views=2, n_distractors=2, seed=9)


def _snapshot(folder):
    return {n: os.stat(os.path.join(folder, n)).st_mtime_ns
            for n in sorted(os.listdir(folder))}


def test_builds_into_the_port_build_dir_only(tmp_path, monkeypatch):
    before = _snapshot(_NATIVE)
    monkeypatch.setattr(nf, "BUILD_DIR", str(tmp_path))
    path = nf.build()
    assert os.path.dirname(path) == str(tmp_path) and os.path.isfile(path)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    assert nf.build() == path                  # built once per source hash
    monkeypatch.undo()
    assert nf.available()
    assert os.path.dirname(nf.library_path()) == nf.BUILD_DIR
    assert nf.BUILD_DIR.endswith(os.path.join("instsearch_torch", "_build"))
    assert os.path.isfile(nf.library_path())
    assert _snapshot(_NATIVE) == before


@pytest.mark.parametrize("size", [32, 48, 64, 96])
def test_batches_equal_the_reference(mini, size):
    got, ok = nf.load_batch_native(mini.db_paths, size)
    want, jok = jnf.load_batch_native(mini.db_paths, size)
    assert ok.all() and jok.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,batch", [(48, 4), (64, 5), (80, 64)])
def test_batch_paths_equal_the_reference(mini, tmp_path, size, batch):
    """The repaired path: the port's batch_paths (native first) equals the
    reference's, quarantine included."""
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8garbage")
    paths = mini.db_paths[:3] + [bad] + mini.db_paths[3:]
    tq, jq = [], []
    got = list(frontend.batch_paths(paths, size, batch, tq))
    want = list(jfrontend.batch_paths(paths, size, batch, jq))
    assert len(got) == len(want)
    for (a, ia), (b, ib) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)
    assert tq == jq == [bad]


def test_corrupt_and_missing_quarantined(mini, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8garbage not a jpeg")
    paths = [mini.db_paths[0], str(bad), str(tmp_path / "missing.jpg"),
             mini.db_paths[1]]
    out, ok = nf.load_batch_native(paths, 32)
    assert list(ok) == [True, False, False, True]
    assert out[1].sum() == 0 and out[2].sum() == 0
    quarantine = []
    batches = list(frontend.batch_paths(paths, 32, 4, quarantine))
    assert quarantine == paths[1:3]
    assert batches[0][1].tolist() == [0, 3, -1, -1]


def test_threaded_equals_single_thread(mini):
    a, ok_a = nf.load_batch_native(mini.db_paths, 40, n_threads=1)
    b, ok_b = nf.load_batch_native(mini.db_paths, 40, n_threads=4)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ok_a, ok_b)
