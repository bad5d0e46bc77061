"""The port's prefetching input pipeline (``instsearch_torch/data/loader.py``)
and resumable builder (``instsearch_torch/builder.py``) against the
reference's (``instsearch_tpu/data/loader.py``, ``builder.py``).

Loader: ``PrefetchLoader`` and ``iter_batches`` give the batches, indices
and quarantine of ``frontend.batch_paths`` and of the reference's loader,
bit for bit (one decoder source); with ``device_put`` the batches arrive as
tensors on the device, equal; an abandoned iteration stops its producer.

Builder: both packages build ResNet-18 descriptors (32 px, f32, the same
Flax variables, an f32 store, one corrupt file among the paths) group by
group, crash after two groups, resume and finalize, as
tests/integration/test_resumable_build.py drives the reference. The
manifests are equal at the crash and at the end (groups, quarantine); the
port's resumed rows equal its uninterrupted ``Index.build`` bit for bit;
its rows are within 1e-5 of the reference's resumed rows (f32 convolution
summation order, tests/test_torch_resnet.py); a finalize before the end
is refused, a changed group size restarts the manifest."""
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from instsearch_tpu import ExtractConfig as JaxExtractConfig
from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.builder import ResumableBuilder as JaxResumableBuilder
from instsearch_tpu.data.loader import PrefetchLoader as JaxPrefetchLoader
from instsearch_tpu.eval import make_mini_dataset
from instsearch_torch import ExtractConfig, IndexConfig, PipelineConfig
from instsearch_torch.builder import ResumableBuilder
from instsearch_torch.data import frontend
from instsearch_torch.data.loader import PrefetchLoader, iter_batches
from instsearch_torch.index import Index

CFG = dict(backbone="resnet18", pooling="gem", image_size=32, batch_size=4,
           dtype="float32")
CRASH_AFTER = 2


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's small CPU tensors take one intra-op thread (no oversubscribed
    thread pools), restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return make_mini_dataset(str(tmp_path_factory.mktemp("mini_lb")),
                             n_instances=3, n_views=2, n_distractors=2,
                             seed=5)


@pytest.fixture(scope="module")
def paths(mini, tmp_path_factory):
    bad = str(tmp_path_factory.mktemp("bad") / "broken.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8not a jpeg")
    return mini.db_paths[:5] + [bad] + mini.db_paths[5:]


def _same_batches(got, want):
    assert len(got) == len(want)
    for (a, ia), (b, ib) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetch_matches_batch_paths_and_the_reference(paths, depth):
    runs = {}
    for name, make in (
            ("direct", lambda q: frontend.batch_paths(paths, 32, 4, q)),
            ("port", lambda q: PrefetchLoader(paths, 32, 4, depth=depth,
                                              quarantine=q)),
            ("iter", lambda q: iter_batches(paths, 32, 4, q, depth=depth)),
            ("jax", lambda q: JaxPrefetchLoader(paths, 32, 4, depth=depth,
                                                quarantine=q))):
        q = []
        runs[name] = (list(make(q)), q)
    for name in ("port", "iter", "jax"):
        _same_batches(runs[name][0], runs["direct"][0])
        assert runs[name][1] == runs["direct"][1] == [paths[5]]


def test_device_put_yields_equal_tensors(paths):
    want = list(frontend.batch_paths(paths, 32, 4))
    got = list(iter_batches(paths, 32, 4, depth=2, device_put=True,
                            device="cpu"))
    assert all(isinstance(b, torch.Tensor) and b.device.type == "cpu"
               and b.dtype == torch.uint8 for b, _ in got)
    _same_batches([(b.numpy(), i) for b, i in got], want)
    # a list within one batch takes the synchronous iterator
    small = list(iter_batches(paths[:3], 32, 4, device_put=True,
                              device="cpu"))
    _same_batches(small, list(frontend.batch_paths(paths[:3], 32, 4)))


def test_early_exit_stops_the_producer(paths):
    before = threading.active_count()
    for _ in iter_batches(paths, 32, 2, depth=1):
        break
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"


class _Crash(Exception):
    pass


def _crash_after(builder, groups):
    real = builder.extractor.extract_paths
    seen = []

    def extract(chunk, quarantine=None):
        if len(seen) >= groups:
            raise _Crash()
        seen.append(len(chunk))
        return real(chunk, quarantine)

    builder.extractor.extract_paths = extract
    return seen


def _resume(make, out, groups):
    b1 = make(out)
    _crash_after(b1, groups)
    with pytest.raises(_Crash):
        b1.run()
    with open(os.path.join(out, "manifest.json")) as f:
        at_crash = json.load(f)
    with pytest.raises(RuntimeError, match="incomplete"):
        b1.finalize()
    b2 = make(out)
    seen = _crash_after(b2, 1 << 30)
    b2.run()
    return b2, at_crash, seen


def test_resumed_build_equals_the_uninterrupted_one(paths, tmp_path):
    jcfg = JaxPipelineConfig(extract=JaxExtractConfig(**CFG),
                             index=JaxIndexConfig(dtype="float32"))
    tcfg = PipelineConfig(extract=ExtractConfig(**CFG),
                          index=IndexConfig(dtype="float32"))
    jb, jcrash, _ = _resume(
        lambda out: JaxResumableBuilder(paths, jcfg, out, group_size=1),
        str(tmp_path / "jax"), CRASH_AFTER)
    variables = jax.tree_util.tree_map(np.asarray, jb.extractor.variables)
    tb, tcrash, seen = _resume(
        lambda out: ResumableBuilder(paths, tcfg, out, group_size=1,
                                     variables=variables, device="cpu"),
        str(tmp_path / "port"), CRASH_AFTER)
    assert tcrash == jcrash
    assert len(tcrash["completed"]) == CRASH_AFTER
    assert len(seen) == -(-len(paths) // tb.group) - CRASH_AFTER
    assert tb.manifest == jb.manifest
    assert tb.manifest["quarantined"] == [paths[5]]

    jidx, tidx = jb.finalize(), tb.finalize()
    once = Index.build(paths, tcfg, variables=variables, device="cpu")
    n = tidx.num_valid
    assert n == once.num_valid == jidx.num_valid == len(paths) - 1
    assert tidx.names == once.names == list(jidx.names)
    assert torch.equal(tidx.descriptors, once.descriptors)
    assert torch.equal(tidx.ids, once.ids)
    assert tidx.quarantined == once.quarantined == [paths[5]]
    np.testing.assert_array_equal(tidx.ids.numpy()[:n],
                                  np.asarray(jidx.ids)[:n])
    np.testing.assert_allclose(tidx.descriptors[:n, :tidx.dim].numpy(),
                               np.asarray(jidx.descriptors, np.float32)[:n],
                               rtol=0, atol=1e-5)

    # a changed group size restarts the manifest in both packages
    t2 = ResumableBuilder(paths, tcfg, str(tmp_path / "port"), group_size=2,
                          variables=variables, device="cpu")
    j2 = JaxResumableBuilder(paths, jcfg, str(tmp_path / "jax"),
                             group_size=2)
    assert t2.manifest == j2.manifest and t2.manifest["completed"] == []
