"""The port's data-parallel trainer (``Trainer(mesh=group)``) in two
processes joined by gloo over the loopback, against one process on the
whole batch: a ResNet-18 at 64², 4 tuples of 4 images, f32, the GeM
exponent learned, for the contrastive loss and for Smooth-AP, whose
candidates are the whole batch's (each process gathers the others'
descriptors with autograd, so its loss is the one-process loss). Each
worker (tests/torch_train_worker.py, which imports no JAX) starts from its
own seed (``seed=rank``): the first process's weights are broadcast, so
both must start from seed 0's, as the one process does.

Tolerances: the loss at the start within 1e-6 relative and every gradient
tensor within 1e-5 of its largest element (the same f32 arithmetic over
halves of the batch, the gradients summed across processes: orders of
summation apart); two steps' losses within the reference's bars for its
data-parallel step (tests/distributed/test_trainer.py), 1e-4 and 1e-3
relative. A batch that does not split over the processes is refused.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_train_worker as worker

WORLD = 2


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_train_dp")
    with socket.socket() as s:                 # a free loopback port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(WORLD), str(port),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TRAIN_OK {r}" in log, \
            f"worker {r} failed:\n{log[-3000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """One process on the whole batch, per loss."""
    from instsearch_torch.train import Trainer
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {loss: worker.run(Trainer(worker.config(loss), seed=0,
                                         device="cpu"))
                for loss in worker.LOSSES}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("loss", worker.LOSSES)
def test_two_processes_equal_one(answers, single, loss):
    want = single[loss]
    grads = [k for k in want if k.startswith("grad:")]
    assert "grad:gem_p" in grads and "grad:conv1.weight" in grads
    for res in answers:
        assert res[f"{loss}/loss0"] == pytest.approx(want["loss0"], rel=1e-6)
        for k in grads:
            w = want[k]
            np.testing.assert_allclose(res[f"{loss}/{k}"], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)
        steps = res[f"{loss}/steps"]
        assert steps[0] == pytest.approx(want["steps"][0], rel=1e-4)
        assert steps[1] == pytest.approx(want["steps"][1], rel=1e-3)


@pytest.mark.parametrize("loss", worker.LOSSES)
def test_batch_must_split_over_the_processes(answers, loss):
    for res in answers:
        assert bool(res[f"{loss}/refused"])
