"""Worker of the port's data-parallel training test
(test_torch_train_dp.py): one of P processes joined by gloo over the
loopback, each a ``Trainer(mesh=group)`` handed the whole batch.

    python torch_train_worker.py <rank> <world> <port> <out_dir>

For each loss (contrastive, Smooth-AP) the process computes the loss and
the gradients at the seeded weights (``value_and_grad``), takes two
optimizer steps on two batches, checks that a batch that does not split
over the processes is refused, and writes everything to
``<out_dir>/rank<rank>.npz``. It imports no JAX.
"""
import os
import sys

import numpy as np

B, T, S = 4, 4, 64
LOSSES = ("contrastive", "smoothap")


def config(loss: str):
    from instsearch_torch.config import TrainConfig
    return TrainConfig(backbone="resnet18", pooling="gem", image_size=S,
                       batch_size=B, num_negatives=T - 2, dtype="float32",
                       learn_gem_p=True, loss=loss, smoothap_tau=0.05)


def batch(seed: int, b: int = B) -> np.ndarray:
    """``[b, T, S, S, 3]`` uint8 tuples: anchor, a noisy copy, others."""
    rng = np.random.default_rng(seed)
    base = rng.random((b, 1, S, S, 3))
    pos = np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1)
    neg = rng.random((b, T - 2, S, S, 3))
    return (np.concatenate([base, pos, neg], 1) * 255).astype(np.uint8)


def run(trainer) -> dict:
    """The loss and gradients at the start, then two steps' losses."""
    loss, grads = trainer.value_and_grad(batch(0))
    res = {"loss0": float(loss)}
    res.update({f"grad:{k}": g.numpy() for k, g in grads.items()})
    res["steps"] = np.asarray([trainer.step(batch(s))["loss"]
                               for s in (0, 1)])
    return res


def main(rank: int, world: int, port: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch
    import torch.distributed as dist
    from instsearch_torch.parallel import initialize
    from instsearch_torch.train import Trainer
    torch.set_num_threads(1)
    assert initialize(backend="gloo")
    res = {}
    for loss in LOSSES:
        tr = Trainer(config(loss), mesh=dist.group.WORLD, seed=rank,
                     device="cpu")
        res.update({f"{loss}/{k}": v for k, v in run(tr).items()})
        try:
            tr.step(batch(2, b=world + 1))
        except ValueError:
            res[f"{loss}/refused"] = True
    assert "jax" not in sys.modules
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    print(f"TRAIN_OK {rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
