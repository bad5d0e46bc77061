"""Retrieval dataset loaders (the port's own copy of
``instsearch_tpu/eval/datasets.py``, which imports no JAX; the port imports
nothing of the JAX package).

Three on-disk formats:
  * classic Oxford5k/Paris6k ground-truth dirs (``*_query.txt`` /
    ``*_good.txt`` / ``*_ok.txt`` / ``*_junk.txt``, Philbin CVPR'07/'08)
  * revisited ROxford/RParis ``gnd_{name}.pkl`` pickles
    (Radenović arXiv:1803.11285; also the Oxford105k/+1M distractor lists)
  * a deterministic synthetic "mini" fixture, which exercises the same code
    paths where the real datasets are not on disk.
"""
from __future__ import annotations

import glob
import os
import pickle
from dataclasses import dataclass

import numpy as np


@dataclass
class RetrievalDataset:
    name: str
    image_root: str
    imlist: list[str]              # database image names (no extension)
    qimlist: list[str]             # query image names
    gnd: list[dict]                # per-query: easy/hard/junk (+ bbx)
    ext: str = ".jpg"

    def image_path(self, name: str) -> str:
        # distractor entries carry their own path
        if os.sep in name:
            return name + self.ext
        return os.path.join(self.image_root, name + self.ext)

    @property
    def db_paths(self) -> list[str]:
        return [self.image_path(n) for n in self.imlist]

    @property
    def query_paths(self) -> list[str]:
        return [self.image_path(n) for n in self.qimlist]


def load_revisited(name: str, data_root: str) -> RetrievalDataset:
    """Load ``gnd_{name}.pkl`` (roxford5k / rparis6k standard layout:
    ``{data_root}/{name}/gnd_{name}.pkl`` with images in ``jpg/``)."""
    base = os.path.join(data_root, name)
    with open(os.path.join(base, f"gnd_{name}.pkl"), "rb") as f:
        cfg = pickle.load(f)
    return RetrievalDataset(
        name=name,
        image_root=os.path.join(base, "jpg"),
        imlist=list(cfg["imlist"]),
        qimlist=list(cfg["qimlist"]),
        gnd=list(cfg["gnd"]),
    )


def load_classic(name: str, data_root: str) -> RetrievalDataset:
    """Load classic Oxford5k/Paris6k from a ground-truth file directory:
    ``{data_root}/{name}/gt/*_{query,good,ok,junk}.txt`` + ``jpg/``.
    Classic 'good'+'ok' map onto the revisited 'easy'/'hard' slots so the
    same protocol code evaluates both (protocol="classic")."""
    base = os.path.join(data_root, name)
    gt_dir = os.path.join(base, "gt")
    image_root = os.path.join(base, "jpg")
    imlist = sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(image_root, "*.jpg")))
    index_of = {n: i for i, n in enumerate(imlist)}

    def read_list(path):
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    qimlist, gnd = [], []
    for qfile in sorted(glob.glob(os.path.join(gt_dir, "*_query.txt"))):
        stem = os.path.basename(qfile)[:-len("_query.txt")]
        parts = read_list(qfile)[0].split()
        qname, bbx = parts[0], [float(v) for v in parts[1:5]]
        # oxford query names carry an 'oxc1_' prefix not present on disk
        if qname.startswith("oxc1_"):
            qname = qname[len("oxc1_"):]
        qimlist.append(qname)
        entry = {"bbx": bbx}
        for key, slot in (("good", "hard"), ("ok", "easy"), ("junk", "junk")):
            names = read_list(os.path.join(gt_dir, f"{stem}_{key}.txt"))
            entry[slot] = [index_of[n] for n in names if n in index_of]
        gnd.append(entry)
    return RetrievalDataset(name=name, image_root=image_root,
                            imlist=imlist, qimlist=qimlist, gnd=gnd)


# ---------------------------------------------------------------------------
# Synthetic mini fixture
# ---------------------------------------------------------------------------

def _mini_names(n_instances: int = 8, n_views: int = 4,
                n_distractors: int = 8) -> list[str]:
    """The file inventory make_mini_dataset writes (default parameters)."""
    names = []
    for inst in range(n_instances):
        names += [f"inst{inst:02d}_v{v}" for v in range(n_views)]
        names += [f"inst{inst:02d}_hard", f"inst{inst:02d}_junk",
                  f"query{inst:02d}"]
    names += [f"distractor{d:02d}" for d in range(n_distractors)]
    return names


def make_mini_dataset(root: str, n_instances: int = 8, n_views: int = 4,
                      n_distractors: int = 8, size: int = 64,
                      seed: int = 0) -> RetrievalDataset:
    """Deterministic synthetic instance-retrieval dataset.

    Each instance is a random low-frequency base pattern; database "views"
    are the base under small shift + noise + brightness jitter; queries are
    held-out views. Distractors are independent patterns. Ground truth:
    near-identical views are 'easy', heavier-corrupted ones 'hard', one
    extreme view per instance is 'junk'.
    """
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "jpg"), exist_ok=True)

    def base_pattern():
        low = rng.random((size // 8, size // 8, 3), dtype=np.float32)
        img = cv2.resize(low, (size, size), interpolation=cv2.INTER_CUBIC)
        return np.clip(img, 0, 1)

    def view(base, shift, noise, gain):
        img = np.roll(base, shift, axis=(0, 1)) * gain
        img = img + rng.normal(0, noise, base.shape).astype(np.float32)
        return np.clip(img, 0, 1)

    def save(name, img):
        path = os.path.join(root, "jpg", name + ".jpg")
        cv2.imwrite(path, (img * 255).astype(np.uint8)[:, :, ::-1])

    imlist, qimlist, gnd = [], [], []
    for inst in range(n_instances):
        base = base_pattern()
        easy, hard, junk = [], [], []
        for v in range(n_views):
            name = f"inst{inst:02d}_v{v}"
            save(name, view(base, (rng.integers(-2, 3), rng.integers(-2, 3)),
                            0.02, rng.uniform(0.95, 1.05)))
            easy.append(len(imlist))
            imlist.append(name)
        name = f"inst{inst:02d}_hard"
        save(name, view(base, (size // 6, size // 6), 0.10, 0.8))
        hard.append(len(imlist))
        imlist.append(name)
        name = f"inst{inst:02d}_junk"
        save(name, view(base, (size // 3, size // 3), 0.35, 0.6))
        junk.append(len(imlist))
        imlist.append(name)
        qname = f"query{inst:02d}"
        save(qname, view(base, (rng.integers(-2, 3), rng.integers(-2, 3)),
                         0.02, 1.0))
        qimlist.append(qname)
        gnd.append({"easy": easy, "hard": hard, "junk": junk,
                    "bbx": [0, 0, size, size]})
    for d in range(n_distractors):
        name = f"distractor{d:02d}"
        save(name, base_pattern())
        imlist.append(name)
    return RetrievalDataset(name="mini", image_root=os.path.join(root, "jpg"),
                            imlist=imlist, qimlist=qimlist, gnd=gnd)


def with_distractors(ds: RetrievalDataset, distractor_dir: str,
                     limit: int | None = None) -> RetrievalDataset:
    """Oxford105k-style: append distractor images (e.g. 100k Flickr) to the
    database. Ground-truth indices are unaffected because distractors are
    appended AFTER the base imlist (Philbin CVPR'07 §5)."""
    extra = sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(distractor_dir, "*.jpg")))
    if limit:
        extra = extra[:limit]
    return RetrievalDataset(
        name=ds.name + f"+{len(extra)}distractors",
        image_root=ds.image_root,   # distractor paths resolved separately
        imlist=ds.imlist + [os.path.join(distractor_dir, e) for e in extra],
        qimlist=ds.qimlist, gnd=ds.gnd, ext=ds.ext)


def load_dataset(name: str, data_root: str) -> RetrievalDataset:
    if name in ("roxford5k", "rparis6k"):
        return load_revisited(name, data_root)
    if name in ("oxford5k", "paris6k"):
        return load_classic(name, data_root)
    if name == "mini":
        root = os.path.join(data_root, "mini")
        jpg = os.path.join(root, "jpg")
        if os.path.exists(jpg):
            # default-parameter regeneration is byte-deterministic, so
            # overwriting a default fixture is a no-op — but a fixture
            # generated with OTHER parameters would be silently clobbered
            # and its extra files orphaned; refuse instead
            expected = set(n + ".jpg" for n in _mini_names())
            extra = set(os.listdir(jpg)) - expected
            if extra:
                raise ValueError(
                    f"{jpg} holds a non-default mini fixture (unexpected "
                    f"files e.g. {sorted(extra)[:3]}); refusing to "
                    f"regenerate over it — use make_mini_dataset directly "
                    f"or point --data-root elsewhere")
        return make_mini_dataset(root)
    raise ValueError(f"unknown dataset {name!r}")
