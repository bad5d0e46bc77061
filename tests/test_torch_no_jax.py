"""The port imports no JAX: in a fresh interpreter (this test process
already holds JAX through tests/conftest.py), import instsearch_torch, build
a tiny bf16 Index and a tiny int4 one, search them (the second with alpha
query expansion), then check sys.modules. The search path does
not import the reference package at all."""
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, sys
import numpy as np
import instsearch_torch
from instsearch_torch import PipelineConfig, IndexConfig
from instsearch_torch.index import Index
from instsearch_torch.serve import ServeCore

rng = np.random.default_rng(0)
x = rng.standard_normal((40, 16)).astype(np.float32)
x /= np.linalg.norm(x, axis=1, keepdims=True)
cfg = PipelineConfig(index=IndexConfig(row_tile=16))
idx = Index.from_descriptors(x, [f"r{i}" for i in range(40)], cfg)
s, i = idx.search(x[:3])
qcfg = PipelineConfig(index=IndexConfig(row_tile=16, dtype="int4"))
qidx = Index.from_descriptors(x, [f"r{i}" for i in range(40)], qcfg)
qs, qi = qidx.search(x[:3], qcfg.search.replace(qe_enabled=True))
assert qi[:, 0].tolist() == i[:, 0].tolist()
print(json.dumps({"top1": i[:, 0].tolist(), "rows": idx.descriptors.shape[0],
                  "jax": "jax" in sys.modules, "flax": "flax" in sys.modules,
                  "reference": [m for m in sys.modules
                                if m.startswith("instsearch_tpu")]}))
"""


def test_port_never_imports_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, timeout=120, cwd=_ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["top1"] == [0, 1, 2]
    assert res["rows"] == 48                 # padded to the row tile
    assert res["jax"] is False and res["flax"] is False
    assert res["reference"] == []
