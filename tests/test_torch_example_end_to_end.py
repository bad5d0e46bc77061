"""The port's end-to-end walkthrough, ``examples/torch_end_to_end.py``, on
the mini fixture with ``--device cpu`` in a fresh interpreter whose
``sys.modules["jax"]`` is None (any import of JAX or ``instsearch_tpu``
fails).

It runs on the VGG16 weights it seeds, not the reference's, so it is held
to its own invariants (the ones ``chip_smoke.py`` phase 21 checks on the
card): the query of ``db_paths[0]`` returns that image first; every
filtered answer is a member of the subset (every other indexed name);
every mAP and mP@5 of the quality ladder lies in [0, 100]; the reloaded
index has 56 rows and its weights; the sharded search of row 0's own
descriptor returns row 0 first; and the index was saved under
``--workdir``.
"""
import ast
import os

from torch_example_runner import run_port


def test_end_to_end_walkthrough(tmp_path):
    from instsearch_torch.eval import load_dataset
    lines = run_port("torch_end_to_end", [
        "--device", "cpu", "--data-root", str(tmp_path / "data"),
        "--workdir", str(tmp_path)])
    ds = load_dataset("mini", str(tmp_path / "data"))
    assert lines[0] == (f"dataset mini: {len(ds.imlist)} db images, "
                        f"{len(ds.qimlist)} queries")
    indexed = next(ln for ln in lines if ln.startswith("indexed "))
    assert indexed.startswith(f"indexed {len(ds.imlist)} images, dim ")
    assert indexed.endswith("storage torch.int8")

    def names(prefix):
        line = next(ln for ln in lines if ln.startswith(prefix))
        return [nm for nm, _ in ast.literal_eval(line[len(prefix):])]

    first = os.path.splitext(os.path.basename(ds.db_paths[0]))[0]
    got = names("query results:")
    assert got[0] == first and len(got) == 5
    members = set(ds.imlist[::2])
    filtered = names("filtered results:")
    assert filtered and set(filtered) <= members
    ladder = ["base", "alpha-QE", "regional re-rank", "diffusion",
              "re-rank + spatial", "local whitening", "alpha-DBA (offline)"]
    for tag in ladder:
        line = next(ln for ln in lines if ln.startswith(f"{tag} ")
                    and " mAP " in ln)
        values = [float(v) for v in line[len(tag):].split()
                  if v.replace(".", "").isdigit()]
        assert values and all(0.0 <= v <= 100.0 for v in values), line
    assert "reloaded: 56 rows, weights" in lines
    sharded = next(ln for ln in lines if ln.startswith("sharded search "))
    assert sharded.startswith("sharded search over 1 device(s): [0, ")
    assert os.path.isfile(tmp_path / "example_index" / "meta.json")
