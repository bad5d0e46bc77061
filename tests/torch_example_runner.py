"""Runs the walkthroughs of ``examples/`` for the tests: the port's in a
fresh interpreter where JAX cannot be imported, the reference's in the
calling process; each returns the lines the script printed."""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = os.path.join(_ROOT, "examples")

# a fresh interpreter: JAX unimportable, two intra-op threads, the script's
# main() with the given arguments; prints the JAX and reference modules
# that were imported (none) on its last line
_PORT_RUNNER = """
import json, runpy, sys
sys.modules["jax"] = None
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
main = runpy.run_path({path!r})["main"]
rc = main({argv!r})
print(json.dumps(sorted(m for m, v in sys.modules.items()
                        if m.startswith(("instsearch_tpu", "jax"))
                        and v is not None)))
sys.exit(rc)
"""


def run_port(name: str, argv: list) -> list[str]:
    """``examples/<name>.py``'s ``main(argv)`` in a fresh interpreter
    without JAX -> its printed lines (the check line dropped)."""
    path = os.path.join(_EXAMPLES, f"{name}.py")
    out = subprocess.run(
        [sys.executable, "-c", _PORT_RUNNER.format(root=_ROOT, path=path,
                                                   argv=argv)],
        capture_output=True, text=True, timeout=300, cwd=_ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == [], lines[-1]
    return lines[:-1]


def run_reference(name: str, argv: list) -> list[str]:
    """The reference's ``examples/<name>.py`` in this process, with
    ``sys.argv`` set to ``argv`` -> its printed lines."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(_EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [name] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            assert mod.main() == 0
    finally:
        sys.argv = saved
    return buf.getvalue().strip().splitlines()
