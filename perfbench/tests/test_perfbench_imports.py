"""Importing any part of the benchmark loads neither JAX nor the JAX
package, and the reference loads nothing of the port either. Module names
are compared by their whole top-level name, so `cornelis_tpu_torch` is not
`cornelis_tpu`."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"

# Files whose stem is a module name are imported as modules of the
# perfbench package; a metric file's name may hold dots, so it is loaded
# from its path, as the harness loads it.
_PROBE = """
import importlib, importlib.util, json, sys
sys.path.insert(0, {root!r})
for i, name in enumerate({names!r}):
    if name.endswith(".py"):
        spec = importlib.util.spec_from_file_location(f"probe_{{i}}", name)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        importlib.import_module(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _name(path):
    rel = path.relative_to(ROOT).with_suffix("")
    return str(path) if "." in rel.name else ".".join(rel.parts)


def _top_level_after_import(paths):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT),
                                                              names=[_name(p) for p in paths])],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    import json

    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _files(sub):
    return sorted((BENCH / sub).glob("*.py"))


HARNESS = [BENCH / "harness.py", BENCH / "tracing.py", BENCH / "calibrate.py",
           BENCH / "metrics_common.py", BENCH / "run.py"]


@pytest.mark.parametrize("group", ["harness", "kinds", "metrics", "reference"])
def test_no_jax(group):
    paths = HARNESS if group == "harness" else _files(group)
    assert paths
    loaded = _top_level_after_import(paths)
    assert not loaded & {"jax", "jaxlib", "flax", "cornelis_tpu"}


def test_reference_imports_nothing_of_the_port():
    loaded = _top_level_after_import(_files("reference"))
    assert "cornelis_tpu_torch" not in loaded
    assert "torch" in loaded


def test_reference_sources_name_no_program_module():
    for path in _files("reference"):
        text = path.read_text()
        assert "cornelis_tpu_torch" not in text.replace("`cornelis_tpu_torch", ""), path
        assert "import jax" not in text and "from jax" not in text, path
