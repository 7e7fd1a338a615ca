"""The port stands alone: no module of src/repro_torch/ (and not
chip_smoke.py) imports JAX or the reference package, so the port runs on a
machine without JAX.  Checked twice: by importing every module in a fresh
interpreter and reading sys.modules, and by scanning the sources."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

FORBIDDEN = [re.compile(p, re.M) for p in (
    r"^\s*import\s+jax\b", r"^\s*from\s+jax\b",
    r"^\s*from\s+repro(\.|\s)", r"^\s*import\s+repro(\.|\s|,|$)")]


def _modules():
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_port_source_imports_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        for pat in FORBIDDEN:
            assert not pat.search(text), f"{f.relative_to(ROOT)}: {pat.pattern}"
