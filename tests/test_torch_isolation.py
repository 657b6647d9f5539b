"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the reference package ``repro``."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[.\s]|$)",
                       re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                       "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len(names), bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25, out.stdout


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 25
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders


def test_the_port_and_its_tools_need_no_ml_dtypes():
    """The card's machine has no ``ml_dtypes`` (JAX's bfloat16 for numpy):
    no source of the port, ``chip_smoke.py`` or ``tools/`` imports it,
    nor does importing every module of the port (bf16 checkpoints are
    written and read as 2-byte records), and ``tools/`` imports neither
    jax nor the reference."""
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    pattern = re.compile(r"^\s*(?:import|from)\s+ml_dtypes(?:[.\s]|$)",
                         re.MULTILINE)
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files
                 for rx in (pattern, FORBIDDEN)
                 for m in rx.finditer(f.read_text())]
    assert not offenders, offenders
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        assert "ml_dtypes" not in sys.modules
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
