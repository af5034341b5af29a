"""What the PyTorch port may import and where its entry points run.

The port (``src/repro_torch/``) and ``chip_smoke.py`` import neither
``jax`` nor anything of the JAX package; every module imports where JAX,
Triton and a GPU are absent; and the CUDA entry points raise without a
CUDA device instead of running on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    bad = [(str(p.relative_to(ROOT)), mod) for p in _port_files()
           for mod in _imports(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_port_files()) > 20


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'repro' or k.startswith('repro.')\n"
        "               for k in sys.modules)\n"
        "print(len(names))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.models.model import build
    cfg = get_arch("llama3.2-1b", variant="reduced")
    for call in (lambda: resolve_device(None), lambda: build(cfg),
                 lambda: bridge.cache_from_jax({})):
        with pytest.raises(RuntimeError, match="CUDA device is required"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch):
    """No compiler, no kernel: the build raises, nothing stands in."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(alone, tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result without a
    CUDA device, and in a directory holding nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
