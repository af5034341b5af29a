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


def test_port_imports_no_triton():
    """Every kernel of the port is CUDA C++ built by ``nvcc``: no module
    of the port, nor ``chip_smoke.py``, imports Triton."""
    bad = [(str(p.relative_to(ROOT)), mod) for p in _port_files()
           for mod in _imports(p) if mod.split(".")[0] == "triton"]
    assert not bad, bad


def test_card_tests_import_no_jax_and_nothing_of_the_jax_package():
    """``tests/test_torch_card.py`` runs on the card's machine, which has
    no JAX, without ``tests/conftest.py``: it imports torch, numpy,
    pytest and the port only."""
    mods = {m.split(".")[0] for m in
            _imports(ROOT / "tests" / "test_torch_card.py")}
    assert not mods & set(FORBIDDEN), mods
    assert mods <= {"numpy", "pytest", "torch", "repro_torch"}, mods


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
        "print(' '.join(names))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    names = r.stdout.split()
    assert len(names) >= 20
    assert {"repro_torch.serving.paged_kv", "repro_torch.serving.engine",
            "repro_torch.kernels.decode_attention.kernel",
            "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.core.pytree", "repro_torch.core.service",
            "repro_torch.core.compat", "repro_torch.core.compose",
            "repro_torch.core.netmodel", "repro_torch.core.registry",
            "repro_torch.core.transport", "repro_torch.core.deploy",
            "repro_torch.core.profile", "repro_torch.core.zoo_builders",
            "repro_torch.training.checkpoints",
            "repro_torch.serving.faults", "repro_torch.configs.pixtral_12b",
            "repro_torch.launch.zoo_cli", "repro_torch.serving.tracing",
            "repro_torch.serving.telemetry",
            "repro_torch.training.metrics"} <= set(names)


def test_paged_allocator_is_host_only():
    """``serving/paged_kv.py`` is the host page allocator: it imports
    numpy and the standard library only (no torch), so provisioning never
    touches the device."""
    mods = {m.split(".")[0] for m in
            _imports(PORT / "serving" / "paged_kv.py")}
    assert mods <= {"__future__", "typing", "numpy"}, mods
    assert "numpy" in mods


def test_paged_kernel_entry_point_raises_without_a_gpu():
    """Handed CPU tensors, the paged kernel's wrapper raises before it
    builds anything; the op routes them to the plain version."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.decode_attention import kernel, ops
    q = torch.zeros(1, 1, 2, 32)
    pool = torch.zeros(3, 8, 1, 32)
    bt = torch.full((1, 2), 2, dtype=torch.int32)
    pos = torch.full((1, 16), -1, dtype=torch.int32)
    q_pos = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.paged_decode_attention_cuda(q, pool, pool, bt, pos, q_pos)
    before = launch_counts()["paged_decode_attention"]
    out = ops.paged_decode_attention(q, pool, pool, bt, pos, q_pos)
    assert out.shape == q.shape and out.device.type == "cpu"
    assert launch_counts()["paged_decode_attention"] == before


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


def test_flash_kernel_needs_nvcc(monkeypatch, tmp_path):
    """The flash wrapper's launcher builds its library on first use; with
    no compiler it raises, as the other kernels' do."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(kernel, "_FNS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel._launcher()


@pytest.mark.parametrize("cmd", [["init-demo"], ["list"],
                                 ["deploy", "--name", "pipe"]])
def test_zoo_cli_needs_a_gpu_without_device_cpu(cmd, tmp_path):
    """The zoo CLI runs on the card unless ``--device cpu`` is given:
    without a CUDA device it exits with an error instead of running on
    the CPU (its subprocess sees no GPU)."""
    r = _run("from repro_torch.launch.zoo_cli import main\n"
             f"main(['--zoo', {str(tmp_path)!r}] + {cmd!r})\n")
    assert r.returncode != 0
    assert "CUDA device is required" in r.stderr


def test_registry_pull_needs_a_gpu_without_a_device(tmp_path):
    """Weights pulled from a zoo, or loaded from a pytree file, land on
    CUDA unless a device is named: without one the pull and the load
    raise; listing and publishing need none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from repro_torch.core import zoo_builders as zb
    from repro_torch.core.registry import Registry
    clf = zb.classifier_service("pixtral-12b", n_classes=4)
    clf = clf.with_params(clf.metadata["init_params"](0, "cpu"))
    reg = Registry(tmp_path)
    reg.publish(clf, builder="model.classifier",
                config={"arch": "pixtral-12b", "n_classes": 4})
    assert [n for n, _, _ in reg.list()] == [clf.name]
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        reg.pull(clf.name)
    assert Registry(tmp_path, device="cpu").pull(clf.name).n_params \
        == clf.n_params
    from repro_torch.training.checkpoints import load_pytree, save_pytree
    save_pytree(tmp_path / "p", {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        load_pytree(tmp_path / "p")
    assert load_pytree(tmp_path / "p", device="cpu")["w"].device.type \
        == "cpu"


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
