"""The port imports nothing of JAX, and ``chip_smoke.py`` refuses to run
without a GPU.

Every file of ``horovod_tpu_torch/``, ``chip_smoke.py``,
``flash_ablation.py`` and ``controller_ab.py`` is parsed, and
any import of ``jax``, ``flax``, ``optax`` or ``horovod_tpu`` (the JAX
package; ``horovod_tpu_torch`` is the port itself) fails its case.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "horovod_tpu"}
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "horovod_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "flash_ablation.py", "controller_ab.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("rel", FILES)
def test_port_file_imports_no_jax(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = sorted({m for m in _imported_modules(tree)
                  if m.split(".")[0] in FORBIDDEN})
    assert not bad, f"{rel} imports {bad}"


def test_scan_sees_the_whole_package():
    assert len(FILES) >= 15
    assert "horovod_tpu_torch/ops/flash_attention.py" in FILES


EAGER_MODULES = ["cpp_core", "core", "metrics", "timeline", "wire",
                 "ops/executor", "ops/eager", "optimizer", "scheduler",
                 "sparse", "observe", "callbacks", "data", "checkpoint",
                 "ckpt_stream", "run", "elastic", "policy", "aggregate"]


@pytest.fixture(scope="module")
def eager_imports():
    """The top-level packages loaded by a fresh interpreter that imports
    every module of the eager plane."""
    mods = ", ".join("horovod_tpu_torch." + n.replace("/", ".")
                     for n in EAGER_MODULES)
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys, {mods}; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return ast.literal_eval(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", EAGER_MODULES)
def test_scan_covers_the_eager_plane(name, eager_imports):
    """The modules of the eager plane, of the gradient route through it,
    of resilience (checkpoints, the async stream, the launcher and
    elastic membership) and of the control plane's fleet policy and
    aggregation containers are scanned, and import without JAX or the JAX
    package."""
    assert f"horovod_tpu_torch/{name}.py" in FILES
    assert not FORBIDDEN & set(eager_imports)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
