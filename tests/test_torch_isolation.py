"""The port stands alone: no file of ``src/repro_torch``, ``chip_smoke.py``,
``ab_flash_fwd.py``, ``ab_flash_bwd.py``, ``ab_ssd.py`` nor ``ssd_rounding.py``
imports JAX or the ``repro`` package, and ``chip_smoke.py`` refuses to run without a card or without the
repository beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "ab_flash_fwd.py",
    ROOT / "ab_flash_bwd.py", ROOT / "ab_ssd.py", ROOT / "ssd_rounding.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


PORT_MODULES = (
    "repro_torch.launch.serve", "repro_torch.serve.engine",
    "repro_torch.checkpoint.io", "repro_torch.launch.train",
    "repro_torch.launch.profile_train", "repro_torch.core.swap",
    "repro_torch.core.swa", "repro_torch.train.loop",
    "repro_torch.data.pipeline", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.swa_avg", "repro_torch.kernels.ssd",
    "repro_torch.models.mamba2")


def test_importing_the_port_loads_no_jax():
    code = (f"import sys, {', '.join(PORT_MODULES)}; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    proc = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = _run([str(alone)], tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
