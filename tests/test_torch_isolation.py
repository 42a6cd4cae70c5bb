"""The port stands alone: no module of motcpp_tpu_torch, and not
chip_smoke.py, imports jax or motcpp_tpu, and entry points called
without a device never run on the CPU where no CUDA device exists."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "motcpp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "motcpp_tpu")


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    assert not imported_roots(path) & set(FORBIDDEN)


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    mods = [p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
            for p in PORT_FILES if p.name != "chip_smoke.py"]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import sys\n"
        f"for m in {mods!r}: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    from motcpp_tpu_torch import create_tracker
    from motcpp_tpu_torch.cli import main
    from motcpp_tpu_torch.models.bytetrack import (
        ByteTrackConfig,
        make_bytetrack,
        state_from_numpy,
    )
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_tracker("bytetrack")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_bytetrack(ByteTrackConfig())
    init, step = make_bytetrack(ByteTrackConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiStreamRunner(init, step, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy({})
    mot = ROOT / "assets" / "MOT17-mini" / "train"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(mot), str(tmp_path), "bytetrack"])
    assert not list(tmp_path.iterdir())


def test_cpu_is_used_only_when_asked(no_cuda):
    from motcpp_tpu_torch import create_tracker

    tr = create_tracker("bytetrack", device="cpu")
    out = tr.update(np.array([[10, 10, 50, 90, 0.9, 0]], np.float32))
    assert out.shape == (1, 8)
