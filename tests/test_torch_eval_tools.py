"""Port parity: the evaluation tools of motcpp_tpu_torch
(``motcpp_tpu_torch/scripts/eval_mot.py``, ``update_accuracy_table.py``
and ``run_benchmark.sh``) against the JAX package's ``scripts/`` of the
same names, on the same inputs.

``eval_mot`` must print the JAX tool's table and ``--json`` line
character for character on committed ``tests/golden_long`` sets;
``update_accuracy_table``, read from ``tests/golden_long``, must write
``tests/accuracy_mot17mini.json`` byte for byte (into ``tmp_path``) and
print the JAX tool's markdown; ``run_benchmark.sh`` must write the JAX
script's result files and print its metrics table. The JAX tools are
loaded with ``importlib`` (``scripts/`` is not a package); the JAX shell
script's ``python`` is a shim that points the JAX package's native IO at
the ``jax_native_parser`` fixture's library, so no process builds
``native/libmotcpp_io.so`` in place (ROADMAP queue 3).
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_threads  # noqa: F401  (torch at one thread)
from jax_cases import jax_native_parser  # noqa: F401
from motcpp_tpu_torch.scripts import eval_mot, update_accuracy_table

ROOT = Path(__file__).resolve().parent.parent
MOT_MINI = ROOT / "assets" / "MOT17-mini" / "train"
GOLDEN_LONG = ROOT / "tests" / "golden_long"

# runs a JAX tool as the JAX script's `python` would, with the package's
# native IO loaded from the library the test built
JAX_PYTHON_SHIM = """\
import os, runpy, sys
from pathlib import Path
sys.path.insert(0, os.getcwd())
import jax
jax.config.update("jax_platforms", "cpu")
from motcpp_tpu.utils import native_io
native_io._SO = Path(os.environ["JAX_NATIVE_IO_SO"])
if sys.argv[1] == "-m":
    sys.argv = sys.argv[2:]
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
else:
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
"""


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def output_of(main, *args):
    """(exit code, stdout, stderr) of ``main(*args)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(*args)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("as_json", [False, True], ids=["table", "json"])
@pytest.mark.parametrize("tracker", ["bytetrack", "ocsort", "strongsort"])
def test_eval_mot_prints_the_jax_tools_output(tracker, as_json):
    argv = ["--gt_folder", str(MOT_MINI),
            "--trackers_folder", str(GOLDEN_LONG / tracker)]
    argv += ["--json"] if as_json else []
    port = output_of(eval_mot.main, argv)
    assert port == output_of(load_jax_script("eval_mot").main, argv)
    rc, out, _ = port
    assert rc == 0 and "COMBINED" in out


def test_eval_mot_skips_sequences_without_gt_and_fails_without_any(tmp_path):
    """A result file without GT is skipped with the JAX tool's line on
    stderr; with none left both tools exit 1."""
    jax_main = load_jax_script("eval_mot").main
    res = tmp_path / "res"
    res.mkdir()
    (res / "MOT17-99-FRCNN.txt").write_text("1,1,10,10,20,20,0.9,-1,-1,-1\n")
    argv = ["--gt_folder", str(MOT_MINI), "--trackers_folder", str(res)]
    port = output_of(eval_mot.main, argv)
    assert port == output_of(jax_main, argv)
    assert port == (1, "", "# no GT for MOT17-99-FRCNN, skipping\n"
                           "No sequences evaluated\n")


def test_accuracy_table_reproduces_the_committed_table(tmp_path, monkeypatch):
    """Read from the committed long sets, the port's tool writes
    tests/accuracy_mot17mini.json byte for byte (into tmp_path) and
    prints the JAX tool's markdown."""
    monkeypatch.setattr(update_accuracy_table, "GOLDEN_LONG", GOLDEN_LONG)
    monkeypatch.setattr(update_accuracy_table, "TABLE", tmp_path / "port.json")
    jax_tool = load_jax_script("update_accuracy_table")
    monkeypatch.setattr(jax_tool, "TABLE", tmp_path / "jax.json")
    rc, port_out, _ = output_of(update_accuracy_table.main)
    jax_rc, jax_out, _ = output_of(jax_tool.main)
    assert rc == jax_rc == 0
    committed = (ROOT / "tests" / "accuracy_mot17mini.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == committed
    assert (tmp_path / "jax.json").read_bytes() == committed
    # the first line names the file each tool wrote
    assert port_out.split("\n", 1)[1] == jax_out.split("\n", 1)[1]
    assert port_out.count("\n| ") == len(json.loads(committed)) + 1


def test_accuracy_table_says_to_regenerate_when_the_sets_are_missing(
        tmp_path, monkeypatch):
    monkeypatch.setattr(update_accuracy_table, "GOLDEN_LONG",
                        tmp_path / "golden_long")
    monkeypatch.setattr(update_accuracy_table, "TABLE", tmp_path / "t.json")
    with pytest.raises(FileNotFoundError, match="regen_golden"):
        update_accuracy_table.main()
    assert not (tmp_path / "t.json").exists()


def metrics_table(stdout):
    """The eval tool's table in a run_benchmark.sh log (from its header
    to its COMBINED row)."""
    lines = stdout.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("seq "))
    end = next(i for i, ln in enumerate(lines) if ln.startswith("COMBINED"))
    return lines[start:end + 1]


def test_run_benchmark_sh_matches_the_jax_script(tmp_path, jax_native_parser):
    """TRACKERS=bytetrack over MOT17-mini: the port's script with
    CLI_FLAGS=--cpu writes the JAX script's result files byte for byte
    and prints its metrics table."""
    shim_dir = tmp_path / "bin"
    shim_dir.mkdir()
    (shim_dir / "shim.py").write_text(JAX_PYTHON_SHIM)
    python = shim_dir / "python"
    python.write_text(f'#!/bin/sh\nexec "{sys.executable}" '
                      f'"{shim_dir / "shim.py"}" "$@"\n')
    python.chmod(0o755)
    env = dict(os.environ, TRACKERS="bytetrack", JAX_PLATFORMS="cpu")
    runs = {}
    for side, script, extra in (
            ("port", "motcpp_tpu_torch/scripts/run_benchmark.sh",
             dict(CLI_FLAGS="--cpu", PYTHON=sys.executable)),
            ("jax", "scripts/run_benchmark.sh",
             dict(PATH=f"{shim_dir}:{env['PATH']}",
                  JAX_NATIVE_IO_SO=str(jax_native_parser._SO)))):
        proc = subprocess.run(
            ["bash", str(ROOT / script), "assets/MOT17-mini/train"],
            env=dict(env, OUT_BASE=str(tmp_path / side), **extra),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        runs[side] = proc.stdout
    port_files = sorted((tmp_path / "port" / "bytetrack").glob("*.txt"))
    assert [p.name for p in port_files] == [
        "MOT17-02-FRCNN.txt", "MOT17-04-FRCNN.txt"]
    for p in port_files:
        assert p.read_bytes() == (tmp_path / "jax" / "bytetrack" /
                                  p.name).read_bytes()
    assert metrics_table(runs["port"]) == metrics_table(runs["jax"])
    assert runs["port"].startswith("=== bytetrack\n")
