"""The port stands alone: no module of motcpp_tpu_torch (its scripts
among them), and not chip_smoke.py, imports jax, motcpp_tpu, bench.py or
the JAX package's scripts, and entry points called without a device
never run on the CPU where no CUDA device exists."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch at one thread)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "motcpp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "motcpp_tpu", "bench", "scripts")


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


def test_live_reid_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from motcpp_tpu_torch import create_tracker
    from motcpp_tpu_torch.appearance.osnet import osnet_x0_25
    from motcpp_tpu_torch.appearance.reid import ReIDBackend, make_embed_fn
    from motcpp_tpu_torch.models.botsort import (
        BotSortConfig,
        make_botsort,
        state_from_numpy,
    )
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    model = osnet_x0_25()
    for fused in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_embed_fn(model, fused=fused)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReIDBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_tracker("botsort")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_botsort(BotSortConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy({})
    init, step = make_botsort(BotSortConfig(emb_dim=4), device="cpu")
    embed = make_embed_fn(model, device="cpu")
    for kw in ({"embed_fn": embed}, {"embed_fn": embed, "emb_cadence": 8},
               {"with_warps": True}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiStreamRunner(init, step, 2, **kw)


@pytest.mark.parametrize("name", ["sort", "strongsort", "ocsort", "deepocsort",
                                  "boosttrack", "hybridsort", "ucmctrack"])
def test_tracker_entry_points_default_to_cuda_and_raise_without_it(no_cuda,
                                                                  name):
    import importlib

    from motcpp_tpu_torch import create_tracker
    from motcpp_tpu_torch.appearance.osnet import osnet_x0_25
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.cli import build_tracker
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    mod = importlib.import_module(f"motcpp_tpu_torch.models.{name}")
    config = next(getattr(mod, a) for a in dir(mod) if a.endswith("Config"))
    make = getattr(mod, f"make_{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_tracker(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tracker(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(config())
    init, step = make(config(), device="cpu")
    embed = make_embed_fn(osnet_x0_25(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiStreamRunner(init, step, 2, embed_fn=embed, crop_budget=4,
                          emb_priority=True)
    out = create_tracker(name, device="cpu").update(
        np.array([[10, 10, 50, 90, 0.9, 0]], np.float32))
    assert out.shape[1] == 8


def test_camera_motion_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda):
    from motcpp_tpu_torch.models.strongsort import (
        StrongSortConfig,
        make_strongsort,
    )
    from motcpp_tpu_torch.motion import cmc
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    for make in (cmc.ECCJax, cmc.SOFJax, lambda: cmc.create_cmc("ecc_jax")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    init, step = make_strongsort(StrongSortConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiStreamRunner(init, step, 2, cmc_fn=cmc.ecc_jax_batch,
                          cmc_scale=0.15)
    assert isinstance(cmc.create_cmc("ecc", prefer_jax=True, device="cpu"),
                      cmc.ECCJax)


def test_cpu_is_used_only_when_asked(no_cuda):
    from motcpp_tpu_torch import create_tracker

    tr = create_tracker("bytetrack", device="cpu")
    out = tr.update(np.array([[10, 10, 50, 90, 0.9, 0]], np.float32))
    assert out.shape == (1, 8)


def test_serving_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from motcpp_tpu_torch.models.bytetrack import (
        ByteTrackConfig,
        make_bytetrack,
    )
    from motcpp_tpu_torch.serving import TrackingService

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackingService.from_tracker("bytetrack", n_streams=2)
    init, step = make_bytetrack(ByteTrackConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackingService(init, step, 2)
    svc = TrackingService.from_tracker("bytetrack", n_streams=2,
                                       device="cpu")
    assert svc.device.type == "cpu"
    h = svc.attach()
    svc.submit(h, np.array([[10, 10, 50, 90, 0.9, 0]], np.float32))
    batch = svc.step()
    assert batch.tracks_for(h).shape == (1, 8)
    assert all(t.device.type == "cpu" for t in svc.states)


def test_serving_harness_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda, tmp_path):
    """The serving latency harness and the SLO sweep run on the card and,
    without --cpu, raise where there is none, before the sweep writes
    anything."""
    from motcpp_tpu_torch.scripts import serving_latency, slo_sweep

    assert any(p.parent.name == "scripts" for p in PORT_FILES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_latency.main(["--streams", "4", "--ticks", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_latency.main(["--tracker", "botsort", "--streams", "8",
                              "--live-reid", "--device-data", "--ticks", "2"])
    out = tmp_path / "slo.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slo_sweep.main(["--ticks", "2", "--out", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slo_sweep.main(["--tracker", "botsort", "--out", str(out)])
    assert not out.exists()


def test_attribution_tools_default_to_cuda_and_raise_without_it(no_cuda):
    """The time-attribution tools and the tracker builder are in the
    isolation checks' scope, run on the card and, without --cpu (or a
    device), raise where there is none."""
    from motcpp_tpu_torch.scripts import (
        ablate_cost,
        microbench_select,
        profile_osnet,
        profile_stages,
        tracker_fns,
    )

    scripts = {p.name for p in PORT_FILES if p.parent.name == "scripts"}
    assert {"ablate_cost.py", "microbench_select.py", "profile_osnet.py",
            "profile_stages.py", "tracker_fns.py"} <= scripts
    for main, argv in (
            (profile_osnet.main, ["--batch", "2"]),
            (profile_stages.main, ["--streams", "2", "--iters", "1"]),
            (ablate_cost.main, ["--tracker", "bytetrack", "--streams", "2"]),
            (microbench_select.main, ["--streams", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tracker_fns.build_tracker_fns("bytetrack")
    init, step = tracker_fns.build_tracker_fns("bytetrack", device="cpu")
    assert init(2) is not None


def test_long_run_script_defaults_to_cuda_and_raises_without_it(no_cuda):
    """The long-horizon streaming tool is in the isolation checks' scope,
    makes its scene and runs on the card, and without --cpu (or a
    device) raises where there is none."""
    from motcpp_tpu_torch.scripts import longrun_stability

    assert "longrun_stability.py" in {
        p.name for p in PORT_FILES if p.parent.name == "scripts"}
    for call in (lambda: longrun_stability.main([]),
                 lambda: longrun_stability.run(
                     longrun_stability.parser().parse_args(
                         ["--streams", "2", "--frames", "2", "--chunk", "2"])),
                 lambda: longrun_stability.make_device_scene(4, 32)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    scene_init, _ = longrun_stability.make_device_scene(4, 32, device="cpu")
    assert scene_init(torch.Generator().manual_seed(0)) is not None


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_yaml_import(path):
    """The card's machine has no PyYAML: the port reads its configs with
    its own reader (motcpp_tpu_torch/config.py)."""
    assert "yaml" not in imported_roots(path)


def test_utility_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda, tmp_path):
    from motcpp_tpu_torch.ops.matching import linear_assignment
    from motcpp_tpu_torch.utils.profiling import trace

    cost = np.array([[0.1, 0.9], [0.9, 0.1]], np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linear_assignment(cost, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(tmp_path / "t"):
            pass
    assert not (tmp_path / "t").exists()
    assert linear_assignment(cost, 0.5, device="cpu")[0] == [(0, 0), (1, 1)]
    with trace(tmp_path / "t", device="cpu"):
        torch.ones(2).sum()
    assert list((tmp_path / "t").glob("*.json"))


def test_sharded_entry_points_raise_without_cuda(no_cuda):
    """A runner, a service or a mesh given a CUDA device among
    ``devices`` raises where there is none, before anything runs (never
    a quiet move to the CPU); so does the two-process dryrun."""
    from motcpp_tpu_torch.models.bytetrack import (
        ByteTrackConfig,
        make_bytetrack,
    )
    from motcpp_tpu_torch.parallel import Mesh
    from motcpp_tpu_torch.parallel.multihost import dryrun_multihost, worker
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
    from motcpp_tpu_torch.serving import TrackingService

    init, step = make_bytetrack(ByteTrackConfig(), device="cpu")
    for devices in (["cuda"], ["cuda:0", "cuda:0"], ["cpu", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh(devices)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiStreamRunner(init, step, 2, devices=devices)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiStreamRunner(init, step, 2, device="cpu", devices=devices)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrackingService(init, step, 2, devices=devices)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrackingService.from_tracker("bytetrack", 2, devices=devices)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker(0, 1, 0, "cuda")
    for call in (dryrun_multihost, lambda: dryrun_multihost(2, "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()  # the default is the card, and no worker starts
