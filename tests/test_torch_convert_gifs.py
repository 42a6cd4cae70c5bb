"""Port parity: the weight converter and the demo-GIF renderer of
motcpp_tpu_torch (``motcpp_tpu_torch/scripts/convert_reid_weights.py``,
``generate_demo_gifs.py``) against the JAX package's ``scripts/`` of the
same names, loaded with ``importlib``, on the CPU.

Both converters, fed one ``scripts/torch_osnet.py`` x0_25 checkpoint
(``randomize_``), must write .npz files with the same keys and bit-equal
arrays, which the port's ``ReIDBackend`` loads. The port's OSNet has
torchreid's state_dict names, those of ``scripts/torch_osnet.py`` but its
training classifier, which both converters skip: so that file has no
counterpart in the port. The renderer over the synthetic camera-pan
scene must track as the JAX tool does (ids exact), draw the same pixels
and write the same GIF files.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import motcpp_tpu
import motcpp_tpu.utils.visualization as jax_vis
import motcpp_tpu_torch
import motcpp_tpu_torch.utils.visualization as port_vis
import torch_threads  # noqa: F401  (torch at one thread)
from ablation_parity import first_difference, recording
from motcpp_tpu_torch.appearance import osnet
from motcpp_tpu_torch.appearance.reid import ReIDBackend
from motcpp_tpu_torch.scripts import convert_reid_weights, generate_demo_gifs

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_osnet  # noqa: E402


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_converters_write_the_same_npz(tmp_path, capsys):
    model = torch_osnet.randomize_(torch_osnet.osnet_x0_25(), seed=3)
    src = tmp_path / "osnet.pt"
    torch.save(model.state_dict(), src)
    port, jax = tmp_path / "port.npz", tmp_path / "jax.npz"
    assert convert_reid_weights.main([str(src), str(port), "x0_25"]) == 0
    assert load_jax_script("convert_reid_weights").main(
        [str(src), str(jax), "x0_25"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1].replace(str(jax), str(port))
    assert out[0] == f"wrote {port} (485 tensors, variant x0_25)"
    with np.load(port) as p, np.load(jax) as j:
        assert sorted(p.files) == sorted(j.files) and len(p.files) == 485
        for k in p.files:
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape
            assert p[k].tobytes() == j[k].tobytes(), k
    backend = ReIDBackend(weights=str(port), device="cpu")
    feats = backend.get_features(
        np.asarray([[0, 0, 64, 128], [10, 5, 60, 100]], np.float32),
        np.random.default_rng(0).integers(0, 255, (128, 128, 3), np.uint8))
    assert feats.shape == (2, 512) and np.isfinite(feats).all()


def test_converter_raises_on_a_mis_shaped_or_unmapped_tensor(tmp_path):
    sd = torch_osnet.osnet_x0_25().state_dict()
    src = tmp_path / "osnet.pt"
    torch.save(sd, src)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert_reid_weights.convert(src, tmp_path / "a.npz", "x1_0")
    sd["conv1.extra.weight"] = torch.zeros(3)
    torch.save(sd, src)
    with pytest.raises(ValueError, match="unexpected: conv1.extra.weight"):
        convert_reid_weights.convert(src, tmp_path / "b.npz", "x0_25")
    assert not list(tmp_path.glob("*.npz"))


@pytest.mark.parametrize("variant", ["x0_25", "x1_0"])
def test_port_osnet_has_torchreids_state_dict_names(variant):
    want = getattr(torch_osnet, f"osnet_{variant}")().state_dict()
    got = getattr(osnet, f"osnet_{variant}")().state_dict()
    assert {k for k in want if k.startswith("classifier.")} == {
        "classifier.weight", "classifier.bias"}
    assert set(got) == {k for k in want if not k.startswith("classifier.")}
    assert all(got[k].shape == want[k].shape for k in got)


def test_demo_gifs_match_the_jax_tool(tmp_path, monkeypatch, capsys):
    """--synthetic --frames 12 bytetrack,sort: the same tracks, the same
    drawn frames pixel for pixel and the same GIF files (12 frames each
    and a comparison grid)."""
    from PIL import Image

    tracks, drawn = {"port": {}, "jax": {}}, {"port": [], "jax": []}
    for side, pkg, vis in (("port", motcpp_tpu_torch, port_vis),
                           ("jax", motcpp_tpu, jax_vis)):
        monkeypatch.setattr(pkg, "create_tracker",
                            recording(pkg.create_tracker, tracks[side]))
        save = vis.save_gif

        def recorded(frames, path, fps=10, save=save, side=side):
            drawn[side].append((Path(path).name, [np.array(f)
                                                  for f in frames]))
            save(frames, path, fps)

        monkeypatch.setattr(vis, "save_gif", recorded)
    argv = ["unused", "bytetrack,sort", "--synthetic", "--frames", "12",
            "--cpu"]
    assert generate_demo_gifs.main(
        [argv[0], str(tmp_path / "port")] + argv[1:]) == 0
    assert load_jax_script("generate_demo_gifs").main(
        [argv[0], str(tmp_path / "jax")] + argv[1:]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == [ln.replace("/jax/", "/port/") for ln in lines[3:]]
    for name in ("bytetrack", "sort"):
        assert len(tracks["port"][name]) == 12
        assert first_difference(tracks["port"][name],
                                tracks["jax"][name]) is None
    names = ["synthetic_pan_bytetrack.gif", "synthetic_pan_sort.gif",
             "synthetic_pan_comparison.gif"]
    assert [n for n, _ in drawn["port"]] == [n for n, _ in drawn["jax"]] \
        == names
    for (name, got), (_, want) in zip(drawn["port"], drawn["jax"]):
        assert len(got) == len(want) == 12
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), name
        port_gif, jax_gif = tmp_path / "port" / name, tmp_path / "jax" / name
        assert port_gif.read_bytes() == jax_gif.read_bytes()
        with Image.open(port_gif) as im:
            assert im.n_frames == 12
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        names)
