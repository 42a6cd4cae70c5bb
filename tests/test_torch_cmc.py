"""Port parity: the camera-motion estimators of motcpp_tpu_torch (the host
SOF, the plain-torch sparse-flow estimator and its antialiased resize,
``create_cmc``) against the JAX package's on the frames of
``data/synthetic.py::camera_pan_scene``, and the ``tests/golden_cmc``
rows of BoT-SORT through the port, byte for byte.

The host SOF runs OpenCV on both sides and must give the same warps.
The plain-torch estimator is compared at a stated tolerance: XLA
accumulates the resize's and the Lucas-Kanade sums in another order, so
the downscaled frames differ by an ulp of their 0-255 values and the
warps by about 2e-5.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.data.synthetic import camera_pan_scene
from motcpp_tpu.motion import cmc as jcmc
from motcpp_tpu_torch import create_tracker
from motcpp_tpu_torch.motion import cmc

import torch_threads  # noqa: F401  (torch at one thread)

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def pan():
    """Grayscale frames of the pan scene (240x320, 3 px and 1 px of pan
    a frame) and their JAX downscales to the SOFJax size."""
    frames, _, _ = camera_pan_scene(n_frames=6)
    grays = [cmc._to_gray(f) for f in frames]
    small = [np.asarray(jax.image.resize(jnp.asarray(g), (60, 80), "linear"))
             for g in grays]
    return frames, grays, small


@pytest.mark.parametrize("out_hw", [(60, 80), (36, 48), (240, 80), (300, 400)])
def test_resize_matches_jax_image_resize(pan, out_hw):
    """Downscales (antialiased), an unchanged axis and an upscale."""
    g = pan[1][0]
    got = cmc.resize_linear(torch.from_numpy(g), out_hw).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(g), out_hw, "linear"))
    assert got.shape == want.shape
    # the same weights; XLA's matrix products accumulate in another
    # order (up to 1e-5 of a value when upscaling)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # and not the non-antialiased resize, which differs by whole levels
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(g)[None, None], size=out_hw, mode="bilinear",
        align_corners=False)[0, 0].numpy()
    if out_hw[0] < 240:
        assert np.abs(plain - want).max() > 1.0


def test_sof_jax_batch_matches_jax(pan):
    """Five consecutive pairs as five streams, on the same downscaled
    frames."""
    small = np.stack(pan[2])
    got, ok = cmc.sof_jax_batch(torch.from_numpy(small[:-1]),
                                torch.from_numpy(small[1:]))
    want, jok = jcmc.sof_jax_batch(jnp.asarray(small[:-1]),
                                   jnp.asarray(small[1:]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert bool(ok.all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # the warp is the pan: -3/4 px and -1/4 px at a quarter scale
    np.testing.assert_allclose(got.numpy()[:, :, 2].mean(0), [-0.75, -0.25],
                               atol=0.05)


def test_sof_jax_class_matches_jax(pan):
    """SOFJax over the full frames: identity first, then each pair's
    warp with the translation rescaled by the achieved scales."""
    est, jest = cmc.SOFJax(device="cpu"), jcmc.SOFJax()
    for img in pan[0]:
        got, want = est.apply(img), jest.apply(img)
        assert got.shape == (2, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 2], [-3.0, -1.0], atol=0.2)
    est.reset()
    np.testing.assert_array_equal(est.apply(pan[0][1]), cmc.IDENTITY)


def test_host_sof_matches_jax_sof(pan):
    pytest.importorskip("cv2")
    import cv2

    est, jest = cmc.SOF(scale=0.15, device="cpu"), jcmc.SOF(scale=0.15)
    for img in pan[0]:
        cv2.setRNGSeed(0)
        got = est.apply(img)
        cv2.setRNGSeed(0)
        np.testing.assert_array_equal(got, jest.apply(img))
    assert abs(got[0, 2] + 3.0) < 0.5


def test_create_cmc_accepts_and_rejects_as_the_jax_package():
    assert cmc.create_cmc("none") is None and cmc.create_cmc("") is None
    assert isinstance(cmc.create_cmc("ecc"), cmc.ECC)
    assert isinstance(cmc.create_cmc("sof", device="cpu"), cmc.SOF)
    for method, prefer in (("sof_jax", False), ("sof", True), ("bogus", True)):
        est = cmc.create_cmc(method, prefer_jax=prefer, device="cpu")
        assert isinstance(est, cmc.SOFJax)
        assert type(jcmc.create_cmc(method, prefer_jax=prefer)).__name__ == (
            "SOFJax")
    for method, prefer in (("ecc_jax", False), ("ecc", True)):
        est = cmc.create_cmc(method, prefer_jax=prefer, device="cpu")
        assert isinstance(est, cmc.ECCJax) and est.device.type == "cpu"
        assert type(jcmc.create_cmc(method, prefer_jax=prefer)).__name__ == (
            "ECCJax")
    with pytest.raises(ValueError, match="Unknown cmc method"):
        cmc.create_cmc("bogus")


def golden_cmc_lines(tracker, **kwargs):
    """MOT rows of ``tracker`` through the port over the pan scene with
    its dropouts, as scripts/regen_golden_cmc.py writes them."""
    sys.path.insert(0, str(HERE.parent / "scripts"))
    from motcpp_tpu_torch.data import convert_to_mot_format
    from regen_golden_cmc import DROPOUTS

    try:
        import cv2

        cv2.setRNGSeed(0)
    except ImportError:
        pass
    frames, dets_all, embs_all = camera_pan_scene(n_frames=30,
                                                  dropout_frames=DROPOUTS)
    tr = create_tracker(tracker, max_dets=16, max_tracks=32, device="cpu",
                        **kwargs)
    lines = []
    for t, (img, dets, embs) in enumerate(zip(frames, dets_all, embs_all)):
        for row in convert_to_mot_format(tr.update(dets, img, embs), t + 1):
            lines.append(",".join([f"{int(v)}" for v in row[:6]]
                                  + [f"{row[6]:.6f}", "-1", "-1", "-1"]))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("name,method,needs_cv2", [
    ("botsort_ecc", "ecc", True), ("botsort_sofjax", "sof_jax", False)])
def test_botsort_golden_cmc_rows(name, method, needs_cv2):
    """tests/golden_cmc/botsort_{ecc,sofjax}.txt through the port's
    BoT-SORT and its estimators."""
    if needs_cv2:
        pytest.importorskip("cv2")
    got = golden_cmc_lines("botsort", cmc_method=method)
    assert got == (HERE / "golden_cmc" / f"{name}.txt").read_text()
