"""Port parity: the appearance layer of motcpp_tpu_torch (OSNet, BN
folding, the OSBlock's plain version and the fused forward, crops, the
ReID backend and budgeted embedding) against the JAX package on the
same numpy-seeded inputs, on the CPU.

Tolerances: OSNet forward and the OSBlock paths 1e-4 (atol and rtol;
float32, summation order differs), folded weights 1e-6, crops 1e-5. The
JAX package's OSBlock kernel runs in Pallas interpret mode.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.appearance import osblock_pallas as jax_osblock
from motcpp_tpu.appearance import reid as jax_reid
from motcpp_tpu.appearance.osnet import init_params as jax_init
from motcpp_tpu.appearance.osnet import osnet_x0_25 as jax_osnet
from motcpp_tpu.appearance.quant import fold_osnet as jax_fold
from motcpp_tpu.appearance.quant import forward_folded_f32 as jax_folded_fwd
from motcpp_tpu_torch.appearance import osblock, osnet, quant, reid

import torch_threads  # noqa: F401  (torch at one thread)

HERE = Path(__file__).resolve().parent
FIXTURE = HERE / "fixtures" / "osnet_x0_25_converted.npz"
HW = (32, 16)


@pytest.fixture(scope="module")
def nets():
    """Flax x0_25 variables and the port's OSNet carrying them."""
    jmodel = jax_osnet(feature_dim=64)
    variables = jax.device_get(jax_init(jmodel, HW, seed=0))
    sd = osnet.state_dict_from_flax(variables)
    model = osnet.infer_osnet(sd)
    model.load_state_dict(sd)
    return jmodel, variables, model


def x_nhwc(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_state_dict_from_flax_forward_matches_flax(nets):
    jmodel, variables, model = nets
    x = x_nhwc(0, (3, *HW, 3))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_state_dict_from_flax_raises_on_missing_and_extra(nets):
    _, variables, _ = nets
    block = {k: v for k, v in variables["params"]["conv2_0"].items()
             if k != "conv2a"}
    params = dict(variables["params"], conv2_0=block)
    with pytest.raises(ValueError, match="missing: conv2.0.conv2a.bn.bias"):
        osnet.state_dict_from_flax({**variables, "params": params})
    params = dict(variables["params"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="unexpected: extra.weight"):
        osnet.state_dict_from_flax({**variables, "params": params})


@pytest.mark.parametrize("variant,channels", [
    ("x1_0", (64, 256, 384, 512)), ("x0_75", (48, 192, 288, 384)),
    ("x0_5", (32, 128, 192, 256)), ("x0_25", (16, 64, 96, 128))])
def test_variants_and_infer_osnet(variant, channels):
    model = getattr(osnet, f"osnet_{variant}")()
    assert model.channels == channels and model.feature_dim == 512
    again = osnet.infer_osnet(model.state_dict())
    assert again.channels == channels


def test_load_weights_auto_npz_and_pt_agree(tmp_path):
    from_npz = osnet.load_weights_auto(FIXTURE)
    assert from_npz.channels == (16, 64, 96, 128)
    pt = tmp_path / "osnet.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               from_npz.state_dict().items()}}, pt)
    from_pt = osnet.load_weights_auto(str(pt))
    x = torch.from_numpy(x_nhwc(1, (2, *HW, 3)))
    with torch.no_grad():
        assert torch.equal(from_npz(x), from_pt(x))
    with pytest.raises(ValueError, match="unrecognized"):
        osnet.load_weights_auto(tmp_path / "w.onnx")


def test_fold_osnet_matches_jax(nets):
    _, variables, model = nets
    want = jax_fold(variables)
    got = quant.fold_osnet(model)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(got[name][k].numpy(),
                                       np.asarray(leaf[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{name}/{k}")


def test_forward_folded_matches_jax(nets):
    _, variables, model = nets
    x = x_nhwc(2, (3, *HW, 3))
    want = np.asarray(jax_folded_fwd(jax_fold(variables), jnp.asarray(x)))
    got = quant.forward_folded_f32(quant.fold_osnet(model), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,cin,hw", [("conv2_0", 16, (8, 4)),
                                         ("conv2_1", 64, (8, 4)),
                                         ("conv3_0", 64, (5, 3))])
def test_osblock_plain_version_matches_pallas_kernel(nets, name, cin, hw):
    """With (conv2_0, conv3_0) and without (conv2_1) downsample; the
    TPU kernel in interpret mode, the port's plain version and
    osblock_fused's CPU path on the same input."""
    _, variables, model = nets
    jf = jax_fold(variables)
    tree = quant.fold_osnet(model)
    feats = tree[f"{name}/conv3"]["kernel"].shape[-1]
    x = np.maximum(x_nhwc(3, (2, *hw, cin)), 0)
    want = np.asarray(jax_osblock.osblock_fused(
        jf, name, jnp.asarray(x), feats, batch_tile=2, interpret=True))
    got = osblock.osblock_reference(tree, name, torch.from_numpy(x), feats)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    w = osblock.block_weights(tree, name, torch.float32)
    assert (w.cin, w.cout, w.has_ds) == (cin, feats, cin != feats)
    assert torch.equal(osblock.osblock_fused(w, torch.from_numpy(x)), got)


def test_forward_fused_matches_pallas_forward(nets):
    _, variables, model = nets
    x = x_nhwc(4, (2, *HW, 3))
    want = np.asarray(jax_osblock.forward_fused(
        jax_fold(variables), jnp.asarray(x),
        tiles={"conv2": 2, "conv3": 2, "conv4": 2}, interpret=True))
    got = osblock.forward_fused(quant.fold_osnet(model), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_osblock_fused_rejects_other_devices(nets):
    tree = quant.fold_osnet(nets[2])
    w = osblock.block_weights(tree, "conv2_1", torch.float32)
    with pytest.raises(ValueError, match="no OSBlock kernel for device meta"):
        osblock.osblock_fused(w, torch.zeros((1, 2, 2, 64), device="meta"))


@pytest.mark.parametrize("name", ["osnet_x1_0_market", "resnet50_vehicleid",
                                  "lmbn_n_cuhk03", "hacnn_market",
                                  "clip_market1501", ""])
def test_input_shape_and_normalization_heuristics(name):
    assert reid.determine_input_shape(name) == jax_reid.determine_input_shape(name)
    assert (reid.determine_normalization(name)
            == jax_reid.determine_normalization(name))


def test_extract_crops_matches_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (90, 70, 3)).astype(np.uint8)
    boxes = np.asarray([[10.5, 4.25, 50.5, 80.0], [-20, -20, 90, 120],
                        [30.0, 30.0, 30.4, 30.2], [60.7, 2.5, 69.5, 89.5]],
                       np.float32)
    norm = (reid.IMAGENET_MEAN, reid.IMAGENET_STD)
    want = np.asarray(jax_reid.extract_crops(jnp.asarray(img),
                                             jnp.asarray(boxes), HW, norm))
    got = reid.extract_crops(torch.from_numpy(img), torch.from_numpy(boxes),
                             HW, norm)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_embed_fns_match_jax(nets):
    """make_embed_fn (plain, folded and fused) against the JAX package's
    embed functions on the same uint8 crops, three of them (no batch
    tile on the port's side)."""
    jmodel, variables, model = nets
    crops = np.random.default_rng(6).integers(0, 255, (3, *HW, 3)).astype(np.uint8)
    want = np.asarray(jax_reid.make_embed_fn(jmodel, variables, folded=True)(
        jnp.asarray(crops)))
    for kw in ({}, {"folded": True}, {"fused": True}):
        got = reid.make_embed_fn(model, device="cpu", **kw)(torch.from_numpy(crops))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=str(kw))
    with pytest.raises(ValueError, match="compute_dtype"):
        reid.make_embed_fn(model, compute_dtype="float16", device="cpu")


def test_bf16_embeddings_agree_with_float32(nets):
    crops = torch.from_numpy(np.random.default_rng(7).integers(
        0, 255, (4, *HW, 3)).astype(np.uint8))
    ref = reid.make_embed_fn(nets[2], fused=True, device="cpu")(crops)
    got = reid.make_embed_fn(nets[2], compute_dtype="bfloat16", fused=True,
                             device="cpu")(crops)
    assert float((ref * got).sum(1).min()) >= 0.995


def test_embed_valid_crops_budget_matches_jax(nets):
    jmodel, variables, model = nets
    rng = np.random.default_rng(8)
    S, N, budget = 3, 4, 5
    crops = rng.integers(0, 255, (S, N, *HW, 3)).astype(np.uint8)
    dets = rng.uniform(0, 1, (S, N, 6)).astype(np.float32)
    masks = rng.random((S, N)) < 0.7
    want = np.asarray(jax_reid.embed_valid_crops(
        jax_reid.make_embed_fn(jmodel, variables, folded=True),
        jnp.asarray(crops), jnp.asarray(dets), jnp.asarray(masks),
        budget=budget))
    got = reid.embed_valid_crops(
        reid.make_embed_fn(model, folded=True, device="cpu"),
        torch.from_numpy(crops), torch.from_numpy(dets),
        torch.from_numpy(masks), budget=budget).numpy()
    chosen = np.abs(want).sum(-1) > 0
    assert chosen.sum() == min(budget, masks.sum())
    np.testing.assert_array_equal(np.abs(got).sum(-1) > 0, chosen)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="budget"):
        reid.embed_valid_crops(None, torch.from_numpy(crops),
                               torch.from_numpy(dets),
                               torch.from_numpy(masks), budget=0)


def test_reid_backend_reproduces_the_forward_fingerprint():
    """The committed converted checkpoint through the port's backend
    gives the fingerprint the JAX package pins
    (tests/test_reid_fixture.py::test_forward_fingerprint_pinned)."""
    want = json.loads((HERE / "golden_reid" / "forward_fingerprint.json")
                      .read_text())
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (256, 320, 3)).astype(np.uint8)
    boxes = np.asarray([[10, 10, 120, 240], [150, 20, 300, 250],
                        [0, 0, 320, 256]], np.float32)
    backend = reid.ReIDBackend(weights=str(FIXTURE), device="cpu")
    feats = backend.get_features(boxes, img)
    assert feats.shape == (3, want["feature_dim"])
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), want["norms"],
                               atol=1e-3)
    cos = [float(feats[i] @ feats[j]) for i in range(3) for j in range(i + 1, 3)]
    np.testing.assert_allclose(cos, want["pairwise_cos"], atol=1e-3)
    np.testing.assert_allclose(feats[0, :8], want["first8"], atol=1e-3)
    assert backend.get_features(np.zeros((0, 4)), img).shape == (0, 512)
    jcrops = jax_reid.ReIDBackend(weights=str(FIXTURE)).get_crops(boxes, img)
    np.testing.assert_allclose(backend.get_crops(boxes, img), jcrops,
                               atol=1e-5, rtol=0)
