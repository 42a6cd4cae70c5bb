"""Port parity: the int8 and dense-lite ReID of motcpp_tpu_torch
(``appearance/quant.py``, ``ops/int8.py``) and
``appearance/osnet.py::load_torch_weights`` against the JAX package on
the same numpy-seeded inputs, on the CPU, at osnet_x0_25 (feature_dim
64) with 64x32 crops. The weights follow the JAX package's initialisers
(lecun-normal kernels, zero biases, BN at scale 1, mean 0, variance 1;
drawn with numpy, not by Flax's ``init``, which alone takes 20 s here),
at which the JAX package holds int8 embeddings to cosine >= 0.995 of the
float ones (tests/test_appearance.py); both packages get them by name.
The JAX results are computed once for the module.

Tolerances, and why:
  * folded leaves, int8 kernels, weight scales, composed dense-lite
    kernels, the int8 product: equal (the same float32 operations, or
    integer sums);
  * calibration scales: rtol 1e-6 (the conv outputs' sums run in
    another order; XLA fuses the percentile's multiply-add);
  * forward_int8 and make_embed_fn_int8 with the JAX package's int8
    variables carried across, in float32: within 1e-2 of the largest
    feature and a per-crop cosine of at least 0.9999. XLA's depthwise
    conv sums in another order than the port's nine shifted multiply-adds
    (one ulp on about 40% of the first depthwise's outputs), and a value
    at a rounding boundary then quantizes one step apart at the next
    int8 conv; measured 2.3e-3 and 0.999995. With those flips removed (scales
    calibrated on the forward's own crops) the two are equal here;
  * forward_int8 in bfloat16 on both sides: 5e-3 of the largest feature
    and a cosine of at least 0.99999 (the test says why);
  * the dense-lite forward: 1e-4 (float32, as the folded forward);
  * the live rollouts: masks and ids equal, boxes within 1e-4 px against
    the JAX runner (the repo's live-ReID bar,
    tests/test_torch_live_reid.py), bit for bit between the port's own
    layouts (one device, two shards, the service).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motcpp_tpu.appearance import quant as jq
from motcpp_tpu.appearance.osnet import osnet_x0_25 as jax_osnet
from motcpp_tpu.models.botsort import BotSortConfig as JaxConfig
from motcpp_tpu.models.botsort import make_botsort as jax_make
from motcpp_tpu.parallel import MultiStreamRunner as JaxRunner
from motcpp_tpu_torch.appearance import osnet, quant, reid
from motcpp_tpu_torch.data import pack_valid_rows, synth_stream_dets
from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort
from motcpp_tpu_torch.ops import int8
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from motcpp_tpu_torch.serving import TrackingService

import torch_threads  # noqa: F401  (torch at one thread)

HW, D = (64, 32), 64
T, S, N = 3, 4, 8
CFG = dict(with_reid=True, emb_dim=D, max_tracks=16, max_dets=N)


def jax_initialised_variables(seed=0):
    """Flax variables of osnet_x0_25(feature_dim=D) as the JAX model's
    initialisers make them: kernels N(0, 1/fan_in), biases 0, BN scale 1,
    bias 0, mean 0, variance 1."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, p in osnet.osnet_x0_25(feature_dim=D).state_dict().items():
        if p.dim() >= 2:
            v = rng.normal(size=p.shape) / np.sqrt(p[0].numel())
        elif k.endswith("running_var") or (
                k.endswith(".weight") and (".bn." in k or k == "fc.1.weight")):
            v = np.ones(p.shape)
        else:
            v = np.zeros(p.shape)
        sd[k] = torch.from_numpy(np.asarray(v, np.float32).reshape(p.shape))
    return osnet.convert_torch_state_dict(sd)


@pytest.fixture(scope="module")
def nets():
    """JAX-initialised variables and the port's OSNet carrying them
    (``state_dict_from_flax``); seeded float crops and uint8 crops; the
    JAX package's quantize_osnet calibrated on the float crops, its
    calibration of the seeded default batch, and the int8 variables with
    those default scales (what make_embed_fn_int8 uses)."""
    variables = jax_initialised_variables()
    sd = osnet.state_dict_from_flax(variables)
    model = osnet.infer_osnet(sd)
    model.load_state_dict(sd)
    x = np.random.default_rng(0).normal(0, 1, (4, *HW, 3)).astype(np.float32)
    crops = np.random.default_rng(1).integers(0, 255, (6, *HW, 3)).astype(
        np.uint8)
    jmodel = jax_osnet(feature_dim=D)
    qvars_x = jax.device_get(jq.quantize_osnet(jmodel, variables,
                                               calib_crops=x))
    default = np.random.default_rng(0).normal(0.0, 1.0, quant.CALIB_SHAPE)
    act = jax.device_get(jax.jit(lambda c: jq.calibrate_osnet(
        qvars_x["folded"], c))(default.astype(np.float32)))
    return dict(jmodel=jmodel, variables=variables, model=model, x=x,
                crops=crops, qvars_x=qvars_x, qvars=dict(qvars_x, act=act))


@pytest.fixture(scope="module")
def port_q(nets):
    """The port's quantize_osnet of the same model, default calibration."""
    return quant.quantize_osnet(nets["model"])


def carried(nets):
    return quant.quantized_from_numpy(nets["qvars"])


def assert_int8_close(got, want):
    """Within 1e-2 of the largest feature, per-row cosine >= 0.9999 (see
    the module's note)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-2, rtol=0)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert (cos >= 0.9999).all(), cos


# ---------------------------------------------------------------------------
# weights: folding and int8
# ---------------------------------------------------------------------------

def test_folded_leaves_int8_kernels_and_scales_equal_jax(nets, port_q):
    """Every folded leaf, its int8 kernel and weight scale equal the JAX
    package's, to the bit; ``_quantize_weight`` of the JAX package's
    folded leaves gives them too."""
    want = nets["qvars_x"]
    assert sorted(port_q["folded"]) == sorted(want["folded"])
    assert sorted(port_q["q"]) == sorted(want["q"])
    for name, leaf in want["q"].items():
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(port_q["folded"][name][k].numpy(),
                                          want["folded"][name][k],
                                          err_msg=f"folded {name}/{k}")
        got = port_q["q"][name]
        assert got["kernel"].dtype == torch.int8
        for k in ("kernel", "wscale", "bias"):
            np.testing.assert_array_equal(got[k].numpy(), leaf[k],
                                          err_msg=f"q {name}/{k}")
        qk, ws = quant._quantize_weight(
            torch.from_numpy(np.array(want["folded"][name]["kernel"])))
        np.testing.assert_array_equal(qk.numpy(), leaf["kernel"])
        np.testing.assert_array_equal(ws.numpy(), leaf["wscale"])


@pytest.mark.parametrize("which", ["explicit", "default"])
def test_calibration_scales_match_jax(nets, port_q, which):
    """Every conv's (depthwise ones too) and the head's input scale, from
    explicit crops and from the seeded default batch
    (np.random.default_rng(0).normal(0, 1, (8, 256, 128, 3)))."""
    if which == "explicit":
        got = quant.calibrate_osnet(port_q["folded"],
                                    torch.from_numpy(nets["x"]))
        want = nets["qvars_x"]["act"]
    else:
        got, want = port_q["act"], nets["qvars"]["act"]
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        assert got[name].dtype == torch.float32 and got[name].dim() == 0
        np.testing.assert_allclose(got[name].numpy(), v, rtol=1e-6, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("p", [99.9, 50.0, 0.0, 100.0, 37.5])
def test_percentile_follows_jnp_percentile(p):
    """The float32 arithmetic of jnp.percentile's linear method, on a
    tensor with ties, at percentiles that fall between and on ranks."""
    a = np.random.default_rng(3).normal(size=(7, 33, 5)).astype(np.float32)
    a[0, :4] = a[1, :4]
    got = quant._percentile(torch.from_numpy(np.abs(a)), p)
    want = np.asarray(jnp.percentile(jnp.abs(jnp.asarray(a)), p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the int8 product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(5, 147, 64), (16, 512, 64), (17, 64, 64),
                                   (300, 64, 256), (1, 8, 8), (40, 152, 60)])
def test_int8_product_plain_version_is_exact(m, k, n):
    """The plain version (the CPU's route) equals numpy's integer product
    at the stem's K of 147, the head's M of 16 or fewer and unaligned
    widths, and launches nothing; so does the padded product against a
    padded weight."""
    rng = np.random.default_rng(m * k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
    before = int8.LAUNCHES
    got = int8.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        int8.int8_matmul_reference(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy(), want)
    wp = int8.padded_weight(torch.from_numpy(b))
    assert wp.shape[0] % 8 == 0 and wp.shape[1] % 8 == 0
    assert wp.stride() == (1, wp.shape[0])
    np.testing.assert_array_equal(
        int8.int8_matmul_padded(torch.from_numpy(a), wp, n).numpy(), want)
    assert int8.LAUNCHES == before


def test_int8_product_rejects_what_it_does_not_compute():
    a = torch.zeros((20, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 operands"):
        int8.int8_matmul(a.float(), torch.zeros((16, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        int8.int8_matmul(a, torch.zeros((8, 8), dtype=torch.int8))


def test_int8_conv_equals_the_float_conv_of_its_integers():
    """The stem's im2col (7x7, stride 2, pad 3; in chunks of the batch)
    and a 1x1 conv give the float32 conv of the same integers, exactly
    (every sum below 2^24)."""
    rng = np.random.default_rng(4)
    for shape, strides, padding in (((7, 7, 3, 16), (2, 2), 3),
                                    ((1, 1, 16, 24), (1, 1), 0),
                                    ((3, 3, 8, 8), (1, 1), 1)):
        kern = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        xq = torch.from_numpy(
            rng.integers(-127, 128, (3, 20, 12, shape[2])).astype(np.int8))
        want = quant._conv(xq.float(), kern.float(), torch.zeros(shape[-1]),
                           strides, padding)
        got = quant._int8_conv(xq, quant._weight_matrix(kern), shape, strides,
                               padding)
        assert got.dtype == torch.int32
        assert torch.equal(got.float(), want), shape
    saved = quant.IM2COL_BYTES
    quant.IM2COL_BYTES = 1  # one crop a chunk
    try:
        assert torch.equal(quant._int8_conv(xq, quant._weight_matrix(kern),
                                            shape, (1, 1), 1), got)
    finally:
        quant.IM2COL_BYTES = saved


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def test_qget_hook_routes_every_conv_and_the_head(nets, port_q):
    """With a hook that computes the float conv, every folded conv and the
    head go through it once (the gates' Dense pairs do not), and the
    forward equals the forward without a hook bit for bit."""
    folded = port_q["folded"]
    seen = []

    def qget(name, x, strides, padding, groups):
        seen.append(name)
        leaf = folded[name]
        if strides is None:
            return x @ leaf["kernel"].to(x.dtype) + leaf["bias"].to(x.dtype)
        return quant._conv(x, leaf["kernel"], leaf["bias"], strides, padding,
                           groups)

    x = torch.from_numpy(nets["x"])
    got = quant._forward_folded(folded, x, qget=qget)
    assert torch.equal(got, quant._forward_folded(folded, x))
    assert sorted(seen) == sorted(n for n in folded
                                  if not n.endswith(("/fc1", "/fc2")))


def test_forward_int8_matches_jax(nets):
    """The JAX package's int8 variables carried across: the port's int8
    forward of the same float crops equals JAX's within the module's
    int8 tolerance (default scales), and to the bit with the scales
    calibrated on those crops."""
    x = nets["x"]
    fwd = jax.jit(jq.forward_int8)
    got = quant.forward_int8(carried(nets), torch.from_numpy(x))
    want = np.asarray(fwd(nets["qvars"], x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_int8_close(got.numpy(), want)
    got = quant.forward_int8(quant.quantized_from_numpy(nets["qvars_x"]),
                             torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(fwd(nets["qvars_x"], x)))


@pytest.mark.parametrize("scales", ["default", "own"])
def test_forward_int8_in_bfloat16_matches_jax(nets, scales):
    """With bfloat16 activations (make_embed_fn_int8's default on the
    card) on both sides and the JAX package's int8 variables carried
    across, the port's int8 forward equals JAX's within 5e-3 of the
    largest feature and a per-crop cosine of at least 0.99999. Both
    enter in bf16 and turn float32 at the first channel gate, whose
    Dense kernels are float32. Measured equal here. A port that carried
    bf16 through every layer misses both bars (1.1e-2 and 0.99994 with
    the default scales); one quantization flip does not (2.3e-3 and
    0.999995 in float32)."""
    qvars = nets["qvars" if scales == "default" else "qvars_x"]
    x = nets["x"]
    want = np.asarray(jax.jit(lambda q, c: jq.forward_int8(
        q, c, act_dtype=jnp.bfloat16))(qvars, x), np.float64)
    got = quant.forward_int8(quant.quantized_from_numpy(qvars),
                             torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.double().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=5e-3, rtol=0)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert (cos >= 0.99999).all(), cos


def test_make_embed_fn_int8_matches_jax_and_the_float_embed(nets,
                                                            monkeypatch):
    """Unit-norm embeddings within cosine 0.995 of the port's float32
    embed (the JAX package's bar at this size); with the same int8
    variables on both sides, the JAX package's make_embed_fn_int8 within
    the int8 tolerance; the port's own calibration (scales within rtol
    1e-6 of JAX's) within the same."""
    crops = nets["crops"]
    monkeypatch.setattr(jq, "quantize_osnet",
                        lambda *a, **k: nets["qvars"])
    want = np.asarray(jax.jit(jq.make_embed_fn_int8(
        nets["jmodel"], nets["variables"]))(crops))
    monkeypatch.setattr(quant, "quantize_osnet",
                        lambda *a, **k: carried(nets))
    got = quant.make_embed_fn_int8(nets["model"], device="cpu")(crops)
    monkeypatch.undo()
    own = quant.make_embed_fn_int8(nets["model"], device="cpu")(crops)
    float_e = reid.make_embed_fn(nets["model"], device="cpu")(crops)
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, atol=1e-4)
    cos = (got * float_e).sum(1)
    assert bool((cos >= 0.995).all()), cos
    assert_int8_close(got.numpy(), want)
    assert_int8_close(own.numpy(), want)


def test_make_embed_fn_int8_takes_its_options(nets, port_q, monkeypatch):
    """norm, explicit calibration crops and a bfloat16 activation dtype
    are passed on; a CUDA device that is not there raises."""
    calibs, seen = [], []
    monkeypatch.setattr(quant, "quantize_osnet", lambda m, calib_crops=None: (
        calibs.append(calib_crops) or port_q))
    forward = quant.forward_int8
    monkeypatch.setattr(quant, "forward_int8", lambda qv, x, adt: (
        seen.append((x, adt)) or forward(qv, x, adt)))
    crops = nets["crops"][:2]
    calib = np.zeros((1, *HW, 3), np.float32)
    e = quant.make_embed_fn_int8(nets["model"], norm=((0, 0, 0), (1, 1, 1)),
                                 calib_crops=calib, act_dtype="bfloat16",
                                 device="cpu")(crops)
    assert e.dtype == torch.float32 and e.shape == (2, D)
    (x, adt), = seen
    assert calibs == [calib] and adt == torch.bfloat16
    want = torch.from_numpy(crops[..., ::-1].astype(np.float32) / 255.0)
    assert torch.equal(x, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quant.make_embed_fn_int8(nets["model"])


def test_compose_lite_dense_matches_jax_leaf_by_leaf(nets, port_q):
    want = jq.compose_lite_dense(nets["qvars"]["folded"])
    got = quant.compose_lite_dense(port_q["folded"])
    assert sorted(got) == sorted(want)
    assert any(name.endswith("conv2a") for name in got)
    for name, leaf in want.items():
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][k].numpy(),
                                          np.asarray(leaf[k]),
                                          err_msg=f"{name}/{k}")


def test_forward_folded_dense_matches_jax_and_the_folded_forward(nets,
                                                                  port_q):
    x = nets["x"]
    composed = jq.compose_lite_dense(nets["qvars"]["folded"])
    want = np.asarray(jax.jit(jq._forward_folded_dense)(composed, x))
    got = quant._forward_folded_dense(
        quant.compose_lite_dense(port_q["folded"]), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), quant.forward_folded_f32(port_q["folded"],
                                              torch.from_numpy(x)).numpy(),
        atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# live BoT-SORT with the int8 embed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(nets):
    """A seeded scene of T frames of S streams (valid rows first, as the
    service lays them out) and crops; the port's int8 embed and JAX's,
    on the same int8 variables."""
    rng = np.random.default_rng(5)
    dets, masks, _ = pack_valid_rows(*synth_stream_dets(rng, T, S, N,
                                                        n_obj=3))
    crops = rng.integers(0, 255, (T, S, N, *HW, 3)).astype(np.uint8)
    saved = quant.quantize_osnet
    quant.quantize_osnet = lambda *a, **k: carried(nets)
    try:
        embed = quant.make_embed_fn_int8(nets["model"], device="cpu")
    finally:
        quant.quantize_osnet = saved
    saved = jq.quantize_osnet
    jq.quantize_osnet = lambda *a, **k: nets["qvars"]
    try:
        jembed = jq.make_embed_fn_int8(nets["jmodel"], nets["variables"])
    finally:
        jq.quantize_osnet = saved
    return dets, masks, crops, embed, jembed


def port_run(scene, **kw):
    dets, masks, crops, embed, _ = scene
    init, step = make_botsort(BotSortConfig(**CFG), device="cpu")
    return MultiStreamRunner(init, step, S, embed_fn=embed, **kw).run(
        dets, masks, embs=crops)


def test_live_int8_rollout_matches_the_jax_runner(scene):
    """BoT-SORT fed the int8 embed through the runner at a cadence of 2
    emits what the JAX runner emits with the JAX package's int8 embed;
    sharded over two devices it emits what one device does, bit for bit
    (and every frame too)."""
    dets, masks, crops, _, jembed = scene
    for kw in ({"emb_cadence": 2}, {}):
        go, gm = port_run(scene, device="cpu", **kw)
        so, sm = port_run(scene, devices=["cpu"] * 2, **kw)
        assert torch.equal(sm, gm) and torch.equal(so, go)
        assert int(gm.sum()) > 0
    go, gm = port_run(scene, device="cpu", emb_cadence=2)
    init, step = jax_make(JaxConfig(**CFG))
    wo, wm = (np.asarray(a) for a in JaxRunner(
        init, step, S, devices=jax.devices()[:1], embed_fn=jembed,
        emb_cadence=2).run(jnp.asarray(dets), jnp.asarray(masks),
                           embs=jnp.asarray(crops)))
    np.testing.assert_array_equal(gm.numpy(), wm)
    np.testing.assert_array_equal(go[..., 4].numpy()[wm], wo[..., 4][wm])
    np.testing.assert_allclose(go.numpy()[wm], wo[wm], atol=1e-4, rtol=0)


def test_live_int8_service_equals_the_runner(scene):
    """TrackingService with the int8 embed, every stream's valid rows and
    crops submitted each tick, emits the runner's rows bit for bit."""
    dets, masks, crops, embed, _ = scene
    want_o, want_m = port_run(scene, device="cpu", emb_cadence=2)
    svc = TrackingService.from_tracker(
        "botsort", S, max_dets=N, emb_dim=D, device="cpu", crop_hw=HW,
        embed_fn=embed, emb_cadence=2,
        tracker_kw=dict(with_reid=True, max_tracks=16))
    hs = [svc.attach() for _ in range(S)]
    for t in range(T):
        for s, h in enumerate(hs):
            n = int(masks[t, s].sum())
            svc.submit(h, dets[t, s, :n], crops=crops[t, s, :n])
        b = svc.step()
        np.testing.assert_array_equal(b.out_masks, want_m[t].numpy())
        np.testing.assert_array_equal(b.outs[b.out_masks],
                                      want_o[t][want_m[t]].numpy())
    assert int(want_m.sum()) > 0


# ---------------------------------------------------------------------------
# torchreid checkpoints
# ---------------------------------------------------------------------------

def test_load_torch_weights_round_trip_and_mismatches(nets, tmp_path):
    """A torchreid-layout checkpoint (wrapped in ``state_dict``, with
    DataParallel's ``module.`` prefix and a training classifier) loads
    into a fresh model as it was saved; a missing or extra key or a
    mis-shaped tensor raises ValueError naming it."""
    model = nets["model"]
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.classifier.weight"] = torch.zeros((10, D))
    path = tmp_path / "osnet.pth"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    fresh = osnet.osnet_x0_25(feature_dim=D)
    assert osnet.load_torch_weights(fresh, path) is fresh
    x = torch.from_numpy(nets["x"][:2])
    with torch.no_grad():
        assert torch.equal(fresh(x), model(x))
    cases = {
        "missing: conv5.bn.bias": lambda d: d.pop("conv5.bn.bias"),
        "unexpected: extra.weight": lambda d: d.__setitem__(
            "extra.weight", torch.zeros(3)),
        "shape mismatch at fc.0.weight": lambda d: d.__setitem__(
            "fc.0.weight", torch.zeros((D + 1, 128))),
    }
    for message, edit in cases.items():
        bad = dict(model.state_dict())
        edit(bad)
        p = tmp_path / "bad.pt"
        torch.save(bad, p)
        with pytest.raises(ValueError, match=message):
            osnet.load_torch_weights(osnet.osnet_x0_25(feature_dim=D), p)
    with pytest.raises(ValueError, match="shape mismatch"):
        osnet.load_torch_weights(osnet.osnet_x0_5(feature_dim=D), path)
