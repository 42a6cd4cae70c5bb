"""Port parity: the time-attribution tools of motcpp_tpu_torch
(``motcpp_tpu_torch/scripts/profile_osnet.py``, ``profile_stages.py``,
``ablate_cost.py``, ``microbench_select.py``) against the JAX package's
``scripts/`` of the same names, which are loaded from their files.

  * profile_osnet's pieces, chained in order, are the forwards they
    split (exactly, float32, osnet_x0_25, 64x32 crops, B=4); the bf16
    module forward (the embed of the live-ReID serving path) equals the
    JAX package's bf16 forward on its weights at per-crop cosine 0.9999,
    and at the port's seeded weights drifts from float32 no more than
    1.5 times as far as the JAX bf16 forward does; each OSBlock
    piece, module and fused, on the JAX weights carried across with
    ``state_dict_from_flax``, equals the JAX ``OSBlock`` apply at rtol
    1e-5 (of the output's largest magnitude); the counts of conv1 and
    of one OSBlock equal counts written out here;
  * profile_stages' stage functions equal the JAX script's, vmapped, on
    its inputs (matchings identical, floats at rtol 1e-6);
  * each ablation stub gives the JAX stub's outputs; the model module's
    attributes are the originals again after a run, also one that
    raises; a stub never called fails the run;
  * each script's ``main([... "--cpu"])`` runs at a tiny size and prints
    every row; microbench_select's cases are exact.
"""

import copy
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch at one thread)
from motcpp_tpu.appearance import osnet as jax_osnet
from motcpp_tpu.appearance.reid import _cast_variables
from motcpp_tpu_torch.appearance import osblock, osnet
from motcpp_tpu_torch.appearance.quant import fold_osnet
from motcpp_tpu_torch.utils.profiling import crop_cosine
from motcpp_tpu_torch.scripts import (
    ablate_cost,
    microbench_select,
    profile_osnet,
    profile_stages,
)

ROOT = Path(__file__).resolve().parent.parent
B, HW = 4, (64, 32)
PIECES = ("conv1", "maxpool", "conv2_0", "conv2_1", "conv2_2_0", "conv3_0",
          "conv3_1", "conv3_2_0", "conv4_0", "conv4_1", "conv5", "fc_0")


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def x0_25():
    """osnet_x0_25 with the JAX package's seeded weights on both sides:
    (JAX variables, port module, folded tree, packed blocks)."""
    variables = jax.device_get(jax_osnet.init_params(
        jax_osnet.osnet_x0_25(), HW, seed=0))
    sd = osnet.state_dict_from_flax(variables)
    model = osnet.infer_osnet(sd)
    model.load_state_dict(sd)
    model.eval()
    folded = fold_osnet(model)
    return variables, model, folded, osblock.pack_blocks(folded,
                                                         torch.float32)


def crops(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(B, *HW, 3)).astype(np.float32))


# ---------------------------------------------------------------------------
# profile_osnet
# ---------------------------------------------------------------------------


def test_fused_pieces_chained_are_forward_fused_exactly(x0_25):
    _, _, folded, packed = x0_25
    pieces = osblock.fused_pieces(folded, packed)
    assert tuple(name for name, _ in pieces) == PIECES
    x = crops()
    _, last = profile_osnet.chain_inputs(pieces, x)
    assert torch.equal(last, osblock.forward_fused(folded, x, packed))


def test_module_pieces_chained_are_the_module_forward_exactly(x0_25):
    _, model, _, _ = x0_25
    pieces = profile_osnet._model_pieces(model)
    assert tuple(name for name, _ in pieces) == PIECES
    x = crops(1)
    with torch.no_grad():
        _, last = profile_osnet.chain_inputs(pieces, x.permute(0, 3, 1, 2))
        assert torch.equal(last, model(x))


def jax_bf16_forward(variables, x):
    """The JAX package's OSNet forward in bf16, its weights and BN
    statistics cast by its reid module's rule."""
    out = jax_osnet.osnet_x0_25().apply(
        _cast_variables(variables, "bfloat16"),
        jnp.asarray(x).astype(jnp.bfloat16), train=False)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def port_bf16_forward(model, x):
    with torch.no_grad():
        return copy.deepcopy(model).to(torch.bfloat16)(
            torch.from_numpy(x).bfloat16()).float()


def test_bf16_module_forward_matches_jax_on_jax_weights(x0_25):
    """The live-ReID serving path embeds with the module forward in bf16:
    on the JAX package's weights carried across with
    ``state_dict_from_flax``, it gives the JAX bf16 forward's features
    (measured: per-crop cosine 0.99998 min)."""
    variables, model, _, _ = x0_25
    x = np.random.default_rng(5).normal(size=(8, *HW, 3)).astype(np.float32)
    cos = crop_cosine(port_bf16_forward(model, x),
                      jax_bf16_forward(variables, x))
    assert float(cos.min()) >= 0.9999


def test_bf16_module_forward_drifts_from_float32_no_more_than_jax():
    """At the port's seeded weights (``init_params``: BN statistics of a
    training pass, so features depend on the input), carried to the JAX
    package with ``convert_torch_state_dict``, bf16 rounding grows
    through depth in both forwards (13-14% of the features' norm here,
    per-crop cosine to float32 near 0.98): the port's drift from the
    float32 forward is at most 1.5 times the JAX bf16 forward's, and the
    two float32 forwards agree at 1e-4."""
    model = osnet.init_params(osnet.osnet_x0_25(), seed=0)
    variables = jax_osnet.convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    x = np.random.default_rng(0).normal(size=(8, *HW, 3)).astype(np.float32)
    want = np.asarray(jax_osnet.osnet_x0_25().apply(
        variables, jnp.asarray(x), train=False), np.float64)
    with torch.no_grad():
        got32 = model(torch.from_numpy(x)).double().numpy()
    np.testing.assert_allclose(got32, want, rtol=1e-4, atol=1e-4)

    def drift(a):
        return np.linalg.norm(a.double().numpy() - want) / np.linalg.norm(
            want)

    jax_drift = drift(jax_bf16_forward(variables, x))
    port_drift = drift(port_bf16_forward(model, x))
    assert 0 < jax_drift and port_drift <= 1.5 * jax_drift, (port_drift,
                                                             jax_drift)


@pytest.mark.parametrize("name", osblock.BLOCKS)
def test_each_osblock_piece_equals_the_jax_osblock(x0_25, name):
    """The module's block and the fused piece (the kernel's plain version
    on the CPU), on the block's input shape from the chain, against the
    JAX OSBlock's apply with the same variables."""
    variables, model, folded, packed = x0_25
    with torch.no_grad():
        io, _ = profile_osnet.chain_inputs(
            osblock.fused_pieces(folded, packed), crops(2))
    x = io[PIECES.index(name)][0].numpy()
    w = packed[name]
    block = jax_osnet.OSBlock(w.cout)
    want = np.asarray(block.apply(
        {c: variables[c][name] for c in ("params", "batch_stats")},
        jnp.asarray(x), train=False))
    stage, idx = name.split("_")
    with torch.no_grad():
        module = getattr(model, stage)[int(idx)](
            torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        fused = dict(osblock.fused_pieces(folded, packed))[name](
            torch.from_numpy(x))
    atol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(module.numpy(), want, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-5, atol=atol)


def test_counts_of_conv1_and_one_osblock_by_hand(x0_25):
    """conv1 of osnet_x0_25 (7x7/2, 3 -> 16) over 4 crops of 64x32, and
    its first OSBlock (16 -> 64, mid 16, gate hidden 1, a downsample) over
    the 16x8 maps, in float32."""
    _, _, folded, packed = x0_25
    f32 = torch.float32
    x = torch.zeros(B, 64, 32, 3)
    y = torch.zeros(B, 32, 16, 16)
    ops, nbytes = profile_osnet.piece_cost("conv1", x, y, folded, packed, f32)
    # 2 ops x 4 crops x 32*16 outputs x 16 channels x 7*7*3 taps
    assert ops == 2 * 4 * 512 * 16 * 147 == 9_633_792
    # input 4*64*32*3, output 4*32*16*16, kernel 7*7*3*16, bias 16; 4 bytes
    assert nbytes == (24_576 + 32_768 + 2_352 + 16) * 4 == 238_848
    x = torch.zeros(B, 16, 8, 16)
    y = torch.zeros(B, 16, 8, 64)
    ops, nbytes = profile_osnet.piece_cost("conv2_0", x, y, folded, packed,
                                           f32)
    # per pixel: conv1 16*16, ten lites (16*16 pointwise + 9*16 taps),
    # the gate's product 4*16, conv3 16*64, downsample 16*64
    macs_px = 256 + 10 * (256 + 144) + 64 + 1024 + 1024
    assert macs_px == 6368
    # plus per crop the gate's two fcs (16 -> 1 -> 16), four streams
    assert ops == 2 * 4 * (128 * macs_px + 4 * 2 * 16 * 1) == 6_521_856
    w = packed["conv2_0"]
    weights = w.mats.numel() * 4 + w.biases.numel() * 4
    assert nbytes == 4 * 128 * (16 + 64) * 4 + weights


# ---------------------------------------------------------------------------
# profile_stages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage_arrays():
    return profile_stages.stage_inputs(8, ["iou", "kf"])


def test_auction_stages_equal_the_jax_scripts(stage_arrays):
    from motcpp_tpu.ops.lap import solve_lap_masked as jax_lap

    cost, rm, cm = stage_arrays["lap"]
    torch_in = [torch.from_numpy(a) for a in (cost, rm, cm)]
    for impl, port in (("auction", profile_stages.auction_stage),
                       ("auction_pallas", profile_stages.pallas_stage)):
        fn = jax.vmap(lambda c, r, m, impl=impl: jax_lap(c, r, m, 0.9,
                                                         impl=impl))
        want = fn(jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm))
        got = port(*torch_in)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (got[0] >= 0).sum() > 0


def test_iou_and_kf_stages_equal_the_jax_scripts(stage_arrays):
    from motcpp_tpu.ops.iou import iou_batch
    from motcpp_tpu.ops.kalman.gaussian import kf_xyah

    b1, b2 = stage_arrays["iou"]
    want = jax.vmap(iou_batch)(jnp.asarray(b1), jnp.asarray(b2))
    got = profile_stages.iou_stage(torch.from_numpy(b1), torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    mean, cov, meas = stage_arrays["kf"]
    t = [torch.from_numpy(a) for a in (mean, cov, meas)]
    pred = jax.vmap(jax.vmap(kf_xyah.predict))(jnp.asarray(mean),
                                               jnp.asarray(cov))
    for g, w in zip(profile_stages.kf_predict_stage(*t[:2]), pred):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    upd = jax.vmap(jax.vmap(kf_xyah.update))(*(jnp.asarray(a)
                                               for a in (mean, cov, meas)))
    for g, w in zip(profile_stages.kf_update_stage(*t), upd):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# ablate_cost
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_stubs():
    return load_jax_script("ablate_cost").make_stubs(None)


def test_each_stub_gives_the_jax_stubs_outputs(jax_stubs):
    stubs = ablate_cost.make_stubs()
    assert set(stubs) == set(jax_stubs)
    rng = np.random.default_rng(0)
    S, K, N, R = 3, 6, 5, 4
    cost = rng.random((S, K, N)).astype(np.float32)
    rm, cm = rng.random((S, K)) < 0.7, rng.random((S, N)) < 0.7
    j, p = jax_stubs, {k: fn for k, (_, fn) in stubs.items()}
    T = torch.from_numpy

    def same(got, want):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    same(p["lap"](T(cost), T(rm), T(cm), 0.9),
         jax.vmap(lambda c, r, m: j["lap"][1](c, r, m, 0.9))(cost, rm, cm))
    a = rng.uniform(0, 100, (S, K, 4)).astype(np.float32)
    b = rng.uniform(0, 100, (S, N, 4)).astype(np.float32)
    same([p["iou"](T(a), T(b))], [j["iou"][1](jnp.asarray(a),
                                              jnp.asarray(b))])
    same([p["asso"]("iou", 640, 480)(T(a), T(b))],
         [j["asso"][1]("iou", 640, 480)(jnp.asarray(a), jnp.asarray(b))])
    x = rng.normal(size=(S, K, 7)).astype(np.float32)
    P = rng.normal(size=(S, K, 7, 7)).astype(np.float32)
    z = rng.normal(size=(S, K, 4)).astype(np.float32) * 1e6
    same(p["kf_predict"](T(x), T(P)),
         j["kf_predict"][1](jnp.asarray(x), jnp.asarray(P)))
    same(p["kf_update"](T(x), T(P), T(z)),
         j["kf_update"][1](jnp.asarray(x), jnp.asarray(P), jnp.asarray(z)))
    ring = rng.normal(size=(S, K, R, 5)).astype(np.float32)
    age = rng.integers(0, 9, (S, K, R)).astype(np.int32)
    same([p["ring"](T(ring), T(age), T(age[..., 0]), 3)],
         [jax.vmap(lambda r, o, g: j["ring"][1](r, o, g, 3))(ring, age,
                                                             age[..., 0])])
    # the observation update: the state's values unchanged, as the JAX
    # stub returns its inputs plus zero
    t2d = rng.integers(-1, N, (S, K)).astype(np.int32)
    dets = rng.normal(size=(S, N, 6)).astype(np.float32)
    v = {"x": T(x.copy()), "P": T(P.copy()), "hits": T(age[..., 0].copy())}
    p["apply"](v, T(t2d), T(dets), 5, 3, None)
    want = jax.vmap(lambda st, m, d: j["apply"][1](st, m, d, 5))(
        (x, P, age[..., 0]), t2d, dets)
    same([v["x"], v["P"], v["hits"]], want)


def tiny(tracker="ocsort", *ablate):
    return ["--cpu", "--tracker", tracker, "--streams", "2", "--frames", "3",
            "--repeats", "1", "--max-tracks", "8", "--max-dets", "4",
            "--objects", "3", "--ablate", *ablate]


def model_attrs(mod, stubs):
    return {a: getattr(mod, a) for a, _ in stubs.values() if hasattr(mod, a)}


def test_main_restores_the_model_module_and_counts_every_stub(capsys):
    mod = importlib.import_module("motcpp_tpu_torch.models.ocsort")
    stubs = ablate_cost.make_stubs()
    before = model_attrs(mod, stubs)
    report = ablate_cost.main(tiny("ocsort", *stubs))
    assert model_attrs(mod, stubs) == before
    # OC-SORT reaches all but iou_batch through its module
    assert report["skipped"] == ["iou"]
    assert set(report["calls"]) == set(stubs) - {"iou"}
    assert all(report["calls"].values())
    out = capsys.readouterr().out
    assert "# ocsort does not use iou_batch; skipping" in out
    for name in set(stubs) - {"iou"}:
        assert f"-> {name} share:" in out


def test_main_restores_the_model_module_when_a_run_raises(monkeypatch):
    mod = importlib.import_module("motcpp_tpu_torch.models.ocsort")
    stubs = ablate_cost.make_stubs()
    before = model_attrs(mod, stubs)
    real = ablate_cost.time_rollout

    def failing(tracker, args, label, dev):
        if label.startswith("-"):
            assert getattr(mod, "_k_previous_obs") is not before[
                "_k_previous_obs"]
            raise RuntimeError("a run failed")
        return real(tracker, args, label, dev)

    monkeypatch.setattr(ablate_cost, "time_rollout", failing)
    with pytest.raises(RuntimeError, match="a run failed"):
        ablate_cost.main(tiny("ocsort", "ring"))
    assert model_attrs(mod, stubs) == before


def test_a_stub_never_called_fails_the_run(monkeypatch):
    """A step that reached the stage without its module (bound when it
    was built) would leave the stub uncalled: the run fails."""
    monkeypatch.setattr(ablate_cost, "time_rollout", lambda *a: 1.0)
    with pytest.raises(RuntimeError, match="lap stub .* was never called"):
        ablate_cost.main(tiny("bytetrack", "lap"))


# ---------------------------------------------------------------------------
# the scripts' main --cpu
# ---------------------------------------------------------------------------


def test_profile_osnet_main_prints_every_row(capsys):
    report = profile_osnet.main(
        ["--cpu", "--batch", "2", "--hw", "64", "32", "--fused", "--roofline",
         "--repeats", "1"])
    out = capsys.readouterr().out
    for path in ("module", "fused"):
        rows = re.findall(rf"^  {path} +(\w+) \(", out, re.M)
        assert tuple(rows) == PIECES
        assert f"sum of the {path}" in out
    assert [r["name"] for r in report["fused_rows"]] == list(PIECES)
    for r in report["fused_rows"]:
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["ops"] > 0
        if r["name"] in osblock.BLOCKS:
            assert r["cosine"] > 0.9999 and r["max_abs_err"] <= 1e-6
    assert report["cosine_f32"][0] > 0.99999
    # bf16: each piece alone within rounding of float32 and of the other
    # path (the held bar on the card), however far the chain has drifted
    rows = report["pieces_precision"]
    assert [r["name"] for r in rows] == list(PIECES)
    for r in rows:
        assert min(r["module"], r["fused"], r["fused_module"]) >= 0.999, r
    assert set(report["cosine_to_f32"]) == {"module", "fused"}
    assert "each piece alone on the float32 chain's input" in out
    assert "roofline (counted from the shapes)" in out
    assert "speed of light" in out


def test_profile_stages_main_prints_every_row(capsys, monkeypatch):
    monkeypatch.setattr(profile_stages, "SOF_B", 2)  # 64 pairs take 20 s
    monkeypatch.setattr(profile_stages, "SOF_HW", (48, 64))
    report = profile_stages.main(
        ["--cpu", "--streams", "4", "--iters", "1", "--stages",
         *profile_stages.STAGES])
    out = capsys.readouterr().out
    labels = [label for label, _ in report["rows"]]
    assert labels == ["auction (plain) 4x(64x32)",
                      "auction (kernel) 4x(64x32)", "iou_batch 4x(64x32)", "sofjax CMC batch 2x(48x64)",
                      "KF xyah predict 4x64", "KF xyah update 4x64"]
    for label in labels:
        assert label in out
    assert report["pallas_equal"] is True
    assert "kernel = plain auction on these inputs: identical" in out


def test_ablate_cost_main_prints_every_row(capsys):
    report = ablate_cost.main(tiny("bytetrack", "lap", "iou", "kf_predict"))
    out = capsys.readouterr().out
    assert out.count("ms/frame-batch (spread") == 3
    assert "device split: not measured on the CPU" in out
    assert report["split"] is None
    assert "# bytetrack does not use xysr_predict; skipping" in out
    assert [r[0] for r in report["rows"]] == ["lap", "iou"]
    assert report["calls"]["lap"] > 0 and report["calls"]["iou"] > 0


def test_microbench_select_main_cases_are_exact(capsys):
    report = microbench_select.main(["--cpu", "--streams", "6", "--repeats",
                                     "1"])
    out = capsys.readouterr().out
    names = [r[0] for r in report["rows"]]
    assert names == ["take_per_row", "gather_rows", "take_slot",
                     "write_slot", "invert_matching", "rank_match",
                     "set_at_col"]
    assert all(r[3] for r in report["rows"])
    assert out.count("exact") == 7


def test_select_inputs_are_the_jax_draws_but_the_matching():
    """The seven cases' inputs are the JAX script's numpy draws, in its
    order; the matching keeps each stream's first det of a track."""
    S, K, N, R, D = 16, 6, 8, 5, 3
    got = microbench_select.case_inputs(S, K, N, R, D)
    rng = np.random.default_rng(0)
    for key, draw in (
            ("mat", lambda: rng.normal(size=(S, K, N)).astype(np.float32)),
            ("idx_kn", lambda: rng.integers(0, N, (S, K)).astype(np.int32)),
            ("tab", lambda: rng.normal(size=(S, N, D)).astype(np.float32)),
            ("idx_k_of_n", lambda: rng.integers(0, N, (S, K))),
            ("ring", lambda: rng.normal(size=(S, K, R, D))
             .astype(np.float32)),
            ("slot", lambda: rng.integers(0, R, (S, K))),
            ("new", lambda: rng.normal(size=(S, K, D)).astype(np.float32)),
            ("mask", lambda: rng.integers(0, 2, (S, K)).astype(bool))):
        np.testing.assert_array_equal(got[key], draw())
    d2t = np.where(rng.integers(0, 2, (S, N)).astype(bool),
                   rng.integers(0, K, (S, N)), -1)
    for s in range(S):
        seen = set()
        for n in range(N):
            if d2t[s, n] >= 0 and d2t[s, n] not in seen:
                seen.add(d2t[s, n])
                assert got["d2t"][s, n] == d2t[s, n]
            else:
                assert got["d2t"][s, n] == -1
    np.testing.assert_array_equal(got["rows"],
                                  rng.integers(0, 2, (S, K)).astype(bool))
    np.testing.assert_array_equal(got["cols"],
                                  rng.integers(0, 2, (S, N)).astype(bool))


def test_jax_scripts_have_the_ported_flags():
    """The port keeps each JAX script's flags (and adds --cpu where the
    JAX one lacks it); profile_osnet has no --dw-impl (the port has one
    depthwise schedule)."""
    for name, port in (("profile_osnet", profile_osnet),
                       ("profile_stages", profile_stages),
                       ("ablate_cost", ablate_cost),
                       ("microbench_select", microbench_select)):
        src = (ROOT / "scripts" / f"{name}.py").read_text()
        jax_flags = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', src))
        port_flags = {o for a in port.parser()._actions
                      for o in a.option_strings if o.startswith("--")}
        assert jax_flags - {"--dw-impl"} <= port_flags, name
        assert "--cpu" in port_flags
