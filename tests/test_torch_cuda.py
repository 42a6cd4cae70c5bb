"""The CUDA kernels of motcpp_tpu_torch against their plain PyTorch
versions, and the tracker paths through them against the paths through
the plain versions, on a CUDA device. They skip where there is none.

This file imports no JAX, so it also runs where JAX is not installed,
without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from auction_cases import EDGE_CASES, edge_case
from motcpp_tpu_torch.data import (
    pack_valid_rows,
    pan_frames,
    pan_texture,
    synth_stream_dets,
)
from motcpp_tpu_torch.models.bytetrack import ByteTrackConfig, make_bytetrack
from motcpp_tpu_torch.ops import auction, auction_cuda
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
from motcpp_tpu_torch.utils.profiling import same_bits

import torch_threads  # noqa: F401  (torch at one thread)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def problems(seed, P, K, N):
    """Random masks and thresholds, +inf and negative costs, an empty
    problem, and a quarter of dense uniform near-tie problems."""
    rng = np.random.default_rng(seed)
    cost = rng.random((P, K, N)).astype(np.float32)
    cost[rng.random((P, K, N)) < 0.05] = np.inf
    cost[P // 2:P // 2 + 2] -= 1.0
    rm = rng.random((P, K)) < 0.7
    cm = rng.random((P, N)) < 0.7
    rm[1] = False
    th = rng.choice(np.float32([0.5, 0.7, 0.9]), P)
    th[:P // 4] = 0.9
    return [torch.from_numpy(a) for a in (cost, rm, cm, th)]


def assert_kernel_equals_plain(cuda, args):
    want = auction.solve_lap_auction(*args)
    before = auction_cuda.LAUNCHES
    got = auction_cuda.solve(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert auction_cuda.LAUNCHES == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("shape", [(512, 64, 32), (64, 128, 64),
                                   (64, 128, 128), (32, 256, 128), (3, 1, 1),
                                   (256, 64, 16), (4096, 64, 32),
                                   (2, 96, 192), (2, 192, 96),
                                   (64, 96, 192), (8, 128, 256),
                                   (4096, 32, 160), (2, 188, 254),
                                   (2, 256, 184), (2, 186, 256)])
def test_auction_kernel_matches_plain_version(cuda, shape):
    """Few problems get several warps each, a full wave one warp each
    (4096 at K=64, N=32, as on ByteTrack's main path); the ablation
    scoreboard's one-stream solves, detections by tracks (96, 192) and
    tracks by detections (192, 96), and columns past 128, where a lane
    holds eight, up to the largest tiles the wrapper takes (the most
    K * N, 188 x 254, the most N at K=256 and the most K at N=256)."""
    assert_kernel_equals_plain(cuda, problems(sum(shape), *shape))


@pytest.mark.parametrize("first,second", [
    ((400, 97, 63), (400, 96, 192)), ((1200, 41, 71), (1200, 40, 200)),
    ((2, 255, 31), (2, 256, 160))])
def test_auction_kernel_keeps_each_shapes_launch_shape(cuda, first, second):
    """The launch shape found for (K + 1, N - 129) is not taken for
    (K, N > 128) solved after it in the same process, nor written past the
    cache at K=256; the second's P reaches its one-warp layout."""
    for shape in (first, second):
        assert_kernel_equals_plain(cuda, problems(sum(shape), *shape))


def test_auction_library_agrees_on_the_tiles_it_takes(cuda):
    """The wrapper's count of a problem's shared memory is the kernel
    library's, and the library itself refuses a tile past the CTA's."""
    lib = auction_cuda._load()
    for K in (1, 8, 31, 64, 96, 128, 188, 192, 256):
        for N in (1, 16, 32, 33, 64, 65, 128, 129, 192, 254, 256):
            want = auction_cuda.smem_bytes(K, N)
            assert lib.auction_smem_bytes(K, N) == want
    assert auction_cuda.smem_bytes(189, 254) > auction_cuda.MAX_SMEM
    invalid_value = 1  # cudaErrorInvalidValue
    for K, N in ((189, 254), (256, 185), (257, 8), (8, 257)):
        assert lib.auction_solve(None, None, None, None, 1, K, N, 0.0, 1,
                                 None, None, None) == invalid_value


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_auction_kernel_matches_plain_version_on_edge_classes(cuda, case):
    """The classes of tests/auction_cases.py, on which the plain auction
    matches the JAX Pallas kernel (tests/test_torch_lap.py); round_cap
    also shows that col2row read from the owners equals the plain
    version's rebuild after MAX_ROUNDS."""
    assert_kernel_equals_plain(
        cuda, [torch.from_numpy(a) for a in edge_case(case)])


def test_bytetrack_rollout_kernel_path_equals_plain_path(cuda):
    S, K, N, T = 64, 64, 32, 30
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N)
    outs = {}
    for lap in ("auction_pallas", "auction"):
        init, step = make_bytetrack(
            ByteTrackConfig(max_tracks=K, max_dets=N, lap_impl=lap),
            device=cuda)
        before = auction_cuda.LAUNCHES
        outs[lap] = MultiStreamRunner(init, step, S, device=cuda).run(
            dets, masks)
        launched = auction_cuda.LAUNCHES - before
        assert launched == (2 * T if lap == "auction_pallas" else 0)
    (ko, km), (po, pm) = outs["auction_pallas"], outs["auction"]
    assert int(km.sum()) > 0
    assert torch.equal(km, pm)
    assert torch.equal(ko[km], po[pm])


def rollout_kernel_path_equals_plain_path(cuda, make, launches_per_frame,
                                          S=64, K=64, N=32, T=30):
    """A tracker's rollout with the auction kernel and with the plain
    auction: the kernel launches launches_per_frame times a frame (the
    plain path never), and both emit the same masks, ids and boxes."""
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N)
    outs = {}
    for lap in ("auction_pallas", "auction"):
        init, step = make(lap, K, N, cuda)
        before = auction_cuda.LAUNCHES
        outs[lap] = MultiStreamRunner(init, step, S, device=cuda).run(
            dets, masks)
        launched = auction_cuda.LAUNCHES - before
        assert launched == (launches_per_frame * T
                            if lap == "auction_pallas" else 0)
    (ko, km), (po, pm) = outs["auction_pallas"], outs["auction"]
    assert int(km.sum()) > 0
    assert torch.equal(km, pm)
    assert torch.equal(ko[km], po[pm])


def test_sort_rollout_kernel_path_equals_plain_path(cuda):
    from motcpp_tpu_torch.models.sort import SortConfig, make_sort

    rollout_kernel_path_equals_plain_path(
        cuda, lambda lap, K, N, dev: make_sort(SortConfig(
            min_hits=1, max_age=3, max_tracks=K, max_dets=N, lap_impl=lap),
            device=dev), 1)


@pytest.mark.parametrize("use_byte", [False, True], ids=["ocr", "byte"])
def test_ocsort_rollout_kernel_path_equals_plain_path(cuda, use_byte):
    from motcpp_tpu_torch.models.ocsort import OCSortConfig, make_ocsort

    rollout_kernel_path_equals_plain_path(
        cuda, lambda lap, K, N, dev: make_ocsort(OCSortConfig(
            min_hits=1, use_byte=use_byte, max_tracks=K, max_dets=N,
            lap_impl=lap), device=dev), 3 if use_byte else 2)


def test_strongsort_live_priority_kernel_path_equals_plain_path(cuda):
    """StrongSORT live ReID at a priority budget below the valid count:
    OSNet x0_25 with every OSBlock through its kernel (6 launches a
    frame) and the auction kernel (2 a frame); the plain-auction path is
    fed the same embeddings, replayed, and emits the same."""
    from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x0_25
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.models.strongsort import (
        StrongSortConfig,
        make_strongsort,
    )

    S, N, T, D = 16, 16, 6, 512
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N, n_obj=10)
    crops = torch.randint(0, 256, (T, S, N, 64, 32, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    embed = make_embed_fn(init_params(osnet_x0_25(feature_dim=D), seed=0),
                          compute_dtype="bfloat16", fused=True, device=cuda)
    recorded = []

    def record(c):
        recorded.append(embed(c))
        return recorded[-1]

    replay = iter(recorded)
    outs = {}
    for lap, fn in (("auction_pallas", record),
                    ("auction", lambda c: next(replay))):
        init, step = make_strongsort(StrongSortConfig(
            n_init=1, gallery_cap=16, emb_dim=D, max_tracks=64, max_dets=N,
            lap_impl=lap), device=cuda)
        before = (osblock_cuda.LAUNCHES, auction_cuda.LAUNCHES)
        runner = MultiStreamRunner(init, step, S, device=cuda, embed_fn=fn,
                                   crop_budget=96, emb_priority=True)
        outs[lap] = runner.run(dets, masks, embs=crops)
        launched = (osblock_cuda.LAUNCHES - before[0],
                    auction_cuda.LAUNCHES - before[1])
        assert launched == ((6 * T, 2 * T) if lap == "auction_pallas"
                            else (0, 0))
    assert int(masks.sum((1, 2)).min()) > 96  # the budget binds
    (ko, km), (po, pm) = outs["auction_pallas"], outs["auction"]
    assert int(km.sum()) > 0
    assert torch.equal(km, pm)
    assert torch.equal(ko[km], po[pm])


@pytest.mark.parametrize("name,launches", [("deepocsort", 2),
                                            ("boosttrack", 1),
                                            ("hybridsort", 3)])
def test_appearance_tracker_rollout_kernel_path_equals_plain_path(cuda, name,
                                                                  launches):
    """DeepOC-SORT, BoostTrack and HybridSORT at bench.py's motion-only
    configs (bench.py:96-134)."""
    import importlib

    mod = importlib.import_module(f"motcpp_tpu_torch.models.{name}")
    config = next(getattr(mod, a) for a in dir(mod) if a.endswith("Config"))
    extra = {"deepocsort": dict(embedding_off=True, cmc_off=True),
             "boosttrack": {}, "hybridsort": dict(with_reid=False)}[name]
    rollout_kernel_path_equals_plain_path(
        cuda, lambda lap, K, N, dev: getattr(mod, f"make_{name}")(config(
            min_hits=1, max_tracks=K, max_dets=N, lap_impl=lap, **extra),
            device=dev), launches)


@pytest.mark.parametrize("name,launches,runner_kw", [
    ("deepocsort", 2, dict(emb_cadence=8)),
    ("boosttrack", 1, dict(emb_cadence=2)),
    ("hybridsort", 3, dict(crop_budget=205, emb_priority=True)),
])
def test_appearance_tracker_live_kernel_path_equals_plain_path(
        cuda, name, launches, runner_kw):
    """Live ReID at each tracker's deployed cadence or priority budget
    (bench.py DEPLOYED; HybridSORT's 0.8 of S*N, below the valid crop
    count): OSNet x0_25 with every OSBlock through its kernel (6 launches
    an embedded frame) and the auction kernel; the plain-auction path is
    fed the same embeddings, replayed, and emits the same."""
    import importlib

    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x0_25
    from motcpp_tpu_torch.appearance.reid import make_embed_fn

    mod = importlib.import_module(f"motcpp_tpu_torch.models.{name}")
    config = next(getattr(mod, a) for a in dir(mod) if a.endswith("Config"))
    extra = {"deepocsort": dict(embedding_off=False, cmc_off=True),
             "boosttrack": dict(with_reid=True),
             "hybridsort": dict(with_reid=True)}[name]
    S, N, T, D = 16, 16, 6, 512
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N,
                                    n_obj=14)
    crops = torch.randint(0, 256, (T, S, N, 64, 32, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    embed = make_embed_fn(init_params(osnet_x0_25(feature_dim=D), seed=0),
                          compute_dtype="bfloat16", fused=True, device=cuda)
    recorded = []

    def record(c):
        recorded.append(embed(c))
        return recorded[-1]

    replay = iter(recorded)
    outs = {}
    for lap, fn in (("auction_pallas", record),
                    ("auction", lambda c: next(replay))):
        init, step = getattr(mod, f"make_{name}")(config(
            min_hits=1, emb_dim=D, max_tracks=64, max_dets=N, lap_impl=lap,
            **extra), device=cuda)
        before = (osblock_cuda.LAUNCHES, auction_cuda.LAUNCHES)
        runner = MultiStreamRunner(init, step, S, device=cuda, embed_fn=fn,
                                   **runner_kw)
        outs[lap] = runner.run(dets, masks, embs=crops)
        launched = (osblock_cuda.LAUNCHES - before[0],
                    auction_cuda.LAUNCHES - before[1])
        assert launched == ((6 * T, launches * T) if lap == "auction_pallas"
                            else (0, 0))
    if runner_kw.get("emb_priority"):
        assert int(masks.sum((1, 2)).min()) > runner_kw["crop_budget"]
    (ko, km), (po, pm) = outs["auction_pallas"], outs["auction"]
    assert int(km.sum()) > 0
    assert torch.equal(km, pm)
    assert torch.equal(ko[km], po[pm])


@pytest.mark.parametrize("name", ["deepocsort", "boosttrack", "hybridsort"])
def test_appearance_tracker_eval_cli_on_the_card_writes_the_goldens(
        cuda, name, tmp_path):
    """The port's eval CLI on the card (exact JV; the wrappers' own
    camera-motion estimators on the dummy frames: without OpenCV, SOF
    falls back to the torch estimator and ECC to the identity) writes
    tests/golden/<tracker> byte for byte, as on the CPU."""
    from pathlib import Path

    from motcpp_tpu_torch.cli import main

    root = Path(__file__).resolve().parent
    mot = root.parent / "assets" / "MOT17-mini" / "train"
    assert main([str(mot), str(tmp_path), name, "--max-dets", "128",
                 "--max-tracks", "128"]) == 0
    golden = sorted((root / "golden" / name).glob("*.txt"))
    assert len(golden) == 2
    for gf in golden:
        assert (tmp_path / gf.name).read_text() == gf.read_text(), gf.name


def test_ucmctrack_rollout_kernel_path_equals_plain_path(cuda):
    """bench.py's config: stage 1, then stages 2 and 3 as one launch."""
    from motcpp_tpu_torch.models.ucmctrack import UCMCConfig, make_ucmctrack

    rollout_kernel_path_equals_plain_path(
        cuda, lambda lap, K, N, dev: make_ucmctrack(UCMCConfig(
            max_tracks=K, max_dets=N, lap_impl=lap), device=dev), 2)


@pytest.mark.parametrize("which", ["golden", "golden_long"])
def test_ucmctrack_eval_cli_on_the_card_writes_the_goldens(cuda, which,
                                                           tmp_path):
    """The port's eval CLI on the card (exact JV, dt = 1/fps) writes
    tests/golden/ucmctrack and tests/golden_long/ucmctrack byte for
    byte, as on the CPU."""
    from pathlib import Path

    from motcpp_tpu_torch.cli import main

    root = Path(__file__).resolve().parent
    mot = root.parent / "assets" / "MOT17-mini" / "train"
    extra = ["--no-ablation", "--limit-frames", "150"] if which == (
        "golden_long") else []
    assert main([str(mot), str(tmp_path), "ucmctrack", "--max-dets", "128",
                 "--max-tracks", "128", *extra]) == 0
    golden = sorted((root / which / "ucmctrack").glob("*.txt"))
    assert len(golden) == 2
    for gf in golden:
        assert (tmp_path / gf.name).read_text() == gf.read_text(), gf.name


def textured_pairs(S=8, h=162, w=288, seed=0):
    """bench.py's live-CMC textures at its 0.15 scale (``pan_texture``),
    each stream's second frame the first shifted by whole pixels (some
    outside Gauss-Newton's basin) and the last stream flat."""
    tex = pan_texture(S, h + 64, w + 64,
                      torch.Generator().manual_seed(seed)).numpy()
    shifts = np.random.default_rng(seed).integers(-30, 31, (S, 2))
    prev = tex[:, 32:32 + h, 32:32 + w]
    cur = np.stack([tex[s, 32 - dy:32 - dy + h, 32 - dx:32 - dx + w]
                    for s, (dx, dy) in enumerate(shifts)])
    prev[-1] = cur[-1] = 127.0
    return prev, cur, shifts


def test_ecc_on_the_card_matches_the_cpu(cuda):
    """ecc_jax_batch on the card against the port on the CPU, the same
    frames: the integer phase-correlation shift exact (cuFFT and
    pocketfft round differently), the ok flags equal and the warps
    within 1e-4 px (tests/test_torch_ecc.py's tolerance)."""
    from motcpp_tpu_torch.motion import cmc

    prev, cur, shifts = textured_pairs()
    on = [torch.from_numpy(a).to(cuda) for a in (prev, cur)]
    off = [torch.from_numpy(a) for a in (prev, cur)]
    for got, want in zip(cmc.phase_shift(*on), cmc.phase_shift(*off)):
        assert torch.equal(got.cpu(), want)
    (gw, gok), (ww, wok) = cmc.ecc_jax_batch(*on), cmc.ecc_jax_batch(*off)
    assert torch.equal(gok.cpu(), wok)
    assert wok[:-1].all() and not bool(wok[-1])
    torch.testing.assert_close(gw.cpu(), ww, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ww[:-1, :, 2].numpy(), shifts[:-1], atol=1e-3)


def test_live_cmc_strongsort_kernel_path_equals_plain_path(cuda):
    """bench.py's strongsort_cmc_ecc row at S=64: StrongSORT with the
    warps of ecc_jax_batch on each frame pair through the auction kernel
    and through the plain auction, split across two run() calls."""
    from motcpp_tpu_torch.models.strongsort import (
        StrongSortConfig,
        make_strongsort,
    )
    from motcpp_tpu_torch.motion.cmc import ecc_jax_batch

    S, T, N = 64, 12, 32
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N)
    frames, _ = pan_frames(T, S, 162, 288,
                           torch.Generator(device=cuda).manual_seed(0))
    outs = {}
    for lap in ("auction_pallas", "auction"):
        init, step = make_strongsort(StrongSortConfig(
            n_init=1, gallery_cap=16, max_tracks=64, max_dets=N,
            lap_impl=lap), device=cuda)
        runner = MultiStreamRunner(init, step, S, device=cuda,
                                   cmc_fn=ecc_jax_batch, cmc_scale=0.15)
        before = auction_cuda.LAUNCHES
        parts = [runner.run(dets[sl], masks[sl], frames=frames[sl])
                 for sl in (slice(0, 5), slice(5, T))]
        assert auction_cuda.LAUNCHES - before == (
            2 * T if lap == "auction_pallas" else 0)
        outs[lap] = [torch.cat([p[i] for p in parts]) for i in range(2)]
    (ko, km), (po, pm) = outs["auction_pallas"], outs["auction"]
    assert int(km.sum()) > 0
    assert torch.equal(km, pm)
    assert torch.equal(ko[km], po[pm])


@pytest.mark.parametrize("name,box_atol", [("ucmctrack", 0), ("sort", 1e-3)])
def test_per_class_on_the_card_emits_what_it_emits_on_the_cpu(cuda, name,
                                                               box_atol):
    """PerClassTracker over the tracker on the card and on the CPU, on a
    three-class scene: ids, confidences, classes and det_ind identical;
    UCMCTrack's boxes are the detections', SORT's its Kalman state (the
    card may fuse multiply-adds)."""
    from motcpp_tpu_torch import create_tracker
    from motcpp_tpu_torch.models.per_class import PerClassTracker

    T, N = 24, 12
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, 1, N,
                                    n_obj=N)
    dets[..., 5] = (np.arange(N) % 3).astype(np.float32)
    masks[12:16, :, 2::3] = False
    kw = dict(max_tracks=16, max_dets=8)
    trackers = [PerClassTracker(lambda dev=dev: create_tracker(
        name, device=dev, **kw)) for dev in (cuda, "cpu")]
    emitted = 0
    for t in range(T):
        got, want = (tr.update(dets[t, 0][masks[t, 0]]) for tr in trackers)
        assert got.shape == want.shape, t
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                                   atol=box_atol)
        emitted += got.shape[0]
    assert emitted > 0


def osblock_setup(device, dtype, seed=0, arch="x0_25"):
    """Folded OSNet weights (osnet_x0_25 unless ``arch`` says otherwise)
    packed per block, on ``device``."""
    from motcpp_tpu_torch.appearance import osblock, osnet
    from motcpp_tpu_torch.appearance.quant import fold_osnet

    model = getattr(osnet, f"osnet_{arch}")()
    folded = fold_osnet(osnet.init_params(model, seed=seed))
    folded = {n: {k: v.to(device, dtype) for k, v in leaf.items()}
              for n, leaf in folded.items()}
    return folded, osblock.pack_blocks(folded, dtype)


# (arch, block, (H, W), crops)
OSBLOCK_CASES = [
    # osnet_x0_25: mid 16, 24 and 32 (depths padded to 16 in shared
    # memory), hidden 1 and 2; odd W; five crops, fewer than CTAs
    ("x0_25", "conv2_0", (16, 8), 5),
    ("x0_25", "conv2_1", (9, 5), 5),
    ("x0_25", "conv3_0", (7, 3), 5),
    ("x0_25", "conv4_1", (4, 2), 5),
    # osnet_x0_75's stage 3: mid 72, hidden 4
    ("x0_75", "conv3_0", (7, 3), 5),
    ("x0_75", "conv3_1", (16, 8), 5),
    # several row tiles: a partial last tile (13 rows of 11 in tiles of
    # 11 rows) and halo rows across tiles; the 64x32 stage-2 map
    ("x0_25", "conv2_1", (13, 11), 3),
    ("x0_25", "conv2_0", (64, 32), 3),
    # more crops than CTAs: a CTA walks several crops, and its gate sums
    # start again from zero for each
    ("x0_25", "conv4_0", (4, 2), 600),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "arch,block,hw,B", OSBLOCK_CASES,
    ids=[f"{a}-{b}-{h}x{w}-B{n}" for a, b, (h, w), n in OSBLOCK_CASES])
def test_osblock_kernel_matches_plain_version(cuda, dtype, arch, block, hw,
                                              B):
    from motcpp_tpu_torch.appearance import osblock, osblock_cuda

    folded, packed = osblock_setup(cuda, dtype, arch=arch)
    w = packed[block]
    x = torch.relu(torch.randn((B, *hw, w.cin), generator=torch.Generator()
                               .manual_seed(1))).to(cuda, dtype)
    before = osblock_cuda.LAUNCHES
    got = osblock.osblock_fused(w, x)
    torch.cuda.synchronize()
    assert osblock_cuda.LAUNCHES == before + 1
    want = osblock.osblock_reference(folded, block, x, w.cout)
    assert got.shape == want.shape == (B, *hw, w.cout) and got.dtype == dtype
    g, r = got.float().reshape(B, -1), want.float().reshape(B, -1)
    if dtype == torch.float32:
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-4
    else:
        cos = (g * r).sum(1) / (g.norm(dim=1) * r.norm(dim=1))
        assert float(cos.min()) >= 0.999, cos


def test_osblock_wrapper_checks_its_inputs(cuda):
    from motcpp_tpu_torch.appearance import osblock_cuda

    _, packed = osblock_setup(cuda, torch.float32)
    w = packed["conv2_0"]
    x = torch.zeros((2, 8, 4, w.cin), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        osblock_cuda.osblock(w, x.half())
    with pytest.raises(ValueError, match="CUDA tensors"):
        osblock_cuda.osblock(w, x.cpu())
    with pytest.raises(ValueError, match=r"\(B >= 1"):
        osblock_cuda.osblock(w, x[..., :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        osblock_cuda.osblock(w, x.transpose(1, 2))
    with pytest.raises(ValueError, match="mats must be"):
        osblock_cuda.osblock(w, x.bfloat16())
    with pytest.raises(ValueError, match="multiples of 8"):
        osblock_cuda.osblock(w._replace(mid=w.mid + 4), x)
    with pytest.raises(ValueError, match="16-byte boundary"):
        osblock_cuda.osblock(
            w, torch.zeros(2 * 8 * 4 * w.cin + 1, device=cuda)[1:]
            .view(2, 8, 4, w.cin))
    with pytest.raises(ValueError, match="exceed the kernel's tile"):
        osblock_cuda.osblock(w, torch.zeros((1, 2, 130, w.cin), device=cuda))


def serve(svc, dets, masks, crops=None, pipelined=False):
    """Every stream's frames through the service, one tick a frame (two
    ticks in flight when ``pipelined``); returns (outs, out_masks) of
    all ticks, (T, S, K, 8) and (T, S, K). On a CUDA device each tick's
    dispatch runs in sync debug mode "error": a step_async that waited
    for the device or read a value back would raise."""
    hs = [svc.attach() for _ in range(dets.shape[1])]
    pend, got = [], []
    for t in range(dets.shape[0]):
        for s, h in enumerate(hs):
            n = int(masks[t, s].sum())
            svc.submit(h, dets[t, s, :n],
                       crops=None if crops is None else crops[t, s, :n])
        if svc.device.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            pend.append(svc.step_async())
        finally:
            if svc.device.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        if len(pend) == (2 if pipelined else 1):
            got.append(pend.pop(0).result())
    got += [p.result() for p in pend]
    return (np.stack([b.outs for b in got]),
            np.stack([b.out_masks for b in got]))


def test_service_on_the_card_equals_the_runner(cuda):
    """The serving tick on the card through the auction kernel (two
    launches a tick): every stream's frames through the native mux give
    the runner's emissions on the same (packed) frames, bit for bit, also
    with two ticks in flight; dispatching a tick neither waits for the
    device nor reads a value back (CUDA sync debug mode "error")."""
    from motcpp_tpu_torch.serving import StreamMux, TrackingService

    S, K, N, T = 16, 64, 32, 10
    dets, masks, _ = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(0), T, S, N))
    init, step = make_bytetrack(ByteTrackConfig(
        max_tracks=K, max_dets=N, lap_impl="auction_pallas"), device=cuda)
    want_o, want_m = MultiStreamRunner(init, step, S, device=cuda).run(
        dets, masks)
    for pipelined in (False, True):
        svc = TrackingService(init, step, S, max_dets=N, device=cuda)
        assert isinstance(svc.mux, StreamMux)
        before = auction_cuda.LAUNCHES
        outs, out_masks = serve(svc, dets, masks, pipelined=pipelined)
        assert auction_cuda.LAUNCHES - before == 2 * T
        assert int(out_masks.sum()) > 0
        np.testing.assert_array_equal(out_masks, want_m.cpu().numpy())
        np.testing.assert_array_equal(outs[out_masks],
                                      want_o.cpu().numpy()[out_masks])


def test_live_service_on_the_card_equals_the_runner(cuda):
    """Live ReID through the service on the card at BoT-SORT's deployed
    cadence (k=8, 64x32 crops, osnet_x0_25 bf16 fused): only the
    scheduled slots' crops are sent, every tick launches the OSBlock
    kernel 6 times and the auction kernel twice, the emissions equal the
    runner's on the same crops bit for bit, and dispatch does not
    synchronise."""
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x0_25
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort
    from motcpp_tpu_torch.serving import TrackingService

    S, N, T, D, k, hw = 16, 16, 10, 512, 8, (64, 32)
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N,
                                    n_obj=14)
    crops = np.random.default_rng(1).integers(
        0, 256, (T, S, N) + hw + (3,), dtype=np.uint8)
    dets, masks, crops, _ = pack_valid_rows(dets, masks, crops)
    embed = make_embed_fn(init_params(osnet_x0_25(feature_dim=D), seed=0),
                          compute_dtype="bfloat16", fused=True, device=cuda)
    init, step = make_botsort(BotSortConfig(
        with_reid=True, emb_dim=D, max_tracks=64, max_dets=N,
        lap_impl="auction_pallas"), device=cuda)
    want_o, want_m = MultiStreamRunner(
        init, step, S, device=cuda, embed_fn=embed, emb_cadence=k).run(
        dets, masks, embs=crops)
    svc = TrackingService(init, step, S, max_dets=N, emb_dim=D, device=cuda,
                          crop_hw=hw, embed_fn=embed, emb_cadence=k)
    assert svc._cad_compact
    before = (osblock_cuda.LAUNCHES, auction_cuda.LAUNCHES)
    outs, out_masks = serve(svc, dets, masks, crops)
    assert (osblock_cuda.LAUNCHES - before[0],
            auction_cuda.LAUNCHES - before[1]) == (6 * T, 2 * T)
    assert int(out_masks.sum()) > 0
    np.testing.assert_array_equal(out_masks, want_m.cpu().numpy())
    np.testing.assert_array_equal(outs[out_masks],
                                  want_o.cpu().numpy()[out_masks])


@pytest.fixture
def dispatch_launches(monkeypatch):
    """Auction kernel launches of every TrackingService.step_async."""
    from motcpp_tpu_torch.serving import TrackingService

    deltas, dispatch = [], TrackingService.step_async

    def counted(self):
        before = auction_cuda.LAUNCHES
        out = dispatch(self)
        deltas.append(auction_cuda.LAUNCHES - before)
        return out

    monkeypatch.setattr(TrackingService, "step_async", counted)
    return deltas


@pytest.mark.parametrize("extra", [[], ["--pipeline"],
                                   ["--pipeline", "--device-data"]],
                         ids=["producers", "pipelined", "device_data"])
def test_serving_harness_on_the_card_launches_the_kernel_every_tick(
        cuda, dispatch_launches, extra):
    """The serving latency harness at S=64 on the card (ByteTrack,
    producer threads through the native mux, or the staged ring): every
    dispatched tick launches the auction kernel twice and is resolved
    with every stream present, no frame is dropped, the percentiles are
    ordered and the row names the card and its power limit."""
    from motcpp_tpu_torch.scripts import serving_latency as harness

    report = {}
    row = harness.measure(harness.parser().parse_args(
        ["--streams", "64", "--warmup", "2", "--ticks", "10",
         "--producers", "2"] + extra), report=report)
    assert report["native_mux"]
    assert dispatch_launches and set(dispatch_launches) == {2}
    assert len(dispatch_launches) == len(report["presents"])
    assert set(report["presents"]) == {64}
    assert report["stats"]["dropped"] == 0
    qs = [row[k] for k in ("p50", "p90", "p95", "p99", "max")]
    assert np.all(np.isfinite(qs)) and qs == sorted(qs)
    assert row["device"] == torch.cuda.get_device_name(0)
    assert row["power_limit"].endswith("W")


@pytest.mark.parametrize("live", [False, True],
                         ids=["bytetrack", "botsort_live_cadence"])
def test_device_data_tick_equals_the_mux_tick(cuda, dispatch_launches, live):
    """Ticks of the harness's --device-data ring (dets, masks and, live,
    crops staged on the card and handed to the service as tensors),
    each dispatched with step_async under CUDA sync debug mode "error",
    equal bit for bit the ticks of the same frames and crops through the
    native mux: the staged tensors make no trip through the host and the
    dispatch does not wait for the card."""
    from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x0_25
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.scripts import serving_latency as harness
    from motcpp_tpu_torch.serving import StreamMux, TrackingService

    S, N, R, hw = 16, 16, 4, (64, 32)
    dets, masks = harness.staged_frames(R, S, N, 14)
    kw = dict(tracker_kw=dict(max_tracks=64, lap_impl="auction_pallas"),
              device=cuda)
    ring = [[torch.from_numpy(d).to(cuda), torch.from_numpy(m).to(cuda),
             None] for d, m in zip(dets, masks)]
    crops = None
    if live:
        embed = make_embed_fn(init_params(osnet_x0_25(feature_dim=16), 0),
                              compute_dtype="bfloat16", fused=True,
                              device=cuda)
        kw.update(emb_dim=16, crop_hw=hw, embed_fn=embed, emb_cadence=2)
        for r, e in enumerate(ring):
            e[2] = torch.randint(0, 255, (S, N) + hw + (3,), dtype=torch.uint8,
                                 generator=torch.Generator(cuda)
                                 .manual_seed(r), device=cuda)
        crops = np.stack([e[2].cpu().numpy() for e in ring])
    name = "botsort" if live else "bytetrack"
    staged = TrackingService.from_tracker(name, S, max_dets=N, **kw)
    for _ in range(S):
        staged.attach()
    staged.mux = harness.DeviceRingMux(ring, S, S, cuda)
    torch.cuda.synchronize()
    via_mux = TrackingService.from_tracker(name, S, max_dets=N, **kw)
    assert isinstance(via_mux.mux, StreamMux)
    hs = [via_mux.attach() for _ in range(S)]
    emitted = 0
    for t in range(2 * R):
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = staged.step_async()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = pending.result()
        r = t % R
        for s, h in enumerate(hs):
            n = int(masks[r, s].sum())
            via_mux.submit(h, dets[r, s, :n],
                           crops=None if crops is None else crops[r, s, :n])
        want = via_mux.step()
        np.testing.assert_array_equal(got.out_masks, want.out_masks)
        np.testing.assert_array_equal(got.outs[got.out_masks],
                                      want.outs[want.out_masks])
        emitted += int(got.out_masks.sum())
    assert emitted > 0
    assert set(dispatch_launches) == {2}


def serve_range(svc, hs, dets, masks, ticks):
    """Submit every stream's frame of each tick in ``ticks`` and step;
    returns the stacked outs and out_masks."""
    got = []
    for t in ticks:
        for s, h in enumerate(hs):
            svc.submit(h, dets[t, s, :int(masks[t, s].sum())])
        got.append(svc.step())
    return (np.stack([b.outs for b in got]),
            np.stack([b.out_masks for b in got]))


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_service_checkpoint_failover_on_the_card(cuda, tmp_path, fmt):
    """The ByteTrack service on the card through the auction kernel: its
    state saved after 5 ticks and restored into a fresh service from
    _init_states() continues the uninterrupted run bit for bit."""
    from motcpp_tpu_torch.serving import TrackingService
    from motcpp_tpu_torch.utils.checkpoint import load_state, save_state

    S, N, T = 16, 32, 10
    dets, masks, _ = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(0), T, S, N))
    init, step = make_bytetrack(ByteTrackConfig(
        max_tracks=64, max_dets=N, lap_impl="auction_pallas"), device=cuda)

    def service():
        svc = TrackingService(init, step, S, max_dets=N, device=cuda)
        return svc, [svc.attach() for _ in range(S)]

    ref, hs = service()
    want = serve_range(ref, hs, dets, masks, range(T))
    a, ha = service()
    serve_range(a, ha, dets, masks, range(5))
    save_state(a.states, tmp_path / f"svc.{fmt}")
    b, hb = service()
    b.restore(load_state(b._init_states(), tmp_path / f"svc.{fmt}"))
    b._reset[:] = False
    assert all(t.device.type == "cuda" for t in b.states)
    before = auction_cuda.LAUNCHES
    got = serve_range(b, hb, dets, masks, range(5, T))
    assert auction_cuda.LAUNCHES - before == 2 * (T - 5)
    assert int(got[1].sum()) > 0
    np.testing.assert_array_equal(got[1], want[1][5:])
    np.testing.assert_array_equal(got[0][got[1]], want[0][5:][got[1]])


def test_card_checkpoint_continues_on_the_cpu(cuda, tmp_path):
    """A torch checkpoint file of the service on the card loads on the
    CPU and continues there (the plain auction) as a CPU service that
    ran the whole stream does: masks and ids equal, boxes within 1e-4."""
    from motcpp_tpu_torch.serving import TrackingService
    from motcpp_tpu_torch.utils.checkpoint import load_state, save_state

    S, N, T = 16, 32, 10
    dets, masks, _ = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(1), T, S, N))

    def service(dev):
        init, step = make_bytetrack(ByteTrackConfig(
            max_tracks=64, max_dets=N, lap_impl="auction_pallas"), device=dev)
        svc = TrackingService(init, step, S, max_dets=N, device=dev)
        return svc, [svc.attach() for _ in range(S)]

    card, hc = service(cuda)
    serve_range(card, hc, dets, masks, range(5))
    save_state(card.states, tmp_path / "card.pt")
    cpu, hp = service("cpu")
    cpu.restore(load_state(cpu._init_states(), tmp_path / "card.pt"))
    cpu._reset[:] = False
    assert all(t.device.type == "cpu" for t in cpu.states)
    got = serve_range(cpu, hp, dets, masks, range(5, T))
    plain, hq = service("cpu")
    want = serve_range(plain, hq, dets, masks, range(T))
    assert int(got[1].sum()) > 0
    np.testing.assert_array_equal(got[1], want[1][5:])
    g, w = got[0][got[1]], want[0][5:][got[1]]
    np.testing.assert_array_equal(g[:, 4], w[:, 4])
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_reid_warmup_on_the_card_runs_the_unfolded_forward(cuda):
    """ReIDBackend.warmup() on the card runs the unfolded OSNet, as the
    JAX backend runs its Flax module: it launches neither kernel, and its
    embeddings equal the CPU backend's on the same batch within 1e-3."""
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.appearance.reid import ReIDBackend

    feats = {}
    backends = {"card": ReIDBackend(device=cuda),
                "cpu": ReIDBackend(device="cpu")}
    for key, b in backends.items():
        inner = b.get_features
        b.get_features = lambda x, i, inner=inner, key=key: feats.setdefault(
            key, inner(x, i))
    before = (osblock_cuda.LAUNCHES, auction_cuda.LAUNCHES)
    backends["card"].warmup()
    torch.cuda.synchronize()
    assert (osblock_cuda.LAUNCHES, auction_cuda.LAUNCHES) == before
    backends["cpu"].warmup()
    assert feats["card"].shape == (2, 512)
    np.testing.assert_allclose(feats["card"], feats["cpu"], rtol=0, atol=1e-3)


def test_trace_on_the_card_names_the_auction_kernel(cuda, tmp_path):
    """utils/profiling.py::trace records the card's kernels: a ByteTrack
    rollout through the auction kernel exports a trace naming it."""
    import json
    from pathlib import Path

    from motcpp_tpu_torch.utils.profiling import trace

    dets, masks = synth_stream_dets(np.random.default_rng(0), 3, 8, 32)
    init, step = make_bytetrack(ByteTrackConfig(
        max_tracks=64, max_dets=32, lap_impl="auction_pallas"), device=cuda)
    runner = MultiStreamRunner(init, step, 8, device=cuda)
    with trace(tmp_path / "t", device=cuda) as logdir:
        runner.run(dets, masks)
        torch.cuda.synchronize()
    (path,) = Path(logdir).glob("*.pt.trace.json")
    names = {e.get("name", "") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert any("auction_kernel" in n for n in names)


@pytest.mark.parametrize("name", ["deepocsort", "boosttrack", "hybridsort"])
def test_appearance_tracker_eval_cli_on_the_card_writes_golden_long(
        cuda, name, tmp_path):
    """The port's eval CLI on the card writes tests/golden_long/<tracker>
    (--no-ablation --limit-frames 150) byte for byte, as on the CPU;
    chip_smoke.py phase 18 writes the other trackers' sets but
    UCMCTrack's (test_ucmctrack_eval_cli_on_the_card_writes_the_goldens)."""
    from pathlib import Path

    from motcpp_tpu_torch.cli import main

    root = Path(__file__).resolve().parent
    mot = root.parent / "assets" / "MOT17-mini" / "train"
    assert main([str(mot), str(tmp_path), name, "--max-dets", "128",
                 "--max-tracks", "128", "--no-ablation", "--limit-frames",
                 "150"]) == 0
    golden = sorted((root / "golden_long" / name).glob("*.txt"))
    assert len(golden) == 2
    for gf in golden:
        assert (tmp_path / gf.name).read_text() == gf.read_text(), gf.name


def shard_devices(cuda, spread):
    """Two shards on one card, or one shard on each visible card."""
    if spread == "one_card":
        return [cuda, cuda]
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more visible CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("spread", ["one_card", "every_card"])
def test_sharded_runner_on_the_card_equals_one_device(cuda, spread):
    """ByteTrack through the auction kernel sharded over devices (two
    launches a shard a frame) emits the one-device run bit for bit, from
    inputs on the host and from inputs on the card; the outputs are
    gathered on devices[0]; the collectives over the shards equal the
    plain reductions."""
    from motcpp_tpu_torch.parallel import (
        Mesh,
        emission_stats,
        per_stream_emissions,
        shard_over_streams,
    )

    devices = shard_devices(cuda, spread)
    n, T = len(devices), 10
    S = 32 * n
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, 32)
    init, step = make_bytetrack(ByteTrackConfig(
        max_tracks=64, max_dets=32, lap_impl="auction_pallas"), device=cuda)
    want = MultiStreamRunner(init, step, S, device=cuda).run(dets, masks)
    for inputs in ((dets, masks), (torch.from_numpy(dets).to(cuda),
                                   torch.from_numpy(masks).to(cuda))):
        runner = MultiStreamRunner(init, step, S, devices=devices)
        before = auction_cuda.LAUNCHES
        got = runner.run(*inputs)
        assert auction_cuda.LAUNCHES - before == 2 * n * T
        assert got[0].device == Mesh(devices)[0]
        assert torch.equal(got[1], want[1]) and int(want[1].sum()) > 0
        assert torch.equal(got[0][got[1]], want[0][want[1]])
    mesh = Mesh(devices)
    chunks = shard_over_streams(mesh, got[1])
    assert [c.device for c in chunks] == list(mesh)
    om = want[1]
    assert emission_stats(chunks, mesh) == {
        "total_emissions": int(om.sum()), "frames_processed": T * S,
        "active_streams": int(om.any(2).any(0).sum()),
        "peak_tracks_per_frame": int(om.sum(2).max())}
    assert torch.equal(per_stream_emissions(chunks, mesh).cpu(),
                       om.sum((0, 2), dtype=torch.int32).cpu())


def live_setup(cuda, S, T, k=8, N=16, hw=(64, 32), D=512):
    from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x0_25
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort

    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N,
                                    n_obj=14)
    crops = np.random.default_rng(1).integers(
        0, 256, (T, S, N) + hw + (3,), dtype=np.uint8)
    dets, masks, crops, _ = pack_valid_rows(dets, masks, crops)
    embed = make_embed_fn(init_params(osnet_x0_25(feature_dim=D), seed=0),
                          compute_dtype="bfloat16", fused=True, device=cuda)
    init, step = make_botsort(BotSortConfig(
        with_reid=True, emb_dim=D, max_tracks=64, max_dets=N,
        lap_impl="auction_pallas"), device=cuda)
    return dets, masks, crops, embed, init, step


@pytest.mark.parametrize("spread", ["one_card", "every_card"])
def test_sharded_live_runner_and_service_on_the_card(cuda, spread):
    """Live BoT-SORT at cadence 8 sharded over devices: the runner and
    the service with compacted crops (6 OSBlock and 2 auction launches a
    shard a tick) emit the one-device runner's rows bit for bit, and a
    sharded tick's dispatch neither waits for a device nor reads a value
    back (CUDA sync debug mode "error"), also with two ticks in flight."""
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.serving import TrackingService

    devices = shard_devices(cuda, spread)
    n, T, k = len(devices), 10, 8
    S = 16 * n
    dets, masks, crops, embed, init, step = live_setup(cuda, S, T, k)
    want_o, want_m = MultiStreamRunner(
        init, step, S, device=cuda, embed_fn=embed, emb_cadence=k).run(
        dets, masks, embs=crops)
    runner = MultiStreamRunner(init, step, S, devices=devices,
                               embed_fn=embed, emb_cadence=k)
    before = (osblock_cuda.LAUNCHES, auction_cuda.LAUNCHES)
    got_o, got_m = runner.run(dets, masks, embs=crops)
    assert (osblock_cuda.LAUNCHES - before[0],
            auction_cuda.LAUNCHES - before[1]) == (6 * n * T, 2 * n * T)
    assert torch.equal(got_m, want_m) and int(want_m.sum()) > 0
    assert torch.equal(got_o[got_m], want_o[want_m])
    for pipelined in (False, True):
        svc = TrackingService(init, step, S, max_dets=16, emb_dim=512,
                              devices=devices, crop_hw=(64, 32),
                              embed_fn=embed, emb_cadence=k)
        assert svc._cad_compact
        before = (osblock_cuda.LAUNCHES, auction_cuda.LAUNCHES)
        outs, out_masks = serve(svc, dets, masks, crops, pipelined)
        assert (osblock_cuda.LAUNCHES - before[0],
                auction_cuda.LAUNCHES - before[1]) == (6 * n * T, 2 * n * T)
        np.testing.assert_array_equal(out_masks, want_m.cpu().numpy())
        np.testing.assert_array_equal(outs[out_masks],
                                      want_o.cpu().numpy()[out_masks])


@pytest.mark.parametrize("spread", ["one_card", "every_card"])
def test_sharded_service_on_the_card_equals_the_runner(cuda, spread):
    """ByteTrack's service sharded over devices gives the one-device
    runner's emissions bit for bit, with and without two ticks in
    flight, and its dispatch does not synchronise; a stream exported from
    it continues in a one-device service."""
    from motcpp_tpu_torch.serving import TrackingService

    devices = shard_devices(cuda, spread)
    n, T, N = len(devices), 10, 32
    S = 16 * n
    dets, masks, _ = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(0), T, S, N))
    init, step = make_bytetrack(ByteTrackConfig(
        max_tracks=64, max_dets=N, lap_impl="auction_pallas"), device=cuda)
    want_o, want_m = MultiStreamRunner(init, step, S, device=cuda).run(
        dets, masks)
    for pipelined in (False, True):
        svc = TrackingService(init, step, S, max_dets=N, devices=devices)
        before = auction_cuda.LAUNCHES
        outs, out_masks = serve(svc, dets, masks, pipelined=pipelined)
        assert auction_cuda.LAUNCHES - before == 2 * n * T
        np.testing.assert_array_equal(out_masks, want_m.cpu().numpy())
        np.testing.assert_array_equal(outs[out_masks],
                                      want_o.cpu().numpy()[out_masks])
    assert all(t.device == svc.device for t in svc.states)


def test_two_process_dryrun_on_the_card(cuda):
    """dryrun_multihost: two processes, each with 4 shards on the card
    through the auction kernel, gather per-stream counts over gloo equal
    to one process's run of the whole scene."""
    from motcpp_tpu_torch.parallel.multihost import dryrun_multihost

    report = dryrun_multihost(2, device="cuda")
    assert report["ok"] and report["device"].startswith("cuda")
    assert report["emissions"] == sum(report["counts"]) > 0


@pytest.mark.parametrize("shape", [(64, 256, 128), (4096, 64, 32)],
                         ids=["eight_warps_large_tile", "one_warp"])
def test_auction_kernel_on_every_card(cuda, shape):
    """The auction kernel equals its plain version on every visible card
    (a sharded runner launches it on each), in both layouts, the large
    tile taking more than 48 KB of shared memory."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more visible CUDA devices")
    args = problems(0, *shape)
    want = auction.solve_lap_auction(*args)
    for i in range(torch.cuda.device_count()):
        got = auction_cuda.solve(*(a.to(torch.device("cuda", i))
                                   for a in args))
        assert got[0].device.index == i
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def test_osblock_kernel_on_every_card(cuda):
    """The OSBlock kernel equals its plain version on every visible card
    (osnet_x1_0's conv2_0 at 64x32, more than 48 KB of shared memory)."""
    from motcpp_tpu_torch.appearance import osblock

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more visible CUDA devices")
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        folded, packed = osblock_setup(dev, torch.float32, arch="x1_0")
        w = packed["conv2_0"]
        x = torch.relu(torch.randn((4, 64, 32, w.cin), generator=torch
                                   .Generator().manual_seed(i))).to(dev)
        got = osblock.osblock_fused(w, x)
        want = osblock.osblock_reference(folded, "conv2_0", x, w.cout)
        assert got.device == dev
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# int8 ReID: the int8 product through torch._int_mm
# ---------------------------------------------------------------------------

def int8_operands(seed, m, k, n, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(-127, 128, shape, dtype=torch.int8,
                          generator=g).to(device) for shape in ((m, k), (k, n))]


@pytest.mark.parametrize("m,k,n", [(17, 64, 64), (8192, 64, 256),
                                   (4096, 256, 64), (32768, 152, 64),
                                   (24, 512, 512), (300, 384, 96)],
                         ids=["min_rows", "1x1_wide", "1x1_narrow",
                              "stem_padded_k", "head", "odd_rows"])
def test_int8_product_on_the_card_equals_its_plain_version(cuda, m, k, n):
    """torch._int_mm equals the plain version on the card and on the CPU
    (numpy's integer product), one launch, with b column-major (the
    layout padded_weight gives); a row-major b raises, launching
    nothing."""
    from motcpp_tpu_torch.ops import int8

    a, b = int8_operands(m + k + n, m, k, n, cuda)
    want = (a.cpu().numpy().astype(np.int64)
            @ b.cpu().numpy().astype(np.int64)).astype(np.int32)
    w = int8.padded_weight(b)
    before = int8.LAUNCHES
    got = int8.int8_matmul(a, w)
    torch.cuda.synchronize()
    assert int8.LAUNCHES == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(
        int8.int8_matmul_reference(a, w).cpu().numpy(), want)
    with pytest.raises(ValueError, match="b column-major"):
        int8.int8_matmul(a, b.contiguous())
    assert int8.LAUNCHES == before + 1


@pytest.mark.parametrize("m,k,n", [(16, 512, 512), (5, 147, 64),
                                   (40, 152, 60)])
def test_int8_product_on_the_card_pads_or_raises(cuda, m, k, n):
    """An operand outside torch._int_mm's rules (M <= 16, K or N not a
    multiple of 8) raises on the card, launching nothing and never
    falling back to a float product; the padded product pads it with
    zeros and equals the integer product."""
    from motcpp_tpu_torch.ops import int8

    a, b = int8_operands(m * k + n, m, k, n, cuda)
    before = int8.LAUNCHES
    with pytest.raises(ValueError, match="torch._int_mm on CUDA takes"):
        int8.int8_matmul(a, b)
    assert int8.LAUNCHES == before
    want = (a.cpu().numpy().astype(np.int64)
            @ b.cpu().numpy().astype(np.int64)).astype(np.int32)
    got = int8.int8_matmul_padded(a, int8.padded_weight(b), n)
    assert int8.LAUNCHES == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("act", ["bfloat16", "float32"])
def test_int8_embed_on_the_card_equals_its_plain_version(cuda, act):
    """make_embed_fn_int8 on the card (osnet_x1_0, 256x128 crops, 40
    crops) through torch._int_mm and through the plain int8 product give
    the same embeddings bit for bit; unit norm; no OSBlock launch."""
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x1_0
    from motcpp_tpu_torch.appearance.quant import make_embed_fn_int8
    from motcpp_tpu_torch.ops import int8

    embed = make_embed_fn_int8(init_params(osnet_x1_0(), seed=0),
                               act_dtype=act, device=cuda)
    crops = torch.randint(0, 256, (40, 256, 128, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(2)).to(cuda)
    before = (int8.LAUNCHES, osblock_cuda.LAUNCHES)
    got = embed(crops)
    torch.cuda.synchronize()
    assert int8.LAUNCHES > before[0] and osblock_cuda.LAUNCHES == before[1]
    launch = int8.int8_matmul
    int8.int8_matmul = int8.int8_matmul_reference
    try:
        want = embed(crops)
    finally:
        int8.int8_matmul = launch
    assert torch.equal(got, want)
    assert bool(((got.norm(dim=1) - 1).abs() < 1e-3).all())


def test_live_int8_service_on_the_card_equals_the_runner(cuda):
    """Live BoT-SORT at cadence 8 with the int8 embed (osnet_x0_25, 64x32
    crops, bf16 activations) through the runner and through the service
    on the card: the same emissions bit for bit, the int8 product and
    the auction kernel launched, the OSBlock kernel not."""
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x0_25
    from motcpp_tpu_torch.appearance.quant import make_embed_fn_int8
    from motcpp_tpu_torch.models.botsort import BotSortConfig, make_botsort
    from motcpp_tpu_torch.ops import int8
    from motcpp_tpu_torch.serving import TrackingService

    S, N, T, D, k, hw = 16, 16, 10, 512, 8, (64, 32)
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N,
                                    n_obj=14)
    crops = np.random.default_rng(1).integers(
        0, 256, (T, S, N) + hw + (3,), dtype=np.uint8)
    dets, masks, crops, _ = pack_valid_rows(dets, masks, crops)
    embed = make_embed_fn_int8(init_params(osnet_x0_25(feature_dim=D),
                                           seed=0), device=cuda)
    init, step = make_botsort(BotSortConfig(
        with_reid=True, emb_dim=D, max_tracks=64, max_dets=N,
        lap_impl="auction_pallas"), device=cuda)
    before = (int8.LAUNCHES, auction_cuda.LAUNCHES, osblock_cuda.LAUNCHES)
    want_o, want_m = MultiStreamRunner(
        init, step, S, device=cuda, embed_fn=embed, emb_cadence=k).run(
        dets, masks, embs=crops)
    svc = TrackingService(init, step, S, max_dets=N, emb_dim=D, device=cuda,
                          crop_hw=hw, embed_fn=embed, emb_cadence=k)
    outs, out_masks = serve(svc, dets, masks, crops)
    assert int8.LAUNCHES > before[0]
    assert auction_cuda.LAUNCHES - before[1] == 2 * 2 * T
    assert osblock_cuda.LAUNCHES == before[2]
    assert int(out_masks.sum()) > 0
    np.testing.assert_array_equal(out_masks, want_m.cpu().numpy())
    np.testing.assert_array_equal(outs[out_masks],
                                  want_o.cpu().numpy()[out_masks])


def assert_card_equals_cpu(got, want, box_cols, id_col, atol):
    """Masks and ids of a card rollout equal to the CPU's, the box
    columns within atol (tests/test_torch_sort.py and test_torch_ecc.py
    hold the CPU against JAX at these tolerances)."""
    (go, gm), (wo, wm) = (t.cpu() for t in got), want
    assert torch.equal(gm, wm) and int(wm.sum()) > 0
    assert torch.equal(go[gm][:, id_col], wo[wm][:, id_col])
    err = (go[gm][:, box_cols] - wo[wm][:, box_cols]).abs().max()
    assert float(err) <= atol


def test_obb_sort_on_the_card_equals_the_cpu_and_the_plain_path(cuda):
    """Oriented-box SORT at bench.py's SORT config (min_hits=1,
    max_age=3) under the runner: one kernel launch a frame, the plain
    auction's tracks on the card, the CPU's masks and ids with boxes
    within 1e-3 px."""
    from motcpp_tpu_torch.data import obb_stream_dets
    from motcpp_tpu_torch.models.sort import SortConfig, make_sort

    S, K, N, T = 64, 64, 32, 20
    dets, masks = obb_stream_dets(np.random.default_rng(0), T, S, N)

    def rollout(lap, device):
        init, step = make_sort(SortConfig(
            is_obb=True, min_hits=1, max_age=3, max_tracks=K, max_dets=N,
            lap_impl=lap), device=device)
        return MultiStreamRunner(init, step, S, device=device).run(dets,
                                                                   masks)

    before = auction_cuda.LAUNCHES
    ko, km = rollout("auction_pallas", cuda)
    assert auction_cuda.LAUNCHES - before == T
    assert ko.shape == (T, S, K, 9)
    po, pm = rollout("auction", cuda)
    assert torch.equal(km, pm) and same_bits(ko[km], po[pm])
    assert_card_equals_cpu((ko, km), rollout("auction_pallas", "cpu"),
                           slice(0, 5), 5, 1e-3)


def test_live_sof_runner_on_the_card_equals_the_cpu(cuda):
    """StrongSORT under cmc_fn=sof_jax_batch at CMC scale 0.15 (bench.py
    --cmc sof) on the same dets and 162x288 panning frames: the card
    emits the CPU's masks and ids, boxes within 1e-2 px."""
    from motcpp_tpu_torch.motion.cmc import sof_jax_batch
    from motcpp_tpu_torch.scripts.tracker_fns import build_tracker_fns

    S, K, N, T = 8, 64, 32, 8
    dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N)
    frames, _ = pan_frames(T, S, 162, 288, torch.Generator().manual_seed(0))

    def rollout(device):
        init, step = build_tracker_fns("strongsort", K, N, device=device)
        return MultiStreamRunner(
            init, step, S, device=device, cmc_fn=sof_jax_batch,
            cmc_scale=0.15).run(dets, masks, frames=frames.to(device))

    before = auction_cuda.LAUNCHES
    got = rollout(cuda)
    assert auction_cuda.LAUNCHES - before == 2 * T
    assert_card_equals_cpu(got, rollout("cpu"), slice(0, 4), 4, 1e-2)


def test_longrun_script_on_the_card_chunked_equals_unchunked(cuda):
    """The long-run script at S=256 over 1000 frames in chunks of 250,
    its scene made on the card, against one run() of the same frames:
    masks, ids, boxes and the carried state equal bit for bit."""
    from motcpp_tpu_torch.scripts import longrun_stability
    from motcpp_tpu_torch.scripts.tracker_fns import build_tracker_fns

    kept = []
    before = auction_cuda.LAUNCHES
    report = longrun_stability.run(
        longrun_stability.parser().parse_args(
            ["--streams", "256", "--frames", "1000", "--chunk", "250"]),
        on_chunk=lambda c, runner, *tensors: kept.append(tensors))
    assert report["failed"] is None and report["device"] != "cpu"
    assert auction_cuda.LAUNCHES - before == 2 * 1000
    init, step = build_tracker_fns("bytetrack", device=cuda)
    runner = MultiStreamRunner(init, step, 256, device=cuda)
    outs, out_masks = runner.run(torch.cat([k[0] for k in kept]),
                                 torch.cat([k[1] for k in kept]))
    assert same_bits(out_masks, torch.cat([k[3] for k in kept]))
    assert same_bits(outs, torch.cat([k[2] for k in kept]))
    assert all(same_bits(a, b) for a, b in zip(runner.states,
                                               report["states"]))


@pytest.mark.parametrize("tracker", ["bytetrack", "ocsort", "sort_obb"])
def test_rollout_on_the_card_equals_its_deterministic_run(cuda, tracker):
    """The rollout under torch.use_deterministic_algorithms(True), which
    raises on a nondeterministic operation without a deterministic form
    and swaps in the deterministic form of the others (scatters with
    repeated indices among them), emits the default run's tracks and
    state bit for bit."""
    from motcpp_tpu_torch.data import obb_stream_dets
    from motcpp_tpu_torch.models.sort import SortConfig, make_sort
    from motcpp_tpu_torch.scripts.tracker_fns import build_tracker_fns

    S, K, N, T = 256, 64, 32, 60
    if tracker == "sort_obb":
        dets, masks = obb_stream_dets(np.random.default_rng(0), T, S, N)
        init, step = make_sort(SortConfig(
            is_obb=True, min_hits=1, max_age=3, max_tracks=K, max_dets=N,
            lap_impl="auction_pallas"), device=cuda)
    else:
        dets, masks = synth_stream_dets(np.random.default_rng(0), T, S, N)
        init, step = build_tracker_fns(tracker, K, N, device=cuda)
    dets, masks = torch.from_numpy(dets).to(cuda), torch.from_numpy(
        masks).to(cuda)
    runs = []
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic)
        try:
            runner = MultiStreamRunner(init, step, S, device=cuda)
            runs.append((*runner.run(dets, masks), runner.states))
        finally:
            torch.use_deterministic_algorithms(False)
    (o1, m1, s1), (o2, m2, s2) = runs
    assert int(m1.sum()) > 0
    assert same_bits(m1, m2) and same_bits(o1, o2)
    assert all(same_bits(a, b) for a, b in zip(s1, s2))


def test_scoreboard_row_on_the_card_equals_the_hosts_plain_auction(cuda):
    """ByteTrack's ablation scoreboard row at 150 frames on the card
    through the auction kernel: the metrics of the same row on the host
    through the plain auction, one kernel launch a stage a frame."""
    from motcpp_tpu_torch.scripts import ablation_benchmark as tool

    before = auction_cuda.LAUNCHES
    card = tool.run_scoreboard(150, ["bytetrack"], progress=len,
                               device=cuda, lap_impl="auction_pallas")
    assert auction_cuda.LAUNCHES - before == 2 * 150
    host = tool.run_scoreboard(150, ["bytetrack"], progress=len,
                               device="cpu", lap_impl="auction")
    assert card == host


def test_ablation_tool_runs_on_the_card_through_the_kernel(cuda, capsys):
    from motcpp_tpu_torch.scripts import ablation_benchmark as tool

    before = auction_cuda.LAUNCHES
    assert tool.main(["--frames", "150", "--trackers", "sort",
                      "--lap", "auction_pallas"]) == 0
    assert auction_cuda.LAUNCHES - before == 150
    assert capsys.readouterr().out.startswith("sort ")


def test_synthetic_benchmark_row_on_the_card_equals_the_hosts_plain_auction(
        cuda):
    """ByteTrack's synthetic-benchmark row at 100 frames on the card
    through the auction kernel: the metrics of the same row on the host
    through the plain auction, one kernel launch a stage a frame."""
    from motcpp_tpu_torch.scripts import synthetic_benchmark as tool

    before = auction_cuda.LAUNCHES
    card = tool.run_table(100, trackers=["bytetrack"], lap="auction_pallas",
                          device=cuda)
    assert auction_cuda.LAUNCHES - before == 2 * 100
    host = tool.run_table(100, trackers=["bytetrack"], lap="auction",
                          device="cpu")
    for table in (card, host):
        del table["bytetrack"]["seconds"]
    assert card == host


@pytest.mark.parametrize("tracker,probe", [
    ("ucmctrack", {}), ("deepocsort", {}), ("botsort", {}),
    ("boosttrack", {}), ("hybridsort", {}),
    ("strongsort", {"emb_budget": 0.6})])
def test_scoreboard_row_on_the_card_equals_its_deterministic_run(
        cuda, tracker, probe, monkeypatch):
    """A scoreboard row at 150 frames under
    torch.use_deterministic_algorithms(True) emits the default run's rows
    bit for bit: no step of these trackers writes through a scatter whose
    winner the card leaves open (ByteTrack, OC-SORT and OBB SORT are held
    above)."""
    import motcpp_tpu_torch
    from motcpp_tpu_torch.scripts import ablation_benchmark as tool

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    create = motcpp_tpu_torch.create_tracker
    runs = []
    for deterministic in (False, True):
        outs = []

        def recording(model, **kw):
            tracker = create(model, **kw)
            update = tracker.update

            def recorded(*args, **kwargs):
                outs.append(update(*args, **kwargs))
                return outs[-1]

            tracker.update = recorded
            return tracker

        monkeypatch.setattr(motcpp_tpu_torch, "create_tracker", recording)
        torch.use_deterministic_algorithms(deterministic)
        try:
            metrics = tool.run_scoreboard(150, [tracker], progress=len,
                                          device=cuda,
                                          lap_impl="auction_pallas", **probe)
        finally:
            torch.use_deterministic_algorithms(False)
        runs.append((metrics, outs))
    (m1, o1), (m2, o2) = runs
    assert m1 == m2 and len(o1) == len(o2) == 150
    assert all(a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))
               for a, b in zip(o1, o2))


def test_multistream_example_on_the_card_launches_the_kernel(cuda, capsys):
    """The multistream_tpu example at 8 streams and 5 frames through the
    auction kernel: two launches a frame (ByteTrack's stage 1 and stages
    2+3), and the lines of its --cpu run (the plain auction)."""
    from motcpp_tpu_torch.examples import multistream_tpu

    argv = ["--streams", "8", "--frames", "5", "--lap", "auction_pallas"]
    before = auction_cuda.LAUNCHES
    assert multistream_tpu.main(argv) == 0
    assert auction_cuda.LAUNCHES - before == 2 * 5
    card = capsys.readouterr().out
    assert multistream_tpu.main(argv + ["--cpu"]) == 0
    assert card == capsys.readouterr().out
    assert "160 track emissions" in card
