"""The CUDA kernels of motcpp_tpu_torch against their plain PyTorch
versions, on a CUDA device. They skip where there is none.

This file imports no JAX, so it also runs where JAX is not installed,
without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from motcpp_tpu_torch.data import synth_stream_dets
from motcpp_tpu_torch.models.bytetrack import ByteTrackConfig, make_bytetrack
from motcpp_tpu_torch.ops import auction, auction_cuda
from motcpp_tpu_torch.parallel.streams import MultiStreamRunner


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


@pytest.mark.parametrize("shape", [(512, 64, 32), (64, 128, 64),
                                   (64, 128, 128), (32, 256, 128), (3, 1, 1)])
def test_auction_kernel_matches_plain_version(cuda, shape):
    args = problems(sum(shape), *shape)
    want = auction.solve_lap_auction(*args)
    before = auction_cuda.LAUNCHES
    got = auction_cuda.solve(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert auction_cuda.LAUNCHES == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


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
