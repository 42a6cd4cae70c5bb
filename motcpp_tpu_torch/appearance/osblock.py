"""One OSNet OSBlock as one kernel launch, and the OSNet forward built on it.

Counterpart of ``motcpp_tpu/appearance/osblock_pallas.py``. The kernel
(``csrc/osblock.cu``, wrapper ``appearance/osblock_cuda.py``) replaces the
TPU kernel ``_osblock_kernel``; :func:`osblock_reference` is its plain
PyTorch version, rounding intermediates to the compute dtype where the
TPU kernel rounds them: after each 1x1 conv and each lite, with the gate
sum in float32 and the residual add in the compute dtype.

:func:`osblock_fused` launches the kernel for CUDA tensors and runs the
plain version only for tensors on the CPU. :func:`forward_fused` is the
whole network; conv1, maxpool, the two transitions with avgpool, conv5
and the fc head stay plain PyTorch, as the JAX package leaves them to
XLA. The kernel takes any batch size, so there is no batch tile.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from motcpp_tpu_torch.appearance.quant import _conv, avg_pool_2x2, max_pool_3x3_s2

# lite-conv stream layout of an OSBlock: chain of lite convs per stream
STREAMS = (
    ("conv2a",),
    ("conv2b_0", "conv2b_1"),
    ("conv2c_0", "conv2c_1", "conv2c_2"),
    ("conv2d_0", "conv2d_1", "conv2d_2", "conv2d_3"),
)
LITE_NAMES = tuple(n for chain in STREAMS for n in chain)
BLOCKS = ("conv2_0", "conv2_1", "conv3_0", "conv3_1", "conv4_0", "conv4_1")


class BlockWeights(NamedTuple):
    """One block's folded weights packed for the kernel, and the folded
    tree and block name that its plain version reads."""

    name: str
    folded: dict
    mats: torch.Tensor  # 1x1 kernels and dw taps, compute dtype, flat
    biases: torch.Tensor  # float32, flat
    cin: int
    mid: int
    cout: int
    hidden: int
    has_ds: bool


def block_weights(folded: dict, name: str, dtype) -> BlockWeights:
    """Pack block ``name`` of a fold_osnet tree for the kernel, on the
    tree's device. Order (``csrc/osblock.cu``'s Layout):

      mats:   conv1 (cin, mid), 10x [lite conv1 (mid, mid), dw taps
              (9, mid)], gate fc1 (mid, hidden), fc2 (hidden, mid),
              conv3 (mid, cout), [downsample (cin, cout)]
      biases: conv1 (mid), 10x lite dw (mid), fc1 (hidden), fc2 (mid),
              conv3 (cout), [downsample (cout)]
    """

    def mat(k):
        return k.reshape(k.shape[-2], k.shape[-1]) if k.dim() == 4 else k

    conv1 = folded[f"{name}/conv1"]
    mats, biases = [mat(conv1["kernel"])], [conv1["bias"]]
    for ln in LITE_NAMES:
        pw = folded[f"{name}/{ln}/conv1"]["kernel"]
        dw = folded[f"{name}/{ln}/conv2"]
        mats += [mat(pw), dw["kernel"].reshape(9, -1)]
        biases.append(dw["bias"])
    for fc in ("fc1", "fc2"):
        leaf = folded[f"{name}/gate/{fc}"]
        mats.append(leaf["kernel"])
        biases.append(leaf["bias"])
    conv3 = folded[f"{name}/conv3"]
    mats.append(mat(conv3["kernel"]))
    biases.append(conv3["bias"])
    has_ds = f"{name}/downsample" in folded
    if has_ds:
        ds = folded[f"{name}/downsample"]
        mats.append(mat(ds["kernel"]))
        biases.append(ds["bias"])
    k1 = mats[0]
    return BlockWeights(
        name=name, folded=folded,
        mats=torch.cat([m.reshape(-1).to(dtype) for m in mats]).contiguous(),
        biases=torch.cat([b.reshape(-1).float() for b in biases]).contiguous(),
        cin=int(k1.shape[0]), mid=int(k1.shape[1]),
        cout=int(mats[-1].shape[1]),
        hidden=int(folded[f"{name}/gate/fc1"]["kernel"].shape[1]),
        has_ds=has_ds,
    )


def osblock_reference(folded: dict, name: str, x: torch.Tensor,
                      features: int) -> torch.Tensor:
    """One OSBlock in plain PyTorch, NHWC (B, H, W, Cin) -> (B, H, W,
    features) in ``x.dtype``, with weights cast to ``x.dtype``: 1x1 convs
    as float32 matrix products and the depthwise conv as 9 shifted
    float32 multiply-adds (``quant._conv``), rounded where
    ``_osblock_kernel`` rounds."""
    cdt = x.dtype

    def mat(k):
        k = k.reshape(k.shape[-2], k.shape[-1]) if k.dim() == 4 else k
        return k.to(cdt).float()

    def conv(v, leaf, relu, **kw):
        y = _conv(v, leaf["kernel"].to(cdt), leaf["bias"], **kw)
        return y.clamp_min(0.0) if relu else y

    def lite(v, ln):
        y = conv(v, folded[f"{name}/{ln}/conv1"], relu=False)
        return conv(y, folded[f"{name}/{ln}/conv2"], relu=True, padding=1,
                    groups=y.shape[-1])

    fc1 = folded[f"{name}/gate/fc1"]
    fc2 = folded[f"{name}/gate/fc2"]

    def gate(v):
        s = v.float().mean(dim=(1, 2)).to(cdt).float()
        s = (s @ mat(fc1["kernel"]) + fc1["bias"].float()).clamp_min(0.0)
        s = torch.sigmoid(s.to(cdt).float() @ mat(fc2["kernel"])
                          + fc2["bias"].float())
        return v.float() * s[:, None, None, :]

    x1 = conv(x, folded[f"{name}/conv1"], relu=True)
    acc = None
    for chain in STREAMS:
        v = x1
        for ln in chain:
            v = lite(v, ln)
        g = gate(v)
        acc = g if acc is None else acc + g
    x3 = conv(acc.to(cdt), folded[f"{name}/conv3"], relu=False)
    if f"{name}/downsample" in folded:
        ident = conv(x, folded[f"{name}/downsample"], relu=False)
    else:
        ident = x
    if x3.shape[-1] != features:
        raise ValueError(f"block {name} gives {x3.shape[-1]} channels, "
                         f"not {features}")
    return (x3.float() + ident.float()).clamp_min(0.0).to(cdt)


def osblock_fused(weights: BlockWeights, x: torch.Tensor) -> torch.Tensor:
    """One OSBlock over x (B, H, W, Cin): the CUDA kernel for a tensor on
    a CUDA device (it launches or raises), the plain version for a tensor
    on the CPU."""
    if x.device.type == "cpu":
        return osblock_reference(weights.folded, weights.name, x, weights.cout)
    if x.device.type != "cuda":
        raise ValueError(f"no OSBlock kernel for device {x.device}")
    from motcpp_tpu_torch.appearance import osblock_cuda

    return osblock_cuda.osblock(weights, x)


def pack_blocks(folded: dict, dtype) -> dict:
    """``{block name: BlockWeights}`` for the six OSBlocks."""
    return {name: block_weights(folded, name, dtype) for name in BLOCKS}


def fused_pieces(folded: dict, packed: dict) -> list:
    """:func:`forward_fused`'s sequential pieces in order, as ``(name,
    fn)``: conv1 7x7/2, the 3x3/2 max pool, each OSBlock through
    :func:`osblock_fused`, the two transitions (1x1 conv, 2x2 average
    pool), conv5 with its spatial mean, and the ``fc_0`` head. Chained on
    x (B, H, W, 3), they are the forward; ``scripts/profile_osnet.py``
    times each alone. ``packed`` is :func:`pack_blocks` of ``folded``."""

    def conv(name, v, strides=(1, 1), padding=0):
        leaf = folded[name]
        return torch.relu(_conv(v, leaf["kernel"], leaf["bias"], strides,
                                padding))

    def block(name):
        return name, lambda v: osblock_fused(packed[name], v)

    def transition(name):
        return name, lambda v: avg_pool_2x2(conv(name, v))

    def head(v):
        leaf = folded["fc_0"]
        return torch.relu(v @ leaf["kernel"].float() + leaf["bias"].float())

    return [
        ("conv1", lambda v: conv("conv1", v, strides=(2, 2), padding=3)),
        ("maxpool", max_pool_3x3_s2),
        block("conv2_0"), block("conv2_1"), transition("conv2_2_0"),
        block("conv3_0"), block("conv3_1"), transition("conv3_2_0"),
        block("conv4_0"), block("conv4_1"),
        ("conv5", lambda v: conv("conv5", v).float().mean(dim=(1, 2))),
        ("fc_0", head),
    ]


def forward_fused(folded: dict, x: torch.Tensor, packed: dict | None = None):
    """OSNet forward with every OSBlock through :func:`osblock_fused`:
    :func:`fused_pieces` chained.

    folded: a fold_osnet tree (on x's device); x: (B, H, W, 3), compute
    dtype = x.dtype; packed: :func:`pack_blocks` of the tree in that
    dtype, packed here when not given. Returns (B, D) float32.
    """
    if packed is None:
        packed = pack_blocks(folded, x.dtype)
    for _, piece in fused_pieces(folded, packed):
        x = piece(x)
    return x
