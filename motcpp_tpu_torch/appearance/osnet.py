"""OSNet (Omni-Scale Network) for person re-identification, in PyTorch.

Counterpart of ``motcpp_tpu/appearance/osnet.py`` (public architecture:
Zhou et al., "Omni-Scale Feature Learning for Person Re-Identification",
ICCV 2019):

  conv1 7x7/2 + maxpool -> 3 stages of omni-scale residual blocks whose
  parallel depthwise-separable streams (receptive fields 3..9) are fused
  by a shared channel-attention gate -> 1x1 conv -> global average pool
  -> fc (Linear+BN+ReLU) -> 512-d embedding.

Modules are named as in torchreid (``conv1.conv``, ``conv2.0.conv2b.1.bn``,
``conv2.0.gate.fc1``, ``fc.0`` ...), so a torchreid ``state_dict`` loads
as it is, and :func:`state_dict_from_flax` carries the JAX package's
Flax variables across by name. ``forward`` takes NHWC crops, as the Flax
model does. The 3x3 depthwise convolutions run as 9 shifted
multiply-adds over the zero-padded map (the JAX package's
``DepthwiseShift3x3`` schedule), not as a grouped convolution.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

GATE_REDUCTION = 16


def depthwise3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 zero-padded depthwise conv of NCHW ``x`` with a
    (C, 1, 3, 3) weight, as 9 shifted multiply-adds in tap order."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    out = None
    for i in range(3):
        for j in range(3):
            term = xp[:, :, i:i + H, j:j + W] * weight[:, 0, i, j][:, None, None]
            out = term if out is None else out + term
    return out


class ConvLayer(nn.Module):
    """torchreid ConvLayer / Conv1x1 / Conv1x1Linear: conv, BN, optional
    ReLU."""

    def __init__(self, cin, cout, k=1, stride=1, padding=0, relu=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class LightConv3x3(nn.Module):
    """torchreid LightConv3x3: 1x1 pointwise, 3x3 depthwise, BN, ReLU."""

    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 1, bias=False)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, groups=c, bias=False)
        self.bn = nn.BatchNorm2d(c)

    def forward(self, x):
        return F.relu(self.bn(depthwise3x3(self.conv1(x), self.conv2.weight)))


class ChannelGate(nn.Module):
    """torchreid ChannelGate: one channel attention shared by the four
    streams; fc1 and fc2 are 1x1 convolutions over the pooled vector."""

    def __init__(self, c):
        super().__init__()
        self.fc1 = nn.Conv2d(c, c // GATE_REDUCTION, 1)
        self.fc2 = nn.Conv2d(c // GATE_REDUCTION, c, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s


class OSBlock(nn.Module):
    """Omni-scale residual block: four lite streams of depth 1..4 from a
    shared 1x1 bottleneck, fused by one shared channel gate."""

    def __init__(self, cin, cout, bottleneck_reduction=4):
        super().__init__()
        mid = cout // bottleneck_reduction
        self.conv1 = ConvLayer(cin, mid)
        self.conv2a = LightConv3x3(mid)
        self.conv2b = nn.Sequential(*(LightConv3x3(mid) for _ in range(2)))
        self.conv2c = nn.Sequential(*(LightConv3x3(mid) for _ in range(3)))
        self.conv2d = nn.Sequential(*(LightConv3x3(mid) for _ in range(4)))
        self.gate = ChannelGate(mid)
        self.conv3 = ConvLayer(mid, cout, relu=False)
        self.downsample = (ConvLayer(cin, cout, relu=False)
                           if cin != cout else None)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = (self.gate(self.conv2a(x1)) + self.gate(self.conv2b(x1))
              + self.gate(self.conv2c(x1)) + self.gate(self.conv2d(x1)))
        x3 = self.conv3(x2)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(x3 + identity)


class OSNet(nn.Module):
    """OSNet backbone and embedding head; ``channels`` are the stage
    widths (osnet_x1_0: (64, 256, 384, 512)). Padding is torch's (conv1
    pad 3, maxpool pad 1), as in the Flax model."""

    def __init__(self, channels=(64, 256, 384, 512), feature_dim=512):
        super().__init__()
        self.channels = tuple(int(c) for c in channels)
        self.feature_dim = int(feature_dim)
        c1, c2, c3, c4 = self.channels
        self.conv1 = ConvLayer(3, c1, 7, stride=2, padding=3)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.conv2 = nn.Sequential(
            OSBlock(c1, c2), OSBlock(c2, c2),
            nn.Sequential(ConvLayer(c2, c2), nn.AvgPool2d(2, stride=2)))
        self.conv3 = nn.Sequential(
            OSBlock(c2, c3), OSBlock(c3, c3),
            nn.Sequential(ConvLayer(c3, c3), nn.AvgPool2d(2, stride=2)))
        self.conv4 = nn.Sequential(OSBlock(c3, c4), OSBlock(c4, c4))
        self.conv5 = ConvLayer(c4, c4)
        self.fc = nn.Sequential(nn.Linear(c4, feature_dim),
                                nn.BatchNorm1d(feature_dim), nn.ReLU())
        self.eval()

    def forward(self, x):
        """x (B, H, W, 3) NHWC -> (B, feature_dim)."""
        x = self.maxpool(self.conv1(x.permute(0, 3, 1, 2)))
        x = self.conv5(self.conv4(self.conv3(self.conv2(x))))
        return self.fc(x.mean(dim=(2, 3)))


def osnet_x1_0(feature_dim: int = 512) -> OSNet:
    return OSNet((64, 256, 384, 512), feature_dim)


def osnet_x0_75(feature_dim: int = 512) -> OSNet:
    return OSNet((48, 192, 288, 384), feature_dim)


def osnet_x0_5(feature_dim: int = 512) -> OSNet:
    return OSNet((32, 128, 192, 256), feature_dim)


def osnet_x0_25(feature_dim: int = 512) -> OSNet:
    return OSNet((16, 64, 96, 128), feature_dim)


# crops of the training-mode pass that sets init_params' BN statistics
BN_STATS_CROPS = (4, 256, 128)


@torch.no_grad()
def init_params(model: OSNet, seed: int = 0) -> OSNet:
    """Random weights from ``seed`` (an explicit ``torch.Generator`` on
    the CPU): He-scaled conv and linear weights, BN gamma in U(0.8, 1.2),
    small biases and betas. Unlike the JAX package's ``init_params``,
    which leaves the BN running statistics at mean 0 and variance 1, it
    then sets them to those of one training-mode pass over
    ``BN_STATS_CROPS`` random crops, as training leaves them, so
    activations stay of order one through depth and embeddings stay
    input-dependent. Returns ``model`` in eval mode."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            fan_in = p[0].numel()
            v = torch.randn(p.shape, generator=gen) * (2.0 / fan_in) ** 0.5
        elif name.endswith("bn.weight") or name.endswith("fc.1.weight"):
            v = torch.empty(p.shape).uniform_(0.8, 1.2, generator=gen)
        else:
            v = torch.randn(p.shape, generator=gen) * 0.1
        p.copy_(v)
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = 1.0  # running stats := this pass's batch stats
    model.train()
    model(torch.rand((*BN_STATS_CROPS, 3), generator=gen) * 4.0 - 2.0)
    for m in bns:
        m.momentum = 0.1
    return model.eval()


# ------------------------------------------------------------ weights
def infer_osnet(state_dict) -> OSNet:
    """The OSNet variant (stage widths, feature dim) that a torchreid-
    layout state_dict describes, with fresh weights."""
    try:
        channels = tuple(int(state_dict[k].shape[0]) for k in (
            "conv1.conv.weight", "conv2.2.0.conv.weight",
            "conv3.2.0.conv.weight", "conv5.conv.weight"))
        feature_dim = int(state_dict["fc.0.weight"].shape[0])
    except KeyError as e:
        raise ValueError(f"state_dict is not an OSNet layout (missing {e})") from e
    return OSNet(channels, feature_dim)


def _load_checked(model: OSNet, state_dict) -> OSNet:
    """Load ``state_dict`` into ``model``, raising ValueError listing
    every missing, unexpected or mis-shaped tensor (the BN batch
    counters and the training classifier are not needed)."""
    want = {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    got = {k: v for k, v in state_dict.items()
           if not k.endswith("num_batches_tracked")
           and not k.startswith("classifier.")}
    errors = [f"missing: {k}" for k in sorted(set(want) - set(got))]
    errors += [f"unexpected: {k}" for k in sorted(set(got) - set(want))]
    errors += [
        f"shape mismatch at {k}: {tuple(got[k].shape)} vs model "
        f"{tuple(want[k].shape)}"
        for k in sorted(set(want) & set(got))
        if tuple(got[k].shape) != tuple(want[k].shape)
    ]
    if errors:
        raise ValueError("weights do not map onto this OSNet:\n  "
                         + "\n  ".join(errors[:20]))
    model.load_state_dict(
        {k: torch.as_tensor(v, dtype=want[k].dtype) for k, v in got.items()},
        strict=False)
    return model


def _torch_key(flax_path) -> str:
    """Flax module path -> torch module path: ``conv2_0/conv2b_1`` ->
    ``conv2.0.conv2b.1`` (numeric suffixes become Sequential indices)."""
    return ".".join(part.replace("_", ".") for part in flax_path)


def state_dict_from_flax(variables) -> dict:
    """The JAX package's OSNet variables (``{"params", "batch_stats"}``
    of numpy or jax arrays) as this module's state_dict, by name: the
    inverse of ``motcpp_tpu/appearance/osnet.py::convert_torch_state_dict``.
    Raises ValueError on any missing, extra or mis-shaped tensor."""
    out = {}

    def walk(tree, path, coll):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, path + (k,), coll)
                continue
            arr = np.asarray(v, np.float32)
            mod = _torch_key(path)
            if coll == "batch_stats":
                name = {"mean": "running_mean", "var": "running_var"}[k]
            elif k == "scale":
                name = "weight"
            elif k == "bias":
                name = "bias"
            elif k == "kernel" and arr.ndim == 4:  # HWIO -> OIHW
                name, arr = "weight", np.transpose(arr, (3, 2, 0, 1))
            elif k == "kernel" and path[-1] in ("fc1", "fc2"):
                name, arr = "weight", arr.T[:, :, None, None]
            elif k == "kernel":  # Dense -> Linear
                name, arr = "weight", arr.T
            else:
                raise ValueError(f"unhandled variable {coll}/{'/'.join(path + (k,))}")
            out[f"{mod}.{name}"] = torch.tensor(arr)

    for coll in ("params", "batch_stats"):
        walk(variables.get(coll, {}), (), coll)
    model = infer_osnet(out)
    return _load_checked(model, out).state_dict()


def load_npz_variables(path) -> dict:
    """A flat ``.npz`` of Flax variables ('params/conv1/conv/kernel'
    keys, the output of scripts/convert_reid_weights.py) as a nested
    dict of numpy arrays."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = out
            for m in parts[:-1]:
                node = node.setdefault(m, {})
            node[parts[-1]] = data[key]
    return out


def load_weights_auto(path) -> OSNet:
    """An OSNet with weights from a torchreid checkpoint (.pt/.pth) or a
    ``.npz`` of converted Flax variables; the variant is inferred from
    the tensors, and every tensor is checked by name and shape."""
    p = str(path)
    if p.endswith((".pt", ".pth")):
        sd = torch.load(p, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        # DataParallel checkpoints carry a "module." prefix
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    elif p.endswith(".npz"):
        sd = state_dict_from_flax(load_npz_variables(Path(p)))
    else:
        raise ValueError(
            f"unrecognized ReID weights format: {path!r} (expected a "
            ".pt/.pth torchreid checkpoint or a .npz of converted variables)"
        )
    return _load_checked(infer_osnet(sd), sd)
