"""BN folding and the folded OSNet forward.

Counterpart of the float half of ``motcpp_tpu/appearance/quant.py``:
every Conv+BN pair of an OSNet is folded into one conv kernel and bias
(inference-only algebra, w' = w * gamma / sqrt(var + eps),
b' = beta - mean * gamma / sqrt(var + eps)), giving the tree that the
OSBlock kernel reads. The tree keeps the JAX package's names
(``conv2_0/conv2b_1/conv2``) and layouts (HWIO kernels, Dense
``(in, out)``), so the port's and the JAX package's folded trees compare
leaf by leaf. The int8 and dense-lite parts are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from motcpp_tpu_torch.appearance.osnet import (
    ChannelGate,
    ConvLayer,
    LightConv3x3,
    OSNet,
)

BN_EPS = 1e-5  # torch's and flax's BatchNorm default


def _fold_conv_bn(kernel_hwio: torch.Tensor, bn) -> tuple:
    """Fold BN ``bn`` (a BatchNorm module) into an HWIO kernel; returns
    (kernel, bias) in float32."""
    f = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    kernel = kernel_hwio * f
    bias = bn.bias - bn.running_mean * f
    return kernel.float(), bias.float()


def _hwio(conv_weight: torch.Tensor) -> torch.Tensor:
    return conv_weight.permute(2, 3, 1, 0)  # OIHW -> HWIO


def _flax_name(torch_path: str) -> str:
    """``conv2.0.conv2b.1`` -> ``conv2_0/conv2b_1``."""
    mods: list[str] = []
    for c in torch_path.split("."):
        if c.isdigit() and mods:
            mods[-1] = f"{mods[-1]}_{c}"
        else:
            mods.append(c)
    return "/".join(mods)


@torch.no_grad()
def fold_osnet(model: OSNet) -> dict:
    """``{"<path>": {"kernel", "bias"}}`` for every conv of ``model``
    with its BN folded in, the gate's Dense pairs as they are, and the
    head's Linear with its BN1d folded in (as ``fc_0``)."""
    out: dict = {}
    for path, mod in model.named_modules():
        name = _flax_name(path)
        if isinstance(mod, ConvLayer):
            k, b = _fold_conv_bn(_hwio(mod.conv.weight), mod.bn)
            out[name] = {"kernel": k, "bias": b}
        elif isinstance(mod, LightConv3x3):
            k1 = _hwio(mod.conv1.weight).float()
            out[f"{name}/conv1"] = {
                "kernel": k1, "bias": torch.zeros(k1.shape[-1])}
            k, b = _fold_conv_bn(_hwio(mod.conv2.weight), mod.bn)
            out[f"{name}/conv2"] = {"kernel": k, "bias": b}
        elif isinstance(mod, ChannelGate):
            for fc in ("fc1", "fc2"):
                lin = getattr(mod, fc)
                out[f"{name}/{fc}"] = {
                    "kernel": lin.weight[:, :, 0, 0].T.float(),
                    "bias": lin.bias.float()}
    lin, bn = model.fc[0], model.fc[1]
    k, b = _fold_conv_bn(lin.weight.T, bn)
    f = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    out["fc_0"] = {"kernel": k, "bias": (lin.bias * f + b).float()}
    return {n: {k: v.detach().clone().contiguous() for k, v in leaf.items()}
            for n, leaf in out.items()}


def _conv(x, kernel, bias, strides=(1, 1), padding=0, groups=1):
    """NHWC conv with an HWIO kernel: products and sums in float32, bias
    added in float32, the result carried in ``x.dtype``. 1x1 convs are
    matrix products; a 3x3 depthwise conv (groups = channels) is 9
    shifted multiply-adds; anything else is ``F.conv2d``."""
    kh, kw, _, cout = kernel.shape
    xf = x.float()
    if kh == kw == 1 and groups == 1 and strides == (1, 1):
        y = xf.reshape(-1, xf.shape[-1]) @ kernel.reshape(-1, cout).float()
        y = y.reshape(*x.shape[:-1], cout)
    elif kh == kw == 3 and groups == cout and strides == (1, 1):
        H, W = x.shape[1:3]
        xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
        k = kernel.float()
        y = None
        for i in range(3):
            for j in range(3):
                term = xp[:, i:i + H, j:j + W, :] * k[i, j, 0, :]
                y = term if y is None else y + term
    else:
        y = F.conv2d(xf.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).float(),
                     stride=strides, padding=padding, groups=groups)
        y = y.permute(0, 2, 3, 1)
    return (y + bias.float()).to(x.dtype)


def _infer_channels(folded):
    return (
        folded["conv1"]["kernel"].shape[-1],
        folded["conv2_2_0"]["kernel"].shape[-1],
        folded["conv3_2_0"]["kernel"].shape[-1],
        folded["conv5"]["kernel"].shape[-1],
    )


def max_pool_3x3_s2(x):
    """NHWC 3x3 stride-2 max pool with padding 1 (padding never wins)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def avg_pool_2x2(x):
    """NHWC 2x2 stride-2 average pool."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _forward_folded(folded, x):
    """OSNet forward over the folded tree, NHWC, activations carried in
    ``x.dtype``; mirrors ``appearance/osnet.py::OSNet.forward``."""

    def conv(name, v, strides=(1, 1), padding=0, groups=1, relu=True):
        leaf = folded[name]
        y = _conv(v, leaf["kernel"], leaf["bias"], strides, padding, groups)
        return torch.relu(y) if relu else y

    def lite(name, v):
        v = conv(f"{name}/conv1", v, relu=False)
        c = folded[f"{name}/conv2"]["kernel"].shape[-1]
        return conv(f"{name}/conv2", v, padding=1, groups=c)

    def gate(name, v):
        s = v.mean(dim=(1, 2))
        l1, l2 = folded[f"{name}/fc1"], folded[f"{name}/fc2"]
        s = torch.relu(s @ l1["kernel"].to(s.dtype) + l1["bias"].to(s.dtype))
        s = torch.sigmoid(s @ l2["kernel"].to(s.dtype) + l2["bias"].to(s.dtype))
        return v * s[:, None, None, :]

    def osblock(name, v, features):
        x1 = conv(f"{name}/conv1", v)
        x2 = None
        for chain in (("conv2a",), ("conv2b_0", "conv2b_1"),
                      ("conv2c_0", "conv2c_1", "conv2c_2"),
                      ("conv2d_0", "conv2d_1", "conv2d_2", "conv2d_3")):
            s = x1
            for ln in chain:
                s = lite(f"{name}/{ln}", s)
            g = gate(f"{name}/gate", s)
            x2 = g if x2 is None else x2 + g
        x3 = conv(f"{name}/conv3", x2, relu=False)
        if v.shape[-1] != features:
            v = conv(f"{name}/downsample", v, relu=False)
        return torch.relu(x3 + v)

    _, c2, c3, c4 = _infer_channels(folded)
    x = conv("conv1", x, strides=(2, 2), padding=3)
    x = max_pool_3x3_s2(x)
    x = osblock("conv2_0", x, c2)
    x = osblock("conv2_1", x, c2)
    x = avg_pool_2x2(conv("conv2_2_0", x))
    x = osblock("conv3_0", x, c3)
    x = osblock("conv3_1", x, c3)
    x = avg_pool_2x2(conv("conv3_2_0", x))
    x = osblock("conv4_0", x, c4)
    x = osblock("conv4_1", x, c4)
    x = conv("conv5", x)
    x = x.mean(dim=(1, 2))
    head = folded["fc_0"]
    return torch.relu(x @ head["kernel"].to(x.dtype) + head["bias"].to(x.dtype))


def forward_folded_f32(folded, x):
    """Float32 forward over the folded tree (the parity target)."""
    return _forward_folded(folded, x.float())
