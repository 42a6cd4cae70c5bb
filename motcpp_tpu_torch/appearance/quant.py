"""BN folding, the folded OSNet forward, and its int8 and dense-lite forms.

Counterpart of ``motcpp_tpu/appearance/quant.py``:

  * every Conv+BN pair of an OSNet is folded into one conv kernel and
    bias (inference-only algebra, w' = w * gamma / sqrt(var + eps),
    b' = beta - mean * gamma / sqrt(var + eps)), giving the tree that the
    OSBlock kernel reads. The tree keeps the JAX package's names
    (``conv2_0/conv2b_1/conv2``) and layouts (HWIO kernels, Dense
    ``(in, out)``), so the port's and the JAX package's folded trees
    compare leaf by leaf;
  * int8: weights symmetric int8 per output channel, activations
    symmetric int8 per tensor with static scales from one calibration
    pass (the 99.9th percentile of each conv's |input|); the stem's 7x7
    conv, every 1x1 conv and the head run int8 x int8 with int32 sums
    (``ops/int8.py``: ``torch._int_mm`` on the card), dequantized to the
    activation dtype; the 3x3 depthwise convs stay float on the folded
    weights;
  * dense-lite: each 1x1 -> 3x3 depthwise pair composed into one dense
    3x3 conv (exact algebra; no embed function uses it).

Usage:
    qvars = quantize_osnet(model)                   # on the CPU
    embed = make_embed_fn_int8(model, device="cuda")  # crops -> (B, D)
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from motcpp_tpu_torch.appearance.osnet import (
    ChannelGate,
    ConvLayer,
    LightConv3x3,
    OSNet,
)
from motcpp_tpu_torch.device import PerDevice, resolve_device
from motcpp_tpu_torch.ops import int8

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


def _forward_folded(tree, x, qget=None, dense=False):
    """OSNet forward over the folded tree (or, with ``dense``, a
    :func:`compose_lite_dense` tree), NHWC, activations carried in
    ``x.dtype``; mirrors ``appearance/osnet.py::OSNet.forward``.
    ``qget(name, x, strides, padding, groups)``: when given, every conv
    (``padding`` an int, as ``F.conv2d`` takes it) and the head
    (``strides`` and ``padding`` None) go through it in place of the
    float conv."""

    def conv(name, v, strides=(1, 1), padding=0, groups=1, relu=True):
        if qget is not None:
            y = qget(name, v, strides, padding, groups)
        else:
            leaf = tree[name]
            y = _conv(v, leaf["kernel"], leaf["bias"], strides, padding,
                      groups)
        return torch.relu(y) if relu else y

    def lite(name, v):
        if dense:
            return conv(name, v, padding=1)
        v = conv(f"{name}/conv1", v, relu=False)
        c = tree[f"{name}/conv2"]["kernel"].shape[-1]
        return conv(f"{name}/conv2", v, padding=1, groups=c)

    def gate(name, v):
        # jnp's promotion: a bf16 mean against the int8 forward's float32
        # Dense kernels runs in float32, and so does ``v * s`` and every
        # layer after it; a tree cast to bf16 stays in bf16
        s = v.mean(dim=(1, 2))
        l1, l2 = tree[f"{name}/fc1"], tree[f"{name}/fc2"]
        dt = torch.promote_types(s.dtype, l1["kernel"].dtype)
        s = torch.relu(s.to(dt) @ l1["kernel"].to(dt) + l1["bias"].to(dt))
        s = torch.sigmoid(s @ l2["kernel"].to(dt) + l2["bias"].to(dt))
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

    _, c2, c3, c4 = _infer_channels(tree)
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
    if qget is not None:
        return torch.relu(qget("fc_0", x, None, None, 1))
    head = tree["fc_0"]
    return torch.relu(x @ head["kernel"].to(x.dtype) + head["bias"].to(x.dtype))


def forward_folded_f32(folded, x):
    """Float32 forward over the folded tree (the parity target)."""
    return _forward_folded(folded, x.float())


# ------------------------------------------------------------ dense-lite
def _lite_bases(folded) -> set:
    """The LightConv3x3s of a folded tree: ``<block>/<lite>`` of each
    1x1 (``/conv1``) -> 3x3 depthwise (``/conv2``) pair."""
    return {name[:-6] for name in folded
            if name.endswith("/conv1") and f"{name[:-6]}/conv2" in folded}


def compose_lite_dense(folded) -> dict:
    """Every LightConv3x3 (1x1 pointwise -> 3x3 depthwise) of a folded
    tree composed into ONE dense 3x3 conv with the rank-1-per-channel
    kernel ``K[t, i, c] = kdw_c[t] * W1[i, c]`` (exact algebra: the
    depthwise is per channel, the pointwise mixes channels, and no
    nonlinearity sits between them). Returns ``{"<block>/<lite>":
    {"kernel" (3, 3, Cin, C) float32, "bias"}}`` for the lite pairs and
    every other entry unchanged. On a TPU the JAX package measured it
    slower than the folded forward (9x the products, no memory pass
    saved); it is kept as that experiment's record."""
    lites = _lite_bases(folded)
    out = {}
    for name, leaf in folded.items():
        base = name.rsplit("/", 1)[0]
        if base not in lites:
            out[name] = leaf
        elif name.endswith("/conv2"):
            w1 = folded[f"{base}/conv1"]["kernel"]  # (1, 1, Cin, C)
            kdw = leaf["kernel"]  # (3, 3, 1, C)
            k = w1[0, 0][None, None, :, :] * kdw[:, :, 0, :][:, :, None, :]
            out[base] = {"kernel": k.float(), "bias": leaf["bias"]}
    return out


def _forward_folded_dense(composed, x, qget=None):
    """Forward over a :func:`compose_lite_dense` tree: the structure of
    :func:`_forward_folded` with each lite ONE dense 3x3 conv."""
    return _forward_folded(composed, x, qget, dense=True)


# ---------------------------------------------------------- quantization
def _quantize_weight(kernel):
    """Per-output-channel symmetric int8 of ``kernel (..., cout)``:
    (int8 kernel, float32 scale (cout,)); ``torch.round`` rounds half to
    even, as ``jnp.round``."""
    amax = kernel.reshape(-1, kernel.shape[-1]).abs().amax(0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _percentile(a, percentile):
    """``jnp.percentile(a, percentile)`` (its default linear method) in
    its float32 arithmetic: q = float32(percentile) / 100, the position
    q * (float32(n) - 1), its floor and ceiling, and
    ``low * (1 - w) + high * w`` with w the position's fraction. The two
    order statistics come from one ``topk`` (``torch.quantile`` refuses
    inputs above 2^24 elements)."""
    a = a.reshape(-1).float()
    n = a.numel()
    q = torch.tensor(percentile, dtype=torch.float32) / 100.0
    pos = q * (torch.tensor(n, dtype=torch.float32) - 1)
    lo_f, hi_f = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo_f
    w_lo = 1 - w_hi
    lo, hi = (int(torch.clamp(v, 0, n - 1)) for v in (lo_f, hi_f))
    top = torch.topk(a, n - lo, sorted=True).values  # sorted[lo:] descending
    low, high = top[-1], top[-1 - (hi - lo)]
    return low * w_lo + high * w_hi


@torch.no_grad()
def calibrate_osnet(folded, crops_f32, percentile: float = 99.9):
    """One calibration pass over PREPROCESSED float crops (normalized as
    ``make_embed_fn`` does): each conv's (and the head's) input scale,
    ``max(percentile(|x|) / 127, 1e-8)``, as ``{name: 0-d float32}``."""
    amaxes: dict = {}

    def qget(name, x, strides, padding, groups):
        a = _percentile(x.abs(), percentile)
        amaxes[name] = torch.maximum(amaxes[name], a) if name in amaxes else a
        leaf = folded[name]
        if strides is None:  # the head
            return x @ leaf["kernel"] + leaf["bias"]
        return _conv(x, leaf["kernel"], leaf["bias"], strides, padding, groups)

    _forward_folded(folded, crops_f32, qget=qget)
    return {k: torch.clamp_min(v / 127.0, 1e-8) for k, v in amaxes.items()}


#: the default calibration batch: (8, 256, 128, 3) draws of N(0, 1) from
#: np.random.default_rng(seed), as the JAX package's quantize_osnet makes
CALIB_SHAPE = (8, 256, 128, 3)


@torch.no_grad()
def quantize_osnet(model: OSNet, calib_crops=None, seed: int = 0) -> dict:
    """The int8 variables of ``model`` for :func:`forward_int8`, on the
    CPU (as the JAX package pins this step to the host, so the scales
    are the same on every machine): ``{"folded": fold_osnet's tree,
    "q": {name: {"kernel" int8 (HWIO or Dense (in, out)), "wscale"
    (cout,), "bias"}}, "act": {name: 0-d float32 input scale}}``.

    calib_crops: (B, H, W, 3) PREPROCESSED float crops for the activation
    scales; by default CALIB_SHAPE draws of N(0, 1) from ``seed``."""
    if any(p.device.type != "cpu" for p in model.parameters()):
        model = copy.deepcopy(model).cpu()
    folded = fold_osnet(model)
    if calib_crops is None:
        calib_crops = np.random.default_rng(seed).normal(0.0, 1.0, CALIB_SHAPE)
    if not isinstance(calib_crops, torch.Tensor):
        calib_crops = torch.as_tensor(np.asarray(calib_crops))
    act = calibrate_osnet(folded, calib_crops.cpu().float())
    q = {}
    for name, leaf in folded.items():
        qk, wscale = _quantize_weight(leaf["kernel"])
        q[name] = {"kernel": qk, "wscale": wscale, "bias": leaf["bias"]}
    return {"folded": folded, "q": q, "act": act}


def quantized_from_numpy(qvars) -> dict:
    """The JAX package's ``quantize_osnet`` output (numpy leaves, as
    ``jax.device_get`` returns them) as this module's: CPU tensors of the
    same dtypes (int8 kernels stay int8), 0-d tensors for the scales."""
    def leaves(tree):
        return {name: {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}
                for name, leaf in tree.items()}

    return {"folded": leaves(qvars["folded"]), "q": leaves(qvars["q"]),
            "act": {k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in qvars["act"].items()}}


# --------------------------------------------------------- int8 forward
def _quantize_act(x, s_in):
    """``clip(round(x / s_in), -127, 127)`` as int8, in float32."""
    return torch.clamp(torch.round(x.float() / s_in), -127, 127).to(torch.int8)


def _dequantize(acc, s_in, leaf, dtype):
    """``acc * (s_in * wscale) + bias`` in float32, carried in ``dtype``."""
    return (acc.float() * (s_in * leaf["wscale"]) + leaf["bias"]).to(dtype)


def _weight_matrix(kernel):
    """An int8 kernel (HWIO, or Dense (in, out)) as the (K, cout) matrix
    of its product, on CUDA in ``int8.padded_weight``'s layout (a matrix
    already in it is returned as it is)."""
    w = kernel.reshape(-1, kernel.shape[-1])
    return int8.padded_weight(w) if w.device.type == "cuda" else w


IM2COL_BYTES = 1 << 28  # int8 im2col bytes of one chunk of the batch


def _int8_conv(xq, w, shape, strides, padding):
    """int32 sums of the NHWC int8 conv of ``xq`` with the int8 HWIO
    kernel of ``shape`` (groups 1) whose product matrix is ``w``
    (``_weight_matrix``): a 1x1 stride-1 conv is one product over
    (B*H*W, Cin); any other is an im2col (tap-major, as the HWIO kernel
    flattens) in batch chunks of about IM2COL_BYTES, one product each."""
    kh, kw, cin, cout = shape
    B, H, W, _ = xq.shape
    if kh == kw == 1 and tuple(strides) == (1, 1) and not padding:
        return int8.int8_matmul_padded(xq.reshape(-1, cin), w, cout).reshape(
            B, H, W, cout)
    sh, sw = strides
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
    Ho = (H + 2 * padding - kh) // sh + 1
    Wo = (W + 2 * padding - kw) // sw + 1
    out = torch.empty((B, Ho, Wo, cout), dtype=torch.int32, device=xq.device)
    chunk = max(1, IM2COL_BYTES // (Ho * Wo * w.shape[0]))
    for b0 in range(0, B, chunk):
        xb = xp[b0:b0 + chunk]
        cols = torch.stack([xb[:, i:i + sh * (Ho - 1) + 1:sh,
                               j:j + sw * (Wo - 1) + 1:sw, :]
                            for i in range(kh) for j in range(kw)], dim=3)
        out[b0:b0 + chunk] = int8.int8_matmul_padded(
            cols.reshape(-1, kh * kw * cin), w, cout).reshape(
                -1, Ho, Wo, cout)
    return out


def forward_int8(qvars, x, act_dtype=torch.float32):
    """The quantized forward (``quantize_osnet``'s variables) of NHWC
    float crops ``x``: each conv's and the head's input quantized with
    its static scale, int8 products with int32 sums (the stem's 7x7 conv
    and every 1x1 conv, and the head; ``ops/int8.py``), dequantized in
    float32 and carried in the dtype of the layer's input. The crops
    enter in ``act_dtype``; the first channel gate's float32 Dense
    kernels promote its output to float32, and every layer from there on
    runs in float32, as in the JAX package. The 3x3 depthwise convs stay
    float on the folded weights (their kernels cast to the input's
    dtype, as the JAX package casts them). The kernel shapes are read
    from the folded tree, the product matrices from ``q``'s kernels
    (``_weight_matrix``). On a TPU the JAX package measured this
    path slower than its bf16 one; it saves weight bytes (int8 against
    float32), not time."""
    folded, q, act = qvars["folded"], qvars["q"], qvars["act"]

    def qget(name, xf, strides, padding, groups):
        if groups > 1:  # depthwise: float on the folded weights
            f = folded[name]
            return _conv(xf, f["kernel"].to(xf.dtype), f["bias"], strides,
                         padding, groups)
        leaf, s_in = q[name], act[name]
        shape = tuple(folded[name]["kernel"].shape)
        w = _weight_matrix(leaf["kernel"])
        xq = _quantize_act(xf, s_in)
        if strides is None:  # the head
            acc = int8.int8_matmul_padded(xq, w, shape[-1])
        else:
            acc = _int8_conv(xq, w, shape, strides, padding)
        return _dequantize(acc, s_in, leaf, xf.dtype)

    return _forward_folded(folded, x.to(act_dtype), qget=qget)


def _on_device(qvars, device):
    """What :func:`forward_int8` reads, on ``device``: each int8 conv's
    and the head's kernel as its product matrix (``_weight_matrix``,
    laid out once here), weight scale and bias, every input scale, and
    the folded depthwise kernels and gates, which run in float. The other
    folded leaves stay on the host, where only their shapes are read, as
    XLA drops the unused constants of the JAX package's closure."""
    lites = _lite_bases(qvars["folded"])

    def in_float(name):
        return name.endswith(("/fc1", "/fc2")) or (
            name.endswith("/conv2") and name[:-6] in lites)

    def move(leaf):
        return {k: v.to(device) for k, v in leaf.items()}

    folded = {name: move(leaf) if in_float(name) else leaf
              for name, leaf in qvars["folded"].items()}
    q = {name: {"kernel": _weight_matrix(leaf["kernel"].to(device)),
                "wscale": leaf["wscale"].to(device),
                "bias": leaf["bias"].to(device)}
         for name, leaf in qvars["q"].items() if not in_float(name)}
    return {"folded": folded, "q": q,
            "act": {k: v.to(device) for k, v in qvars["act"].items()}}


def make_embed_fn_int8(model: OSNet, norm=None, calib_crops=None,
                       act_dtype=None, device="cuda"):
    """Int8 drop-in for ``appearance/reid.py::make_embed_fn``:
    ``embed(crops (B, H, W, 3) uint8 BGR) -> (B, D) float32``,
    L2-normalized, with the quantized CNN inside (``quantize_osnet`` of
    ``model``, on the CPU). Preprocessing is make_embed_fn's.

    act_dtype: the dtype the crops enter :func:`forward_int8` in (a
    torch dtype, or "float32" / "bfloat16"); by default bfloat16 on CUDA
    and float32 on the CPU. The weights are made on ``device``; embed
    runs where its crops are (a tensor's device, or ``device`` for host
    arrays), the weights copied to another device the first time crops
    arrive there, as make_embed_fn's."""
    from motcpp_tpu_torch.appearance.reid import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        _check_compute_dtype,
        normalize_features,
    )

    dev = resolve_device(device)
    if norm is None:
        norm = (IMAGENET_MEAN, IMAGENET_STD)
    if isinstance(act_dtype, str):
        act_dtype = _check_compute_dtype(act_dtype)
    qvars = quantize_osnet(model, calib_crops=calib_crops)

    def build(d):
        adt = act_dtype or (torch.float32 if d.type == "cpu"
                            else torch.bfloat16)
        return (_on_device(qvars, d), adt,
                torch.tensor(norm[0], dtype=torch.float32, device=d),
                torch.tensor(norm[1], dtype=torch.float32, device=d))

    weights = PerDevice(build, dev)

    @torch.no_grad()
    def embed(crops):
        if not isinstance(crops, torch.Tensor):
            crops = torch.as_tensor(crops, device=dev)
        qv, adt, mean, std = weights.on(crops.device)
        x = crops.float().flip(-1) / 255.0  # BGR -> RGB
        x = (x - mean) / std
        return normalize_features(forward_int8(qv, x, adt).float())

    return embed
