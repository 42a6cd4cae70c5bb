"""ReID backend: batched crop extraction and OSNet embeddings on the device.

Counterpart of ``motcpp_tpu/appearance/reid.py`` (reference contract:
src/appearance/reid_backend.cpp:10-123, onnx_backend.cpp:110-240):

    get_features(xyxys (N, 4), img) -> (N, D) L2-normalized embeddings

The crop pipeline is the reference's: round and clamp the box, bilinear
resize to the model's H x W (cv2 INTER_LINEAR sampling), BGR -> RGB,
/255, (x - mean) / std, as one batched gather over all N boxes.
:func:`make_embed_fn` is the crops-in half of the live-ReID path that
the multi-stream rollout calls every frame; with ``fused=True`` every
OSBlock runs through the hand-written CUDA kernel on the card.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from motcpp_tpu_torch.device import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.5, 0.5, 0.5)
CLIP_STD = (0.5, 0.5, 0.5)


def determine_input_shape(model_name: str):
    """reference: reid_backend.cpp:88-105."""
    name = model_name or ""
    if "vehicleid" in name or "veri" in name:
        return (256, 256)
    if "lmbn" in name:
        return (384, 128)
    if "hacnn" in name:
        return (160, 64)
    return (256, 128)


def determine_normalization(model_name: str):
    """reference: reid_backend.cpp:109-123."""
    if "clip" in (model_name or ""):
        return CLIP_MEAN, CLIP_STD
    return IMAGENET_MEAN, IMAGENET_STD


def extract_crops(img_bgr: torch.Tensor, xyxys: torch.Tensor, crop_hw, norm):
    """Batched crop, resize and normalize (reference:
    reid_backend.cpp:10-68).

    img_bgr: (H, W, 3) uint8 or float BGR image; xyxys: (N, 4) float
    boxes; crop_hw: (crop_h, crop_w); norm: ((mean3), (std3)) per RGB
    channel. Returns (N, crop_h, crop_w, 3) float32 RGB crops on the
    image's device. ``torch.round`` rounds half to even, as ``jnp.round``.
    """
    crop_h, crop_w = crop_hw
    dev = img_bgr.device
    H, W = img_bgr.shape[0], img_bgr.shape[1]
    img = img_bgr.float().flip(-1) / 255.0  # BGR -> RGB in [0, 1]
    xyxys = xyxys.float()
    x1 = torch.clamp(torch.round(xyxys[:, 0]), 0, W)
    y1 = torch.clamp(torch.round(xyxys[:, 1]), 0, H)
    x2 = torch.clamp(torch.round(xyxys[:, 2]), 0, W)
    y2 = torch.clamp(torch.round(xyxys[:, 3]), 0, H)
    bw = torch.clamp_min(x2 - x1, 1.0)
    bh = torch.clamp_min(y2 - y1, 1.0)

    # cv2.resize INTER_LINEAR sampling: src = (dst + 0.5) * scale - 0.5
    ar_h = torch.arange(crop_h, device=dev, dtype=torch.float32)
    ar_w = torch.arange(crop_w, device=dev, dtype=torch.float32)
    dy = (ar_h + 0.5) * (bh[:, None] / crop_h) - 0.5 + y1[:, None]
    dx = (ar_w + 0.5) * (bw[:, None] / crop_w) - 0.5 + x1[:, None]
    y0 = torch.floor(dy)
    x0 = torch.floor(dx)
    wy = dy - y0
    wx = dx - x0

    def sample(yi, xi):
        yi = torch.clamp(yi.to(torch.int64), 0, H - 1)
        xi = torch.clamp(xi.to(torch.int64), 0, W - 1)
        return img[yi[:, :, None], xi[:, None, :]]  # (N, crop_h, crop_w, 3)

    tl = sample(y0, x0)
    tr = sample(y0, x0 + 1)
    bl = sample(y0 + 1, x0)
    br = sample(y0 + 1, x0 + 1)
    wyc = wy[:, :, None, None]
    wxc = wx[:, None, :, None]
    crops = (tl * (1 - wyc) * (1 - wxc) + tr * (1 - wyc) * wxc
             + bl * wyc * (1 - wxc) + br * wyc * wxc)
    mean = torch.tensor(norm[0], dtype=torch.float32, device=dev)
    std = torch.tensor(norm[1], dtype=torch.float32, device=dev)
    return (crops - mean) / std


def normalize_features(feats: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 with the reference's zero guard
    (reid_backend.cpp:70-86)."""
    n = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return torch.where(n > 1e-6, feats / torch.where(n > 1e-6, n, 1.0), feats)


def _check_compute_dtype(compute_dtype: str):
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}"
        )
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def _model_on(model, dev, cdt):
    """A copy of ``model`` on ``dev`` with every float tensor (weights and
    BN statistics) in ``cdt``, as the JAX package casts its variables."""
    return copy.deepcopy(model).to(dev, cdt).eval()


class ReIDBackend:
    """Host-facing backend with the reference's contract.

    weights: a torchreid checkpoint (.pt/.pth) or a .npz of the JAX
    package's converted variables; without weights the network is
    osnet_x1_0 with random weights from ``seed``. model_name drives the
    input-shape and normalization heuristics (the weights' file name
    when empty). compute_dtype: "float32" or "bfloat16"; embeddings
    return as L2-normalized float32 numpy either way. The network runs
    as the unfolded module, as the JAX package's backend runs its Flax
    module: the OSBlock kernel is on the live-ReID path
    (``make_embed_fn(fused=True)``), not here.
    """

    def __init__(self, weights: str = "", model_name: str = "", seed: int = 0,
                 compute_dtype: str = "float32", device="cuda"):
        from motcpp_tpu_torch.appearance.osnet import (
            init_params,
            load_weights_auto,
            osnet_x1_0,
        )

        self.device = resolve_device(device)
        if not model_name and weights:
            model_name = str(weights).rsplit("/", 1)[-1]
        self.model_name = model_name
        self.input_shape = determine_input_shape(model_name)
        self.norm = determine_normalization(model_name)
        if weights:
            model = load_weights_auto(weights)
        else:
            model = init_params(osnet_x1_0(), seed)
        self.compute_dtype = compute_dtype
        self.model = _model_on(model, self.device,
                               _check_compute_dtype(compute_dtype))

    def get_crops(self, xyxys, img):
        """(N, 3*H*W) CHW-flattened crops, the reference's output
        contract (reid_backend.cpp:10-68)."""
        crops = extract_crops(
            torch.as_tensor(np.asarray(img), device=self.device),
            torch.as_tensor(np.asarray(xyxys, np.float32), device=self.device),
            self.input_shape, self.norm)
        return crops.permute(0, 3, 1, 2).reshape(crops.shape[0], -1).cpu().numpy()

    @torch.no_grad()
    def get_features(self, xyxys, img):
        """(N, D) L2-normalized embeddings (onnx_backend.cpp:110-158)."""
        xyxys = np.asarray(xyxys, np.float32)
        if xyxys.shape[0] == 0:
            return np.zeros((0, self.model.feature_dim), np.float32)
        crops = extract_crops(
            torch.as_tensor(np.asarray(img), device=self.device),
            torch.as_tensor(xyxys, device=self.device),
            self.input_shape, self.norm)
        cdt = next(self.model.parameters()).dtype
        feats = self.model(crops.to(cdt)).float()
        return normalize_features(feats).cpu().numpy()

    def warmup(self):
        """Run the forward once on a seeded batch of two crops of a
        256x256 image (onnx_backend.cpp:225-240), so that the first
        frame does not pay for the first call's set-up."""
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, (256, 256, 3), np.uint8)
        self.get_features(
            np.asarray([[0, 0, 128, 256], [64, 0, 192, 256]], np.float32), img
        )


def make_embed_fn(model, norm=(IMAGENET_MEAN, IMAGENET_STD),
                  compute_dtype: str = "float32", folded: bool = False,
                  fused: bool = False, device="cuda"):
    """Build ``embed(crops (B, H, W, 3) uint8 BGR) -> (B, D) float32``,
    L2-normalized, on ``device``, from an OSNet ``model`` (weights
    included).

    Preprocessing is get_crops' (BGR -> RGB, /255, (x - mean) / std).
    compute_dtype "bfloat16" casts weights and activations. ``folded``
    runs the BN-folded forward (appearance/quant.py); ``fused`` runs
    every OSBlock through ``appearance/osblock.py::osblock_fused`` (the
    CUDA kernel on the card). The kernel takes any batch size, so no
    padding of the batch is needed.
    """
    dev = resolve_device(device)
    cdt = _check_compute_dtype(compute_dtype)
    mean = torch.tensor(norm[0], dtype=torch.float32, device=dev)
    std = torch.tensor(norm[1], dtype=torch.float32, device=dev)

    def prep(crops):
        x = torch.as_tensor(crops, device=dev).float().flip(-1) / 255.0
        return ((x - mean) / std).to(cdt)

    if fused or folded:
        from motcpp_tpu_torch.appearance import osblock
        from motcpp_tpu_torch.appearance.quant import _forward_folded, fold_osnet

        tree = {name: {k: v.to(dev, cdt) for k, v in leaf.items()}
                for name, leaf in fold_osnet(model).items()}
        if fused:
            packed = osblock.pack_blocks(tree, cdt)

            @torch.no_grad()
            def embed(crops):
                feats = osblock.forward_fused(tree, prep(crops), packed)
                return normalize_features(feats.float())

            return embed

        @torch.no_grad()
        def embed(crops):
            return normalize_features(_forward_folded(tree, prep(crops)).float())

        return embed

    net = _model_on(model, dev, cdt)

    @torch.no_grad()
    def embed(crops):
        return normalize_features(net(prep(crops)).float())

    return embed


def embed_valid_crops(embed_fn, crops, dets, masks, budget=None,
                      priority=None):
    """Run the ReID CNN over at most ``budget`` VALID crops.

    crops (S, N, Hc, Wc, 3) uint8, dets (S, N, >= 5), masks (S, N) bool
    -> embeddings (S, N, D) float32. The valid crops are pulled to the
    front in order of priority (default: detection confidence), highest
    first, the CNN runs on those ``budget`` crops, and the features are
    scattered back to their slots; invalid slots and overflow detections
    get zero embeddings ("no appearance" for that frame). The order is a
    stable argsort over (validity, -priority). budget None or >= S*N
    embeds every slot.
    """
    S, N = crops.shape[:2]
    flat = crops.reshape((S * N,) + tuple(crops.shape[2:]))
    if budget is None or int(budget) >= S * N:
        return embed_fn(flat).reshape(S, N, -1)
    C = int(budget)
    if C < 1:
        raise ValueError(f"crop budget must be >= 1, got {budget}")
    mflat = masks.reshape(S * N)
    if priority is None:
        pri = dets[..., 4].reshape(S * N).float()
    else:
        pri = torch.as_tensor(priority, dtype=torch.float32,
                              device=crops.device).reshape(S * N)
    key = torch.where(mflat, -pri, torch.inf)
    idx = torch.argsort(key, stable=True)[:C]
    feats = embed_fn(flat[idx])  # (C, D)
    keep = mflat[idx].to(feats.dtype)[:, None]
    out = torch.zeros((S * N, feats.shape[-1]), dtype=feats.dtype,
                      device=feats.device)
    out[idx] = feats * keep
    return out.reshape(S, N, -1)
