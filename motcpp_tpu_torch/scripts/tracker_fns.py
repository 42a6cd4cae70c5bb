"""The nine trackers at the scoreboard's configurations.

Counterpart of the JAX package's ``bench.py::build_tracker_fns``: the
same configuration for each tracker (``min_hits=1`` where the scoreboard
sets it, DeepOC-SORT without embeddings or camera motion, StrongSORT at
``n_init=1, gallery_cap=16``, BoT-SORT and HybridSORT without ReID),
and with ``emb_dim > 0`` the appearance trackers given that embedding
width and their ReID switched on. It returns the ``(init_fn, step_fn)``
pair that ``parallel/streams.py::MultiStreamRunner`` takes; it times
nothing.

    init, step = build_tracker_fns("bytetrack", device="cuda")
    runner = MultiStreamRunner(init, step, 4096, device="cuda")
"""

from __future__ import annotations

import importlib

TRACKERS = ("sort", "ocsort", "deepocsort", "strongsort", "botsort",
            "boosttrack", "hybridsort", "ucmctrack", "bytetrack")

# tracker -> (module, config class, factory, config beside the widths)
_FACTORIES = {
    "sort": ("sort", "SortConfig", "make_sort",
             dict(min_hits=1, max_age=3)),
    "bytetrack": ("bytetrack", "ByteTrackConfig", "make_bytetrack", {}),
    "ocsort": ("ocsort", "OCSortConfig", "make_ocsort", dict(min_hits=1)),
    "deepocsort": ("deepocsort", "DeepOCSortConfig", "make_deepocsort",
                   dict(min_hits=1, embedding_off=True, cmc_off=True)),
    "strongsort": ("strongsort", "StrongSortConfig", "make_strongsort",
                   dict(n_init=1, gallery_cap=16)),
    "botsort": ("botsort", "BotSortConfig", "make_botsort",
                dict(with_reid=False)),
    "boosttrack": ("boosttrack", "BoostTrackConfig", "make_boosttrack",
                   dict(min_hits=1)),
    "hybridsort": ("hybridsort", "HybridSortConfig", "make_hybridsort",
                   dict(min_hits=1, with_reid=False)),
    "ucmctrack": ("ucmctrack", "UCMCConfig", "make_ucmctrack", {}),
}
EMB_TRACKERS = ("strongsort", "botsort", "hybridsort", "deepocsort",
                "boosttrack")
REID_SWITCHED = ("botsort", "hybridsort", "boosttrack")


def tracker_config(tracker: str, max_tracks: int = 64, max_dets: int = 32,
                   lap_impl: str = "auction_pallas", emb_dim: int = 0):
    """(factory, config) of ``tracker`` at the scoreboard's settings;
    ``lap_impl`` as the trackers take it ("auction_pallas" is the auction
    CUDA kernel, its plain version for tensors on the CPU)."""
    if tracker not in _FACTORIES:
        raise ValueError(f"unknown tracker {tracker!r}; one of {TRACKERS}")
    mod_name, cfg_name, make_name, extra = _FACTORIES[tracker]
    extra = dict(extra)
    if emb_dim > 0 and tracker in EMB_TRACKERS:
        extra["emb_dim"] = emb_dim
        if tracker in REID_SWITCHED:
            extra["with_reid"] = True
        if tracker == "deepocsort":
            extra["embedding_off"] = False
    mod = importlib.import_module(f"motcpp_tpu_torch.models.{mod_name}")
    cfg = getattr(mod, cfg_name)(max_tracks=max_tracks, max_dets=max_dets,
                                 lap_impl=lap_impl, **extra)
    return getattr(mod, make_name), cfg


def build_tracker_fns(tracker: str, max_tracks: int = 64, max_dets: int = 32,
                      lap_impl: str = "auction_pallas", emb_dim: int = 0,
                      device="cuda"):
    """(init_fn, step_fn) of ``tracker`` at the scoreboard's settings on
    ``device`` (the card by default; it raises where there is none)."""
    make, cfg = tracker_config(tracker, max_tracks, max_dets, lap_impl,
                               emb_dim)
    return make(cfg, device=device)
