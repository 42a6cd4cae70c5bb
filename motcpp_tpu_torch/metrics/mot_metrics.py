"""HOTA / CLEAR / Identity metrics over MOT-Challenge text files.

A copy of ``motcpp_tpu/metrics/mot_metrics.py`` (numpy and scipy only),
so that the port imports nothing of the JAX package.

Host-side evaluation (numpy + scipy assignment); the tracking itself
never touches this module. Algorithms follow the standard definitions
used by TrackEval, which the reference invokes for its published tables
(reference: scripts/eval_mot.py, docs/guides/benchmarking.md:118-131):

  * CLEAR: per-frame matching that prefers continuing the previous
    frame's assignment, IoU >= threshold; MOTA = 1-(FN+FP+IDSW)/nGT,
    MOTP = mean matched IoU, MT/PT/ML by per-track hit ratio.
  * Identity: one global bipartite matching between gt and predicted
    identities maximizing per-pair frame matches; IDF1 from IDTP.
  * HOTA: alpha-averaged sqrt(DetA * AssA) with the two-pass global
    alignment scheme (potential matches -> per-alpha Hungarian scored
    by global alignment, TP gated at similarity >= alpha).

GT filtering follows the MOT17 convention: rows with consider-flag 0 or
non-pedestrian classes are dropped (configurable).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def load_mot_file(path, is_gt: bool = False, gt_classes=(1,)):
    """Parse a MOT-Challenge txt into {frame: (ids, boxes_xyxy, conf)}.

    GT rows keep only consider-flag==1 and the given classes
    (standard MOT17 pedestrian evaluation).
    """
    frames: dict = {}
    try:
        data = np.loadtxt(path, delimiter=",", ndmin=2)
    except (OSError, ValueError):
        return frames
    if data.size == 0:
        return frames
    for row in data:
        frame = int(row[0])
        tid = int(row[1])
        x, y, w, h = row[2], row[3], row[4], row[5]
        conf = row[6] if len(row) > 6 else 1.0
        if is_gt:
            if len(row) > 6 and int(row[6]) == 0:
                continue  # consider flag
            if len(row) > 7 and int(row[7]) not in gt_classes:
                continue
        frames.setdefault(frame, []).append(
            (tid, x, y, x + w, y + h, conf)
        )
    return _pack_frames(frames)


def _pack_frames(frames):
    out = {}
    for f, rows in frames.items():
        arr = np.asarray(rows, np.float64)
        out[f] = (arr[:, 0].astype(int), arr[:, 1:5], arr[:, 5])
    return out


# MOT17 ignore classes whose matched predictions are REMOVED before
# scoring (TrackEval's MotChallenge2DBox preprocessing): person on
# vehicle (2), static person (7), distractor (8), reflection (12)
DISTRACTOR_CLASSES = (2, 7, 8, 12)


def load_mot_raw(path):
    """GT with ALL rows kept; per frame (ids, boxes_xyxy, classes)."""
    frames: dict = {}
    try:
        data = np.loadtxt(path, delimiter=",", ndmin=2)
    except (OSError, ValueError):
        return frames
    if data.size == 0:
        return frames
    for row in data:
        cls = row[7] if len(row) > 7 else 1.0
        frames.setdefault(int(row[0]), []).append(
            (row[1], row[2], row[3], row[2] + row[4], row[3] + row[5], cls)
        )
    return _pack_frames(frames)


def remove_distractor_matches(
    pred: dict, gt_raw: dict, iou_thr: float = 0.5,
    distractors=DISTRACTOR_CLASSES,
) -> dict:
    """TrackEval MOT17 preprocessing: per frame, Hungarian-match tracker
    boxes against the RAW GT (all classes, including ignore rows); any
    prediction matched (IoU >= 0.5) to a distractor-class GT box is
    dropped before metrics are computed. Without this, trackers are
    punished with FPs for correctly tracking static persons/reflections
    the benchmark deliberately ignores."""
    out = {}
    dset = set(int(c) for c in distractors)
    for f, (p_ids, p_box, p_conf) in pred.items():
        g = gt_raw.get(f)
        if g is None or len(p_ids) == 0:
            out[f] = (p_ids, p_box, p_conf)
            continue
        _, g_box, g_cls = g
        iou = _iou_matrix(g_box, p_box)
        score = np.where(iou >= iou_thr - 1e-9, iou, np.nan)
        cost = np.where(np.isnan(score), 1e6, -score)
        drop = np.zeros(len(p_ids), bool)
        if iou.size:
            ri, ci = linear_sum_assignment(cost)
            for i, j in zip(ri, ci):
                if not np.isnan(score[i, j]) and int(g_cls[i]) in dset:
                    drop[j] = True
        keep = ~drop
        out[f] = (p_ids[keep], p_box[keep], p_conf[keep])
    return out


def _iou_matrix(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def clear_metrics(gt: dict, pred: dict, iou_thr: float = 0.5) -> dict:
    """CLEAR-MOT with match-continuation preference."""
    frames = sorted(set(gt) | set(pred))
    tp = fp = fn = idsw = 0
    motp_sum = 0.0
    prev_match: dict = {}  # gt_id -> pred_id
    gt_frames: dict = {}
    gt_matched_frames: dict = {}

    for f in frames:
        g_ids, g_box, _ = gt.get(f, (np.zeros(0, int), np.zeros((0, 4)), None))
        p_ids, p_box, _ = pred.get(f, (np.zeros(0, int), np.zeros((0, 4)), None))
        for gid in g_ids:
            gt_frames[gid] = gt_frames.get(gid, 0) + 1
        iou = _iou_matrix(g_box, p_box)
        score = np.where(iou >= iou_thr, iou, np.nan)
        # continuation bonus (TrackEval-style)
        bonus = np.zeros_like(iou)
        for gi, gid in enumerate(g_ids):
            if gid in prev_match:
                pj = np.nonzero(p_ids == prev_match[gid])[0]
                if pj.size:
                    bonus[gi, pj[0]] = 1000.0
        cost = np.where(np.isnan(score), 1e6, -(score + bonus))
        matches = []
        if iou.size:
            ri, ci = linear_sum_assignment(cost)
            for i, j in zip(ri, ci):
                if not np.isnan(score[i, j]):
                    matches.append((i, j))
        new_match = {}
        for i, j in matches:
            gid, pid = int(g_ids[i]), int(p_ids[j])
            if gid in prev_match and prev_match[gid] != pid:
                idsw += 1
            new_match[gid] = pid
            motp_sum += iou[i, j]
            gt_matched_frames[gid] = gt_matched_frames.get(gid, 0) + 1
        tp += len(matches)
        fn += len(g_ids) - len(matches)
        fp += len(p_ids) - len(matches)
        # carry forward matches for ids not seen this frame
        carried = {k: v for k, v in prev_match.items() if k not in new_match}
        prev_match = {**carried, **new_match}

    n_gt = tp + fn
    mota = 1.0 - (fn + fp + idsw) / max(n_gt, 1)
    motp = motp_sum / max(tp, 1)
    mt = pt = ml = 0
    for gid, total in gt_frames.items():
        ratio = gt_matched_frames.get(gid, 0) / total
        if ratio >= 0.8:
            mt += 1
        elif ratio < 0.2:  # strict <, matching TrackEval's ML boundary
            ml += 1
        else:
            pt += 1
    return dict(
        MOTA=100.0 * mota, MOTP=100.0 * motp, TP=tp, FP=fp, FN=fn,
        IDSW=idsw, MT=mt, PT=pt, ML=ml, nGT=n_gt,
        _motp_sum=motp_sum,  # accumulator for cross-sequence pooling
    )


def _id_counts(gt, pred, iou_thr):
    """Per (gt_id, pred_id) matched-frame counts + totals."""
    gt_ids = sorted({int(i) for f in gt.values() for i in f[0]})
    pr_ids = sorted({int(i) for f in pred.values() for i in f[0]})
    gmap = {g: i for i, g in enumerate(gt_ids)}
    pmap = {p: i for i, p in enumerate(pr_ids)}
    counts = np.zeros((len(gt_ids), len(pr_ids)))
    gt_total = np.zeros(len(gt_ids))
    pr_total = np.zeros(len(pr_ids))
    for f in sorted(set(gt) | set(pred)):
        g_ids, g_box, _ = gt.get(f, (np.zeros(0, int), np.zeros((0, 4)), None))
        p_ids, p_box, _ = pred.get(f, (np.zeros(0, int), np.zeros((0, 4)), None))
        for gid in g_ids:
            gt_total[gmap[int(gid)]] += 1
        for pid in p_ids:
            pr_total[pmap[int(pid)]] += 1
        iou = _iou_matrix(g_box, p_box)
        ok = iou >= iou_thr
        for gi, pj in zip(*np.nonzero(ok)):
            counts[gmap[int(g_ids[gi])], pmap[int(p_ids[pj])]] += 1
    return counts, gt_total, pr_total


def identity_metrics(gt: dict, pred: dict, iou_thr: float = 0.5) -> dict:
    """IDF1 via one global identity assignment."""
    counts, gt_total, pr_total = _id_counts(gt, pred, iou_thr)
    idtp = 0.0
    if counts.size:
        ri, ci = linear_sum_assignment(-counts)
        idtp = counts[ri, ci].sum()
    n_gt = gt_total.sum()
    n_pr = pr_total.sum()
    idfn = n_gt - idtp
    idfp = n_pr - idtp
    idf1 = idtp / max(idtp + 0.5 * idfn + 0.5 * idfp, 1e-12)
    idp = idtp / max(n_pr, 1e-12)
    idr = idtp / max(n_gt, 1e-12)
    return dict(IDF1=100.0 * idf1, IDP=100.0 * idp, IDR=100.0 * idr,
                IDTP=int(idtp), IDFN=int(idfn), IDFP=int(idfp))


def hota_metrics(gt: dict, pred: dict) -> dict:
    """HOTA with the standard 19-alpha average."""
    alphas = np.arange(0.05, 0.96, 0.05)
    frames = sorted(set(gt) | set(pred))

    gt_ids_all = sorted({int(i) for f in gt.values() for i in f[0]})
    pr_ids_all = sorted({int(i) for f in pred.values() for i in f[0]})
    gmap = {g: i for i, g in enumerate(gt_ids_all)}
    pmap = {p: i for i, p in enumerate(pr_ids_all)}
    nG, nP = len(gt_ids_all), len(pr_ids_all)

    # pass 1: potential matches (alpha-independent)
    pot = np.zeros((nG, nP))
    g_count = np.zeros(nG)
    p_count = np.zeros(nP)
    per_frame = []
    for f in frames:
        g_ids, g_box, _ = gt.get(f, (np.zeros(0, int), np.zeros((0, 4)), None))
        p_ids, p_box, _ = pred.get(f, (np.zeros(0, int), np.zeros((0, 4)), None))
        sim = _iou_matrix(g_box, p_box)
        gi = np.asarray([gmap[int(i)] for i in g_ids], int)
        pj = np.asarray([pmap[int(i)] for i in p_ids], int)
        g_count[gi] += 1
        p_count[pj] += 1
        denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
        sim_iou = np.where(denom > 0, sim / np.maximum(denom, 1e-12), 0.0)
        np.add.at(pot, (gi[:, None], pj[None, :]), sim_iou)
        per_frame.append((gi, pj, sim))

    galign = pot / np.maximum(
        g_count[:, None] + p_count[None, :] - pot, 1e-12
    )

    hota_a, deta_a, assa_a = [], [], []
    tp_a, fn_a, fp_a, assw_a = [], [], [], []
    for alpha in alphas:
        tp = 0
        fn = 0
        fp = 0
        match_count = np.zeros((nG, nP))
        for gi, pj, sim in per_frame:
            if len(gi) and len(pj):
                score = galign[np.ix_(gi, pj)] * sim
                ri, ci = linear_sum_assignment(-score)
                keep = sim[ri, ci] >= alpha - 1e-9
                ri, ci = ri[keep], ci[keep]
                match_count[gi[ri], pj[ci]] += 1
                tp += len(ri)
                fn += len(gi) - len(ri)
                fp += len(pj) - len(ri)
            else:
                fn += len(gi)
                fp += len(pj)
        deta = tp / max(tp + fn + fp, 1e-12)
        ass = match_count / np.maximum(
            g_count[:, None] + p_count[None, :] - match_count, 1e-12
        )
        assw = (match_count * ass).sum()
        assa = assw / max(tp, 1e-12)
        deta_a.append(deta)
        assa_a.append(assa)
        hota_a.append(np.sqrt(deta * assa))
        tp_a.append(tp)
        fn_a.append(fn)
        fp_a.append(fp)
        assw_a.append(assw)

    return dict(
        HOTA=100.0 * float(np.mean(hota_a)),
        DetA=100.0 * float(np.mean(deta_a)),
        AssA=100.0 * float(np.mean(assa_a)),
        # per-alpha accumulators for cross-sequence pooling
        _hota_tp=np.asarray(tp_a),
        _hota_fn=np.asarray(fn_a),
        _hota_fp=np.asarray(fp_a),
        _hota_assw=np.asarray(assw_a),
    )


def evaluate_sequence(gt_path, pred_path, gt_classes=(1,)) -> dict:
    """All three metric families for one sequence.

    Keys prefixed ``_`` are pooling accumulators consumed by
    :func:`combine_metrics`; drop them for display.
    """
    gt = load_mot_file(gt_path, is_gt=True, gt_classes=gt_classes)
    pred = load_mot_file(pred_path)
    # Truncated-GT guard: when the GT covers fewer frames than the
    # results (e.g. the bundled MOT17-mini GT spans frames 1-8 of a
    # 1050-frame det file), score only the GT's frame span — otherwise
    # every prediction past it counts as a false positive. No-op when
    # GT covers the whole sequence.
    if gt:
        max_gt_frame = max(gt)
        pred = {f: v for f, v in pred.items() if f <= max_gt_frame}
    # TrackEval-style MOT preprocessing: drop predictions that match
    # distractor-class GT (static persons, reflections, ...)
    pred = remove_distractor_matches(pred, load_mot_raw(gt_path))
    out = {}
    out.update(clear_metrics(gt, pred))
    out.update(identity_metrics(gt, pred))
    out.update(hota_metrics(gt, pred))
    return out


def combine_metrics(rows: list) -> dict:
    """Pool per-sequence results the way TrackEval's COMBINED row does:
    sum the accumulators across sequences, THEN form ratios (not an
    average of per-sequence ratios).

      * CLEAR: pooled TP/FP/FN/IDSW/nGT -> MOTA; MOTP = sum(iou)/sum(TP);
        MT/PT/ML summed (they are per-track counts).
      * Identity: pooled IDTP/IDFN/IDFP -> IDF1/IDP/IDR.
      * HOTA: per-alpha pooled TP/FN/FP and association mass ->
        DetA/AssA per alpha, averaged over the 19 alphas.
    """
    if not rows:
        return {}
    tp = sum(m["TP"] for m in rows)
    fp = sum(m["FP"] for m in rows)
    fn = sum(m["FN"] for m in rows)
    idsw = sum(m["IDSW"] for m in rows)
    n_gt = sum(m["nGT"] for m in rows)
    motp_sum = sum(m["_motp_sum"] for m in rows)
    out = dict(
        MOTA=100.0 * (1.0 - (fn + fp + idsw) / max(n_gt, 1)),
        MOTP=100.0 * motp_sum / max(tp, 1),
        TP=tp, FP=fp, FN=fn, IDSW=idsw, nGT=n_gt,
        MT=sum(m["MT"] for m in rows),
        PT=sum(m["PT"] for m in rows),
        ML=sum(m["ML"] for m in rows),
    )
    idtp = sum(m["IDTP"] for m in rows)
    idfn = sum(m["IDFN"] for m in rows)
    idfp = sum(m["IDFP"] for m in rows)
    out.update(
        IDF1=100.0 * idtp / max(idtp + 0.5 * idfn + 0.5 * idfp, 1e-12),
        IDP=100.0 * idtp / max(idtp + idfp, 1e-12),
        IDR=100.0 * idtp / max(idtp + idfn, 1e-12),
        IDTP=idtp, IDFN=idfn, IDFP=idfp,
    )
    h_tp = np.sum([m["_hota_tp"] for m in rows], axis=0)
    h_fn = np.sum([m["_hota_fn"] for m in rows], axis=0)
    h_fp = np.sum([m["_hota_fp"] for m in rows], axis=0)
    h_assw = np.sum([m["_hota_assw"] for m in rows], axis=0)
    deta_a = h_tp / np.maximum(h_tp + h_fn + h_fp, 1e-12)
    assa_a = h_assw / np.maximum(h_tp, 1e-12)
    out.update(
        HOTA=100.0 * float(np.mean(np.sqrt(deta_a * assa_a))),
        DetA=100.0 * float(np.mean(deta_a)),
        AssA=100.0 * float(np.mean(assa_a)),
    )
    return out
