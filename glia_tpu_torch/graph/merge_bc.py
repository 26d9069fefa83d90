"""Classifier-in-the-loop greedy merging (merge_order_bc; a copy of
glia_tpu.graph.merge_bc).

Reference: genMergeOrderGreedyUsingBoundaryClassifier
(code/util/struct_merge_bc.hxx:10-44) driven by
code/hmt/main_merge_order_bc.cxx: every candidate pair's saliency is the
classifier's merge probability over freshly computed
BoundaryClassificationFeats of (r0, r1, scratch-merged r2); the queue pops
the highest probability first.

Instead of the reference's scratch pixel-set merges + full per-candidate
pixel traversals, this engine maintains *composable component records*:

  - region stats (area/bbox/image stats) merge by pure union;
  - boundary stats exploit the base-pair cancellation structure
    (code/type/region.hxx:68-77): per ordered component pair we keep the
    MUTUAL part (cancels wholesale when the two components merge) and the
    NON-MUTUAL part (survives forever, moving into the merged component's
    residual).  Every update is a union -- no subtraction, so min/max stay
    exact.

Candidate feature vectors then assemble in O(stat width) per candidate
(features/serialize.py), not O(pixels).
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..features.config import FeatureConfig
from ..features.serialize import bc_vector
from .rag import Rag

POS_INF = np.inf
NEG_INF = -np.inf


def _empty_bstat(n_bins):
    # element 6 = pixel-value chunk list (filled only under
    # median_as_feats; medians are not composable so the multiset rides
    # along as shared array references, feat.hxx:674-811)
    return [0.0, 0.0, 0.0, POS_INF, NEG_INF, np.zeros(n_bins), []]


def _union_bstat(a, b):
    return [a[0] + b[0], a[1] + b[1], a[2] + b[2], min(a[3], b[3]),
            max(a[4], b[4]), a[5] + b[5], a[6] + b[6]]


class _BStats:
    """Bundle of one-sided boundary stats: count, vp[nT], per-b_image
    (cnt,sum,sumsq,min,max,hist)."""

    __slots__ = ("cnt", "vp", "b")

    def __init__(self, cfg):
        self.cnt = 0.0
        self.vp = np.zeros(len(cfg.boundary_thresholds))
        self.b = [_empty_bstat(img.hist_bins) for img in cfg.b_images]

    def add(self, other: "_BStats"):
        self.cnt += other.cnt
        self.vp = self.vp + other.vp
        self.b = [_union_bstat(a, c) for a, c in zip(self.b, other.b)]
        return self


class DynamicRagState:
    """Mutable component-level RAG with full feature state."""

    def __init__(self, rag: Rag, cfg: FeatureConfig):
        self.cfg = cfg
        self.ndim = len(rag.shape)
        if rag.region_ptr is None:
            raise ValueError("build RAG with contour_only=False")

        pb = np.asarray(cfg.pb_image, dtype=np.float64).ravel()
        nT = len(cfg.boundary_thresholds)

        # ---- leaf region records ----
        self.rec: Dict[int, dict] = {}
        shape = rag.shape
        for i, key in enumerate(rag.keys):
            key = int(key)
            s, e = int(rag.region_ptr[i]), int(rag.region_ptr[i + 1])
            pix = rag.region_pixels[s:e]
            coords = np.unravel_index(pix, shape)
            coords = np.stack(
                [coords[self.ndim - 1 - d] for d in range(self.ndim)], axis=1
            ).astype(np.float64)
            r_stats = []
            for img in cfg.r_images:
                v = np.asarray(img.image, dtype=np.float64).ravel()[pix]
                r_stats.append(self._scalar_stats(v, img))
            rl = []
            for img in cfg.rl_images:
                v = np.asarray(img.image, dtype=np.float64).ravel()[pix]
                rl.append(self._hist_only(v, img))
            bs, be = int(rag.border_ptr[i]), int(rag.border_ptr[i + 1])
            self.rec[key] = {
                "area": float(e - s),
                "border": float(be - bs),
                "bbox_lo": coords.min(axis=0) if len(coords) else
                np.zeros(self.ndim),
                "bbox_hi": coords.max(axis=0) if len(coords) else
                np.zeros(self.ndim),
                "r": r_stats,
                "rl": rl,
                # bd / vp / b filled below from pair entries
            }

        # ---- per-directed-base-pair stats, split mutual / non-mutual ----
        dir_code = (rag.dir_pairs[:, 0] << 32) | rag.dir_pairs[:, 1]
        rev_code = (rag.dir_pairs[:, 1] << 32) | rag.dir_pairs[:, 0]
        sc = np.sort(dir_code)
        pos = np.searchsorted(sc, rev_code)
        mutual = (pos < len(sc)) & (sc[np.minimum(pos, len(sc) - 1)]
                                    == rev_code)

        # component-pair entries: (c0, c1) ordered -> {"m": _BStats, "n": _BStats}
        self.entries: Dict[Tuple[int, int], dict] = {}
        # residual (internal non-mutual) per component
        self.residual: Dict[int, _BStats] = {
            int(k): _BStats(cfg) for k in rag.keys}

        for e in range(len(rag.dir_pairs)):
            a, b = int(rag.dir_pairs[e, 0]), int(rag.dir_pairs[e, 1])
            s, t = int(rag.dir_ptr[e]), int(rag.dir_ptr[e + 1])
            pix = rag.dir_pixels[s:t]
            st = _BStats(cfg)
            st.cnt = float(t - s)
            pv = pb[pix]
            for ti, th in enumerate(cfg.boundary_thresholds):
                st.vp[ti] = float((pv >= th).sum())
            for bi, img in enumerate(cfg.b_images):
                v = np.asarray(img.image, dtype=np.float64).ravel()[pix]
                st.b[bi] = [float(len(v)), float(v.sum()),
                            float((v * v).sum()),
                            float(v.min()) if len(v) else POS_INF,
                            float(v.max()) if len(v) else NEG_INF,
                            self._hist_counts(v, img),
                            [v] if cfg.median_as_feats and len(v) else []]
            ent = self.entries.setdefault(
                (a, b), {"m": _BStats(cfg), "n": _BStats(cfg)})
            part = "m" if mutual[e] else "n"
            ent[part].add(st)

        # adjacency at component level (all entries, mutual or not)
        self.adj: Dict[int, set] = {}
        for (a, b) in self.entries:
            self.adj.setdefault(a, set()).add(b)
            self.adj.setdefault(b, set()).add(a)
        for k in self.rec:
            self.adj.setdefault(int(k), set())

    # -- helpers ---------------------------------------------------------

    def _hist_counts(self, v, img):
        from .._histutil import hist_counts

        return hist_counts(v, img.hist_bins, img.hist_range)

    def _scalar_stats(self, v, img):
        if len(v) == 0:
            return [0.0, 0.0, 0.0, 0.0, 0.0, np.zeros(img.hist_bins), []]
        chunks = [v] if self.cfg.median_as_feats else []
        return [float(len(v)), float(v.sum()), float((v * v).sum()),
                float(v.min()), float(v.max()), self._hist_counts(v, img),
                chunks]

    def _boundary_totals(self, c) -> _BStats:
        """One-sided boundary stats of component c: outgoing entries (both
        parts) + residual."""
        tot = _BStats(self.cfg)
        tot.add(self.residual[c])
        # canonical (sorted) accumulation order: float sums become
        # deterministic and engine-independent, so the native C++ oracle
        # (glia_bc.cc) reproduces them bit-for-bit
        for nb in sorted(self.adj.get(c, ())):
            ent = self.entries.get((c, nb))
            if ent is not None:
                tot.add(ent["m"])
                tot.add(ent["n"])
        return tot

    def record_with_boundary(self, c) -> dict:
        rec = dict(self.rec[c])
        tot = self._boundary_totals(c)
        rec["bd"] = tot.cnt
        rec["vp"] = tot.vp
        rec["b"] = [tuple(x) for x in tot.b]
        return rec

    def pair_boundary(self, c0, c1) -> dict:
        """getBoundary(c0, c1) stats: both directions, both parts
        (util/struct.hxx:11-16 + region.hxx:42-51)."""
        tot = _BStats(self.cfg)
        for key in ((c0, c1), (c1, c0)):
            ent = self.entries.get(key)
            if ent is not None:
                tot.add(ent["m"])
                tot.add(ent["n"])
        return {"cnt": tot.cnt, "vp": tot.vp,
                "b": [tuple(x) for x in tot.b]}

    def merged_record(self, c0, c1) -> dict:
        """Record of the would-be merge (the reference's scratch merge into
        BG_VAL, struct_merge_bc.hxx:18-35)."""
        r0, r1 = self.rec[c0], self.rec[c1]
        rec = {
            "area": r0["area"] + r1["area"],
            "border": r0["border"] + r1["border"],
            "bbox_lo": np.minimum(r0["bbox_lo"], r1["bbox_lo"]),
            "bbox_hi": np.maximum(r0["bbox_hi"], r1["bbox_hi"]),
            "r": [[a[0] + b[0], a[1] + b[1], a[2] + b[2],
                   min(a[3], b[3]) if a[0] and b[0] else
                   (a[3] if a[0] else b[3]),
                   max(a[4], b[4]) if a[0] and b[0] else
                   (a[4] if a[0] else b[4]),
                   a[5] + b[5], a[6] + b[6]]
                  for a, b in zip(r0["r"], r1["r"])],
            "rl": [a + b for a, b in zip(r0["rl"], r1["rl"])],
        }
        # boundary of merged = both boundaries minus the mutual pair parts
        # between c0 and c1 (they cancel); non-mutual parts persist.
        tot = _BStats(self.cfg)
        tot.add(self.residual[c0])
        tot.add(self.residual[c1])
        for (src, other_end) in ((c0, c1), (c1, c0)):
            for nb in sorted(self.adj.get(src, ())):
                ent = self.entries.get((src, nb))
                if ent is None:
                    continue
                if nb == other_end:
                    tot.add(ent["n"])  # mutual part cancels
                else:
                    tot.add(ent["m"])
                    tot.add(ent["n"])
        rec["bd"] = tot.cnt
        rec["vp"] = tot.vp
        rec["b"] = [tuple(x) for x in tot.b]
        return rec

    def candidate_features(self, c0, c1) -> np.ndarray:
        rec0 = self.record_with_boundary(c0)
        rec1 = self.record_with_boundary(c1)
        rec2 = self.merged_record(c0, c1)
        pair = self.pair_boundary(c0, c1)
        return bc_vector(rec0, rec1, rec2, pair, self.cfg, self.ndim)

    def merge(self, c0, c1, c2):
        """Commit the merge: build c2's record and rewire entries."""
        self.rec[c2] = {
            k: v for k, v in self.merged_record(c0, c1).items()
            if k not in ("bd", "vp", "b")}
        # residual: old residuals + non-mutual parts between c0/c1 (their
        # mutual parts cancel; non-mutual survive as internal boundary)
        res = _BStats(self.cfg)
        res.add(self.residual.pop(c0))
        res.add(self.residual.pop(c1))
        for key in ((c0, c1), (c1, c0)):
            ent = self.entries.pop(key, None)
            if ent is not None:
                res.add(ent["n"])
        self.residual[c2] = res
        neighbors = (self.adj.pop(c0, set()) | self.adj.pop(c1, set())) \
            - {c0, c1}
        self.adj[c2] = set()
        for nb in neighbors:
            for src in (c0, c1):
                ent = self.entries.pop((src, nb), None)
                if ent is not None:
                    dst = self.entries.setdefault(
                        (c2, nb), {"m": _BStats(self.cfg),
                                   "n": _BStats(self.cfg)})
                    dst["m"].add(ent["m"])
                    dst["n"].add(ent["n"])
                ent = self.entries.pop((nb, src), None)
                if ent is not None:
                    dst = self.entries.setdefault(
                        (nb, c2), {"m": _BStats(self.cfg),
                                   "n": _BStats(self.cfg)})
                    dst["m"].add(ent["m"])
                    dst["n"].add(ent["n"])
                self.adj[nb].discard(c0)
                self.adj[nb].discard(c1)
                self.adj[nb].add(c2)
            self.adj[c2].add(nb)
        del self.rec[c0]
        del self.rec[c1]


def greedy_merge_bc(rag: Rag, cfg: FeatureConfig,
                    predict: Callable[[np.ndarray], float],
                    predict_batch: Optional[Callable] = None):
    """Greedy merge with classifier saliency.

    predict: feature vector [D] -> merge probability (higher merges first;
    the queue pops max probability, struct_merge_bc.hxx:25-27).
    predict_batch: optional [B, D] -> [B] vectorized classifier; when
    given, all candidates created by one merge (and the initial table)
    score in one batch -- same results, far fewer classifier calls.
    Returns (order [n,3], saliencies=[probabilities]).
    """
    state = DynamicRagState(rag, cfg)
    heap = []
    entry_seq = {}
    seq = 0

    def push(c0, c1, p=None):
        nonlocal seq
        if p is None:
            feats = state.candidate_features(c0, c1)
            p = float(np.asarray(predict(feats)).reshape(-1)[0])
        key = (min(c0, c1), max(c0, c1))
        entry_seq[key] = seq
        # pop max probability; ties -> latest inserted first
        heapq.heappush(heap, (-p, -seq, key[0], key[1]))
        seq += 1

    def push_many(pairs):
        if not pairs:
            return
        if predict_batch is None:
            for c0, c1 in pairs:
                push(c0, c1)
            return
        feats = np.stack([state.candidate_features(c0, c1)
                          for c0, c1 in pairs])
        probs = np.asarray(predict_batch(feats), dtype=np.float64)
        for (c0, c1), p in zip(pairs, probs):
            push(c0, c1, float(p))

    # The boundary table only ever contains pairs whose *initial* boundary
    # was mutual (boundary_table.hxx:99-103), and update() rekeys only
    # existing table entries -- a neighbor touching a merged region solely
    # through a non-mutual boundary never becomes a candidate.
    table_pairs = set()
    init_pairs = []
    for (a, b) in list(state.entries):
        key = (min(a, b), max(a, b))
        if key in table_pairs:
            continue
        if (a, b) in state.entries and (b, a) in state.entries:
            table_pairs.add(key)
            init_pairs.append(key)
    push_many(init_pairs)

    next_key = int(max(state.rec.keys())) + 1
    order, sals = [], []

    while True:
        # pop the best live candidate
        popped = None
        while heap:
            negp, nseq, c0, c1 = heapq.heappop(heap)
            key = (c0, c1)
            if entry_seq.get(key) != -nseq or key not in table_pairs:
                continue
            popped = (negp, c0, c1)
            break
        if popped is None:
            break
        negp, c0, c1 = popped
        c2 = next_key
        next_key += 1
        order.append((c0, c1, c2))
        sals.append(-negp)
        key = (c0, c1)
        table_pairs.discard(key)
        entry_seq.pop(key, None)
        # which neighbors currently hold table entries with c0/c1?
        rekey = set()
        for nb in ((state.adj.get(c0, set()) | state.adj.get(c1, set()))
                   - {c0, c1}):
            for cc in (c0, c1):
                k = (min(cc, nb), max(cc, nb))
                if k in table_pairs:
                    table_pairs.discard(k)
                    entry_seq.pop(k, None)
                    rekey.add(nb)
        state.merge(c0, c1, c2)
        new_pairs = []
        for nb in sorted(rekey):
            k = (min(nb, c2), max(nb, c2))
            table_pairs.add(k)
            new_pairs.append((min(nb, c2), max(nb, c2)))
        push_many(new_pairs)

    return (np.asarray(order, dtype=np.int64).reshape(-1, 3),
            np.asarray(sals, dtype=np.float64))
