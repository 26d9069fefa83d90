"""Command-line interface mirroring the reference's executables (the
PyTorch port of glia_tpu.cli).

Usage: python -m glia_tpu_torch.cli <command> [options] [--device DEV]

Each subcommand corresponds to one reference binary (SURVEY.md section 2.7)
and exchanges the same artifacts: label/real images (PNG/TIF) and
whitespace text files (merge orders ``r0 r1 r2`` per line, saliency /
probability / feature matrices), so stages remain individually runnable and
inspectable.  Images may also be ``.npy`` files (read and written with
numpy).  Subcommands that run torch work (merge_order_pb and
merge_order_bc with ``--engine device``, train_sshmt, pred_logsig,
pred_mlp) run on ``--device``: the CUDA card by default, ``cpu`` for the
plain PyTorch path.
"""

from __future__ import annotations

import argparse

import numpy as np


def _read_label(path):
    from ..io.image import read_label_image

    return read_label_image(path)


def _read_real(path):
    from ..io.image import read_real_image

    return read_real_image(path, normalize=True)


def _device(a):
    from ..device import resolve_device

    return resolve_device(a.device)


def _write_label(path, arr):
    from ..io.image import write_image

    arr = np.asarray(arr)
    if arr.max() < 2 ** 16:
        arr = arr.astype(np.uint16)
    else:
        arr = arr.astype(np.int32)
    write_image(path, arr)


def cmd_watershed(a):
    from ..pipeline import watershed

    seg = watershed(_read_real(a.input), a.level, relabel=a.relabel)
    _write_label(a.output, seg)


def cmd_pre_merge(a):
    from ..pipeline import pre_merge

    seg = _read_label(a.segImage)
    pb = _read_real(a.pbImage)
    out = pre_merge(seg, pb, tuple(a.sizeThresholds), a.rpbThreshold)
    _write_label(a.output, out)


def cmd_merge_order_pb(a):
    from ..graph.rag import build_rag
    from ..io.text import write_merge_order, write_vector

    seg = _read_label(a.segImage)
    pb = _read_real(a.pbImage)
    mask = _read_label(a.maskImage) if a.maskImage else None
    rag = build_rag(seg, mask=mask,
                    contour_only=(a.type != "median_minsize"))
    if a.engine == "device":
        from ..graph.merge_device import greedy_merge_device

        order, sals = greedy_merge_device(rag, pb, policy=a.type,
                                          device=_device(a))
    else:
        from ..native import greedy_merge_native

        order, sals = greedy_merge_native(rag, pb, policy=a.type)
    if a.mergeOrder:
        write_merge_order(a.mergeOrder, order)
    if a.saliency:
        write_vector(a.saliency, sals)


def cmd_bc_feat(a):
    from ..features.config import FeatureConfig
    from ..features.hierarchical import TreeFeatures
    from ..graph.rag import build_rag
    from ..io.text import read_merge_order, read_vector, write_matrix

    seg = _read_label(a.segImage)
    pb = _read_real(a.pbImage)
    intensity = _read_real(a.rawImage) if a.rawImage else None
    order = read_merge_order(a.mergeOrder)
    sals = read_vector(a.saliency) if a.saliency else None
    cfg = FeatureConfig.standard(pb, intensity, n_bins=a.bins,
                                 boundary_thresholds=tuple(a.bt),
                                 normalize_shape=a.normalizeShape)
    cfg.use_log_shape = a.logShape
    mask = _read_label(a.maskImage) if a.maskImage else None
    rag = build_rag(seg, mask=mask, contour_only=False)
    tf = TreeFeatures(rag, order, cfg, saliencies=sals)
    feats = tf.simple_features() if a.simple else tf.bc_features()
    write_matrix(a.bfeat, feats)


def cmd_bc_label(a):
    from ..features.labels import bc_labels
    from ..io.text import read_merge_order, write_vector

    seg = _read_label(a.segImage)
    truth = _read_label(a.truthImage)
    order = read_merge_order(a.mergeOrder)
    labels, m, s = bc_labels(seg, truth, order, rule=a.rule,
                             tweak=a.tweak, max_prec_drop=a.maxPrecDrop)
    write_vector(a.output, labels, fmt="%d")


def cmd_train_rf(a):
    from ..io.text import read_matrix, read_vector
    from ..models.forest import train_forest

    X = np.concatenate([read_matrix(f) for f in a.feat])
    y = np.concatenate([read_vector(f, dtype=np.int64) for f in a.label])
    model = train_forest(X, y, n_trees=a.nTree, sample_ratio=a.sampleRatio,
                         seed=a.seed, n_jobs=-1)
    model.save(a.model)


def cmd_pred_rf(a):
    from ..io.text import read_matrix, write_vector
    from ..models.forest import ForestModel, predict_label_fraction

    model = ForestModel.load(a.model)
    X = read_matrix(a.feat)
    p = predict_label_fraction(model, X, label=a.label)
    write_vector(a.output, p)


def cmd_segment(a, mode):
    from ..graph.tree import build_tree, node_potentials
    from ..infer.ccm import segment_ccm_picks
    from ..infer.greedy import resolve_tree_greedy
    from ..infer.segment import final_segmentation, relabel_image
    from ..io.text import read_merge_order, read_vector

    seg = _read_label(a.segImage)
    order = read_merge_order(a.mergeOrder)
    probs = read_vector(a.mergeProbs)
    tree = build_tree(order)
    if mode == "greedy":
        pot = node_potentials(tree, probs)
        picks = resolve_tree_greedy(tree, pot)
    else:
        picks = segment_ccm_picks(tree, probs)
    out = final_segmentation(seg, tree, picks)
    if a.relabel:
        out = relabel_image(out, 0)
    _write_label(a.output, out)


def cmd_apply_merges(a):
    from ..graph.merge import apply_merge_order
    from ..io.text import read_merge_order, read_vector

    seg = _read_label(a.segImage)
    order = read_merge_order(a.mergeOrder)
    sals = read_vector(a.saliency) if a.saliency else None
    out = apply_merge_order(seg, order, threshold_index=a.n,
                            saliencies=sals,
                            saliency_threshold=a.saliencyThreshold)
    _write_label(a.output, out)


def cmd_eval_vi(a):
    from ..metrics import eval_vi

    segs = [_read_label(f) for f in a.resImage]
    refs = [_read_label(f) for f in a.refImage]
    masks = [_read_label(f) for f in a.mask] if a.mask else None
    fs, fm, tot = eval_vi(segs, refs, masks)
    print(f"{fs:.6g} {fm:.6g} {tot:.6g}")


def cmd_eval_ri(a):
    from ..metrics import eval_ri

    segs = [_read_label(f) for f in a.resImage]
    refs = [_read_label(f) for f in a.refImage]
    masks = [_read_label(f) for f in a.mask] if a.mask else None
    if a.adapted:
        prec, rec, err = eval_ri(segs, refs, masks, adapted=True)
        print(f"{prec:.6g} {rec:.6g} {err:.6g}")
    else:
        print(f"{eval_ri(segs, refs, masks, adapted=False):.6g}")


def cmd_relabel(a):
    from ..infer.segment import relabel_image

    _write_label(a.output, relabel_image(_read_label(a.input), a.start))


def cmd_labelcc(a):
    from ..native import connected_components_native

    _write_label(a.output, connected_components_native(_read_label(a.input)))


def cmd_merge_order_bc(a):
    from ..features.config import FeatureConfig
    from ..graph.merge_bc import greedy_merge_bc
    from ..graph.rag import build_rag
    from ..io.text import write_merge_order, write_vector
    from ..models.forest import ForestModel, predict_label_fraction

    seg = _read_label(a.segImage)
    pb = _read_real(a.pbImage)
    intensity = _read_real(a.rawImage) if a.rawImage else None
    cfg = FeatureConfig.standard(pb, intensity, n_bins=a.bins,
                                 boundary_thresholds=tuple(a.bt))
    model = ForestModel.load(a.model)
    rag = build_rag(seg, contour_only=False)

    if a.engine == "device":
        from ..graph.merge_bc_device import merge_order_bc_device
        from ..models.forest import make_label_scorer

        dev = _device(a)
        order, sals = merge_order_bc_device(
            rag, cfg, make_label_scorer(model, label=-1, device=dev),
            device=dev)
    else:
        def predict(f):
            return float(
                predict_label_fraction(model, f[None, :], label=-1)[0])

        def predict_batch(F):
            return predict_label_fraction(model, F, label=-1)

        order, sals = greedy_merge_bc(rag, cfg, predict,
                                      predict_batch=predict_batch)
    if a.mergeOrder:
        write_merge_order(a.mergeOrder, order)
    if a.saliency:
        write_vector(a.saliency, sals)


def cmd_train_sshmt(a):
    from ..io.text import read_matrix, read_merge_order, read_vector
    from ..learn.sshmt import SshmtDefaults, train_sshmt

    feats = [read_matrix(f) for f in a.unsFeat]
    orders = [read_merge_order(f) for f in a.unsOrder]
    sup_x = np.concatenate([read_matrix(f) for f in a.supFeat]) \
        if a.supFeat else None
    sup_y = np.concatenate(
        [read_vector(f, dtype=np.int64) for f in a.supLabel]) \
        if a.supLabel else None
    d = SshmtDefaults(merge_target=a.mergeTarget,
                      max_path_length=a.maxPathLength,
                      min_path_length=a.minPathLength)
    out = train_sshmt(feats, orders, sup_x, sup_y,
                      classifier=a.classifier,
                      mlp_hidden=(a.n1, a.n2), wr=a.wr, wu=a.wu, ws=a.ws,
                      n_sigma_update=a.nSigmaUpdate,
                      inner_steps=a.innerSteps, optimizer=a.optimizer,
                      lr=a.step, defaults=d, verbose=a.verbose,
                      device=_device(a))
    np.savetxt(a.model, out["w"])


def cmd_pred_logsig(a):
    from ..io.text import read_matrix, write_vector
    from ..learn.predict import predict_logsig

    w = np.loadtxt(a.model)
    X = read_matrix(a.feat)
    write_vector(a.output, predict_logsig(w, X, device=_device(a)))


def cmd_pred_mlp(a):
    from ..io.text import read_matrix, write_vector
    from ..learn.predict import predict_mlp2

    w = np.loadtxt(a.model)
    X = read_matrix(a.feat)
    mm = read_matrix(a.minmax)
    write_vector(a.output, predict_mlp2(w, X, mm, a.n1, a.n2,
                                        device=_device(a)))


def cmd_gen_region_pairs(a):
    from ..link3d.link import gen_region_pairs

    s0 = _read_label(a.s0)
    s1 = _read_label(a.s1)
    pairs, _ = gen_region_pairs(s0, s1, a.id0, a.id1,
                                max_centroid_dist=a.cd)
    with open(a.output, "w") as f:
        for (i0, k0), (i1, k1) in pairs:
            f.write(f"{i0} {k0} {i1} {k1}\n")


def _read_pairs(path):
    rows = np.loadtxt(path, dtype=np.int64, ndmin=2)
    return [((int(r[0]), int(r[1])), (int(r[2]), int(r[3]))) for r in rows]


def cmd_sc_feat(a):
    from ..features.config import FeatureConfig
    from ..io.text import write_matrix
    from ..link3d.link import sc_features

    s0 = _read_label(a.s0)
    s1 = _read_label(a.s1)
    pb = _read_real(a.pbImage)
    cfg = FeatureConfig.standard(pb, n_bins=a.bins)
    pairs = _read_pairs(a.pairs)
    write_matrix(a.output, sc_features(s0, s1, cfg, pairs))


def cmd_sc_label(a):
    from ..io.text import write_vector
    from ..link3d.link import sc_labels

    s0 = _read_label(a.s0)
    s1 = _read_label(a.s1)
    t0 = _read_label(a.t0)
    t1 = _read_label(a.t1)
    pairs = _read_pairs(a.pairs)
    labels, _, _ = sc_labels(s0, t0, s1, t1, pairs)
    write_vector(a.output, labels, fmt="%d")


def cmd_link_by_threshold(a):
    from ..io.text import read_vector
    from ..link3d.link import link_by_threshold

    pairs = []
    for f in a.pairs:
        pairs += _read_pairs(f)
    scores = np.concatenate([read_vector(f) for f in a.scores])
    links = link_by_threshold(pairs, scores, a.minScore, a.forceLink)
    with open(a.output, "w") as f:
        for (i0, k0), (i1, k1) in links:
            f.write(f"{i0} {k0} {i1} {k1}\n")


def cmd_group_region_profiles(a):
    from ..io.image import write_image
    from ..link3d.link import group_region_profiles

    segs = [_read_label(f) for f in a.segImages]
    links = []
    for f in a.links:
        links += _read_pairs(f)
    vol = group_region_profiles(segs, a.ids, links, relabel=a.relabel)
    for i in range(vol.shape[0]):
        _write_label(a.output[i] if len(a.output) > 1 else
                     a.output[0].replace("%d", str(i)), vol[i])


def cmd_eval_init_seg(a):
    from ..tools import eval_init_seg

    seg = _read_label(a.segImage)
    truth = _read_label(a.truthImage)
    prec, rec, err, mapped = eval_init_seg(seg, truth)
    print(f"{prec:.6g} {rec:.6g} {err:.6g}")
    if a.output:
        _write_label(a.output, mapped)


def cmd_seg_stats(a):
    from ..tools import seg_stats

    for k, v in sorted(seg_stats(_read_label(a.segImage),
                                 include_bg=a.includeBG).items()):
        print(k, v)


def cmd_normalize_sample(a):
    from ..io.text import read_matrix, write_matrix
    from ..tools import normalize_samples

    feats = [read_matrix(f) for f in a.input]
    minmax = read_matrix(a.inputMinMax) if a.inputMinMax else None
    out, mm = normalize_samples(feats, minmax, a.outputMin, a.outputMax)
    for f, o in zip(a.output, out):
        write_matrix(f, o)
    if a.outputMinMax:
        write_matrix(a.outputMinMax, mm)


def cmd_eval_ri_threshold(a):
    from ..tools import eval_ri_threshold

    pbs = [_read_real(f) for f in a.resImage]
    refs = [_read_label(f) for f in a.refImage]
    rows = eval_ri_threshold(pbs, refs, lower=a.lower, upper=a.upper,
                             n_thresholds=a.nThreshold,
                             adapted=a.adapted,
                             use_watershed=a.useWatershed)
    for row in rows:
        print(" ".join(f"{x:.6g}" for x in row))


def cmd_match_seg_to_truth(a):
    from ..tools import match_seg_to_truth

    m = match_seg_to_truth(_read_label(a.segImage),
                           _read_label(a.truthImage))
    for t, (s, ji) in sorted(m.items()):
        print(f"{t}: {s} [{ji:.6g}]")


def cmd_maxpool_image(a):
    from ..ops.image import max_pool_image

    im = _read_real(a.input)
    out = max_pool_image(im, skip_dims=tuple(a.skipDims))
    from ..io.image import write_image

    write_image(a.output, (np.clip(out, 0, 1) * 255).astype(np.uint8))


def cmd_crop_image(a):
    from ..ops.image import crop_image
    from ..io.image import read_image, write_image

    im = read_image(a.input)
    write_image(a.output, crop_image(im, tuple(a.origin), tuple(a.size)))


def cmd_resample_image(a):
    from ..ops.image import resample_image
    from ..io.image import read_image, write_image

    im = read_image(a.input)
    write_image(a.output, resample_image(im, a.factor,
                                         order=0 if a.label else 1))


def cmd_acc_images(a):
    from ..ops.image import accumulate_images
    from ..io.image import write_image

    out = accumulate_images([_read_real(f) for f in a.input],
                            average=a.average)
    write_image(a.output, (np.clip(out, 0, 1) * 255).astype(np.uint8))


def cmd_vol_to_slices(a):
    from ..io.image import read_image, write_image

    vol = read_image(a.input)
    for z in range(vol.shape[0]):
        write_image(a.output.replace("%d", str(z)), vol[z])


def cmd_threshold_image(a):
    from ..ops.image import threshold_image

    im = _read_real(a.input)
    _write_label(a.output, threshold_image(im, a.lower, a.upper,
                                           a.inside, a.outside))


def cmd_blur_image(a):
    from ..io.image import write_image
    from ..ops.image import blur_image

    out = blur_image(_read_real(a.input), a.sigma)
    write_image(a.output, (np.clip(out, 0, 1) * 255).astype(np.uint8))


def cmd_boundary_image_2d(a):
    from ..io.image import write_image
    from ..ops.image import boundary_image_2d

    out = boundary_image_2d(_read_label(a.input))
    write_image(a.output, (out * 255).astype(np.uint8))


def cmd_label_image_stats(a):
    from ..tools import label_image_stats

    st = label_image_stats(_read_label(a.image),
                           mask=_read_label(a.mask) if a.mask else None)
    print("unique labels:", st["unique_labels"])
    print("min size:", st["min_size"])
    print("max size:", st["max_size"])
    print("size hist:", " ".join(f"{x:g}" for x in st["size_hist"]))


def cmd_distribute_label_images(a):
    from ..io.image import read_label_image
    from ..tools import distribute_label_images

    images = [read_label_image(f) for f in a.input]
    idx = distribute_label_images(images, a.nOutput, a.areaThreshold,
                                  include_bg=a.includeBG, rng=a.seed)
    for i, src in enumerate(idx):
        _write_label(a.output.replace("%d", str(i)), images[src])


def cmd_resample_rgb_image(a):
    from ..io.image import read_image, write_image
    from ..ops.image import resample_image

    im = read_image(a.input)
    if im.ndim != 3 or im.shape[-1] not in (3, 4):
        raise SystemExit("expected an RGB(A) image")
    chans = [resample_image(im[..., c].astype(np.float64), a.factor,
                            order=1) for c in range(im.shape[-1])]
    out = np.clip(np.stack(chans, axis=-1), 0, 255)
    write_image(a.output, out.astype(im.dtype))


def cmd_image_compression(a):
    from ..io.image import read_image, write_image

    im = read_image(a.input)
    if a.write16:
        im = im.astype(np.uint16)
    write_image(a.output, im)


def cmd_overlay_image(a):
    from ..io.image import write_image
    from ..ops.image import overlay_image

    labels = _read_label(a.labelImage)
    base = _read_real(a.bgImage) if a.bgImage else np.zeros(
        labels.shape, np.float64)
    out = overlay_image(base, labels, alpha=a.opacity)
    if a.drawBoundary:
        # boundary pixels: any 4-neighbor with a different label
        b = np.zeros(labels.shape, bool)
        b[:-1, :] |= labels[:-1, :] != labels[1:, :]
        b[1:, :] |= labels[1:, :] != labels[:-1, :]
        b[:, :-1] |= labels[:, :-1] != labels[:, 1:]
        b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
        out[b] = np.asarray(a.boundaryRGB, np.float64)[:3] / 255.0
    write_image(a.output, (np.clip(out, 0, 1) * 255).astype(np.uint8))


def cmd_gen_image_patches(a):
    from ..io.text import write_matrix
    from ..ops.image import image_patches

    im = _read_real(a.valImage)
    r = a.radius if len(a.radius) == im.ndim else a.radius * im.ndim
    size = tuple(2 * x + 1 for x in r)
    stride = tuple(a.stride if len(a.stride) == im.ndim
                   else a.stride * im.ndim) if a.stride else (1,) * im.ndim
    patches = image_patches(im, size, stride)
    write_matrix(a.patch, patches.reshape(len(patches), -1))


def cmd_unique_sample(a):
    from ..io.text import read_matrix, read_vector, write_matrix, \
        write_vector
    from ..tools import unique_samples

    feats = np.concatenate([read_matrix(f) for f in a.feat])
    labels = np.concatenate([read_vector(f) for f in a.label])
    uf, ul = unique_samples(feats, labels)
    write_matrix(a.ufeat, uf)
    write_vector(a.ulabel, ul, fmt="%d")


def cmd_distribute_samples(a):
    from ..io.text import read_matrix, read_vector, write_matrix, \
        write_vector
    from ..tools import distribute_samples

    feats = np.concatenate([read_matrix(f) for f in a.feat])
    labels = np.concatenate([read_vector(f) for f in a.label])
    groups = distribute_samples(feats, labels, a.i0, a.i1, a.threshold)
    if len(a.outFeat) != len(groups) or len(a.outLabel) != len(groups):
        raise SystemExit(f"need {len(groups)} output feature and label "
                         f"files (small/medium/large groups)")
    for (gf, gl), ff, lf in zip(groups, a.outFeat, a.outLabel):
        write_matrix(ff, gf)
        write_vector(lf, gl, fmt="%d")


def cmd_select_hard_samples(a):
    from ..io.text import read_matrix, read_vector, write_matrix, \
        write_vector
    from ..tools import select_hard_samples

    feats = np.concatenate([read_matrix(f) for f in a.feat])
    labels = np.concatenate([read_vector(f) for f in a.label])
    preds = np.concatenate([read_vector(f) for f in a.pred])
    hf, hl = select_hard_samples(feats, labels, preds, label0=a.l0,
                                 label1=a.l1, threshold0=a.t0,
                                 threshold1=a.t1)
    write_matrix(a.outFeat, hf)
    write_vector(a.outLabel, hl, fmt="%d")


def cmd_match_truth_to_seg(a):
    from ..tools import match_truth_to_seg, seg_stats

    seg = _read_label(a.segImage)
    truth = _read_label(a.truthImage)
    mask = _read_label(a.mask) if a.mask else None
    m = match_truth_to_seg(seg, truth, mask)
    if a.minSegSize > 0:
        sizes = seg_stats(seg, mask=mask, include_bg=True)
        m = {s: tl for s, tl in m.items() if sizes.get(s, 0) >= a.minSegSize}
    for s, (t, ji) in sorted(m.items()):
        print(f"{s}: {t} [{ji:.6g}]")


def cmd_labelscc(a):
    from ..ops.image import scalar_connected_components

    _write_label(a.output,
                 scalar_connected_components(_read_label(a.input), a.diff))


def cmd_labelicc(a):
    from ..ops.image import identity_connected_components

    mask = _read_label(a.mask) if a.mask else None
    _write_label(a.output,
                 identity_connected_components(_read_label(a.input), mask))


def build_parser():
    p = argparse.ArgumentParser(prog="glia_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    # every subcommand takes --device; those that run torch work use it
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device of the subcommands that run "
                             "torch work (default: the CUDA card)")

    def add(name, **kw):
        return sub.add_parser(name, parents=[common], **kw)

    q = add("watershed", help="initial superpixels")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("-l", "--level", type=float, default=0.0)
    q.add_argument("-r", "--relabel", action="store_true")
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_watershed)

    q = add("pre_merge", help="merge small/dark fragments")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-p", "--pbImage", required=True)
    q.add_argument("-t", "--sizeThresholds", type=int, nargs="+",
                   default=[50])
    q.add_argument("-b", "--rpbThreshold", type=float, default=0.5)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_pre_merge)

    q = add("merge_order_pb", help="greedy merge order from pb")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-p", "--pbImage", required=True)
    q.add_argument("-t", "--type", default="median",
                   choices=["median", "mean", "median_minsize"])
    q.add_argument("-m", "--maskImage")
    q.add_argument("-o", "--mergeOrder")
    q.add_argument("-y", "--saliency")
    q.add_argument("--engine", default="host", choices=["host", "device"],
                   help="host: exact serial C++ loop; device: batched "
                        "multi-phase merge on --device")
    q.set_defaults(fn=cmd_merge_order_pb)

    q = add("bc_feat", help="boundary classifier features")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-p", "--pbImage", required=True)
    q.add_argument("--rawImage")
    q.add_argument("-o", "--mergeOrder", required=True)
    q.add_argument("-y", "--saliency")
    q.add_argument("--bins", type=int, default=16)
    q.add_argument("--bt", type=float, nargs="+", default=[0.2, 0.5, 0.8])
    q.add_argument("--normalizeShape", action="store_true")
    q.add_argument("--logShape", action="store_true")
    q.add_argument("--simple", action="store_true")
    q.add_argument("-m", "--maskImage")
    q.add_argument("-b", "--bfeat", required=True)
    q.set_defaults(fn=cmd_bc_feat)

    q = add("bc_label", help="merge/split training labels")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-t", "--truthImage", required=True)
    q.add_argument("-o", "--mergeOrder", required=True)
    q.add_argument("--rule", default="f1", choices=["f1", "vi", "ri"])
    q.add_argument("--tweak", action="store_true")
    q.add_argument("--maxPrecDrop", type=float, default=1.0)
    q.add_argument("-l", "--output", required=True)
    q.set_defaults(fn=cmd_bc_label)

    q = add("train_rf", help="train random forest")
    q.add_argument("-f", "--feat", nargs="+", required=True)
    q.add_argument("-l", "--label", nargs="+", required=True)
    q.add_argument("--nTree", type=int, default=255)
    q.add_argument("--sampleRatio", type=float, default=0.7)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("-m", "--model", required=True)
    q.set_defaults(fn=cmd_train_rf)

    q = add("pred_rf", help="predict merge probabilities")
    q.add_argument("-m", "--model", required=True)
    q.add_argument("-f", "--feat", required=True)
    q.add_argument("--label", type=int, default=-1)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_pred_rf)

    for name in ("segment_greedy", "segment_ccm"):
        q = add(name, help=f"{name} final segmentation")
        q.add_argument("-s", "--segImage", required=True)
        q.add_argument("-o", "--mergeOrder", required=True)
        q.add_argument("-p", "--mergeProbs", required=True)
        q.add_argument("-r", "--relabel", action="store_true")
        q.add_argument("-f", "--output", required=True)
        mode = "greedy" if name.endswith("greedy") else "ccm"
        q.set_defaults(fn=lambda a, m=mode: cmd_segment(a, m))

    q = add("apply_merges", help="replay merge order")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-o", "--mergeOrder", required=True)
    q.add_argument("-y", "--saliency")
    q.add_argument("-n", type=int, default=None,
                   help="number of merges to apply")
    q.add_argument("--saliencyThreshold", type=float, default=None)
    q.add_argument("-f", "--output", required=True)
    q.set_defaults(fn=cmd_apply_merges)

    q = add("eval_vi", help="VI: falseSplit falseMerge total")
    q.add_argument("-p", "--resImage", nargs="+", required=True)
    q.add_argument("-r", "--refImage", nargs="+", required=True)
    q.add_argument("-m", "--mask", nargs="*", default=None)
    q.set_defaults(fn=cmd_eval_vi)

    q = add("eval_ri", help="adapted Rand: prec rec error")
    q.add_argument("-p", "--resImage", nargs="+", required=True)
    q.add_argument("-r", "--refImage", nargs="+", required=True)
    q.add_argument("-m", "--mask", nargs="*", default=None)
    q.add_argument("-a", "--adapted", type=lambda s: s != "0",
                   default=True)
    q.set_defaults(fn=cmd_eval_ri)

    q = add("merge_order_bc", help="classifier-driven merge order")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-p", "--pbImage", required=True)
    q.add_argument("--rawImage")
    q.add_argument("-m", "--model", required=True)
    q.add_argument("--bins", type=int, default=16)
    q.add_argument("--bt", type=float, nargs="+", default=[0.2, 0.5, 0.8])
    q.add_argument("-o", "--mergeOrder")
    q.add_argument("-y", "--saliency")
    q.add_argument("--engine", default="host", choices=["host", "device"],
                   help="host: serial classifier-in-the-loop engine; "
                        "device: batched superstep engine + feature "
                        "assembly and forest scoring on --device")
    q.set_defaults(fn=cmd_merge_order_bc)

    q = add("train_sshmt", help="semi-supervised training")
    q.add_argument("--unsFeat", nargs="+", required=True)
    q.add_argument("--unsOrder", nargs="+", required=True)
    q.add_argument("--supFeat", nargs="*", default=[])
    q.add_argument("--supLabel", nargs="*", default=[])
    q.add_argument("--classifier", default="logsig",
                   choices=["logsig", "mlp2"])
    q.add_argument("--n1", type=int, default=10)
    q.add_argument("--n2", type=int, default=5)
    q.add_argument("--wr", type=float, default=1.0)
    q.add_argument("--wu", type=float, default=1.0)
    q.add_argument("--ws", type=float, default=1.0)
    q.add_argument("--mergeTarget", type=float, default=0.95)
    q.add_argument("--maxPathLength", type=int, default=3)
    q.add_argument("--minPathLength", type=int, default=2)
    q.add_argument("--nSigmaUpdate", type=int, default=10)
    q.add_argument("--innerSteps", type=int, default=100)
    q.add_argument("--optimizer", default="adam",
                   choices=["adam", "momentum", "gd"])
    q.add_argument("--step", type=float, default=0.1)
    q.add_argument("-v", "--verbose", action="store_true")
    q.add_argument("-m", "--model", required=True)
    q.set_defaults(fn=cmd_train_sshmt)

    q = add("pred_logsig", help="logsig merge probabilities")
    q.add_argument("-m", "--model", required=True)
    q.add_argument("-f", "--feat", required=True)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_pred_logsig)

    q = add("pred_mlp", help="MLP2 merge probabilities")
    q.add_argument("-m", "--model", required=True)
    q.add_argument("-f", "--feat", required=True)
    q.add_argument("--minmax", required=True)
    q.add_argument("--n1", type=int, default=10)
    q.add_argument("--n2", type=int, default=5)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_pred_mlp)

    q = add("gen_region_pairs", help="cross-section candidates")
    q.add_argument("--s0", required=True)
    q.add_argument("--s1", required=True)
    q.add_argument("--id0", type=int, required=True)
    q.add_argument("--id1", type=int, required=True)
    q.add_argument("--cd", type=float, default=-1.0)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_gen_region_pairs)

    q = add("sc_feat", help="section-pair features")
    q.add_argument("--s0", required=True)
    q.add_argument("--s1", required=True)
    q.add_argument("-p", "--pbImage", required=True)
    q.add_argument("--pairs", required=True)
    q.add_argument("--bins", type=int, default=16)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_sc_feat)

    q = add("sc_label", help="section-pair labels")
    q.add_argument("--s0", required=True)
    q.add_argument("--s1", required=True)
    q.add_argument("--t0", required=True)
    q.add_argument("--t1", required=True)
    q.add_argument("--pairs", required=True)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_sc_label)

    q = add("link_by_threshold", help="threshold linking")
    q.add_argument("--pairs", nargs="+", required=True)
    q.add_argument("--scores", nargs="+", required=True)
    q.add_argument("--minScore", type=float, required=True)
    q.add_argument("--forceLink", type=lambda s: s != "0", default=True)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_link_by_threshold)

    q = add("group_region_profiles", help="links -> 3D labels")
    q.add_argument("-s", "--segImages", nargs="+", required=True)
    q.add_argument("--ids", type=int, nargs="+", required=True)
    q.add_argument("-l", "--links", nargs="+", required=True)
    q.add_argument("-r", "--relabel", action="store_true")
    q.add_argument("-o", "--output", nargs="+", required=True)
    q.set_defaults(fn=cmd_group_region_profiles)

    q = add("eval_init_seg", help="oracle upper bound")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-t", "--truthImage", required=True)
    q.add_argument("-o", "--output")
    q.set_defaults(fn=cmd_eval_init_seg)

    q = add("seg_stats", help="region sizes")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-b", "--includeBG", action="store_true")
    q.set_defaults(fn=cmd_seg_stats)

    q = add("normalize_sample", help="min-max rescale features")
    q.add_argument("-i", "--input", nargs="+", required=True)
    q.add_argument("--inputMinMax")
    q.add_argument("--outputMin", type=float, default=-1.0)
    q.add_argument("--outputMax", type=float, default=1.0)
    q.add_argument("-o", "--output", nargs="+", required=True)
    q.add_argument("--outputMinMax")
    q.set_defaults(fn=cmd_normalize_sample)

    q = add("eval_ri_threshold", help="Rand error vs threshold")
    q.add_argument("-p", "--resImage", nargs="+", required=True)
    q.add_argument("-r", "--refImage", nargs="+", required=True)
    q.add_argument("--lower", type=float, default=0.0)
    q.add_argument("--upper", type=float, default=1.0)
    q.add_argument("-n", "--nThreshold", type=int, default=10)
    q.add_argument("-a", "--adapted", type=lambda s: s != "0", default=True)
    q.add_argument("-w", "--useWatershed", action="store_true")
    q.set_defaults(fn=cmd_eval_ri_threshold)

    q = add("match_seg_to_truth", help="best-Jaccard matches")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-t", "--truthImage", required=True)
    q.set_defaults(fn=cmd_match_seg_to_truth)

    q = add("maxpool_image", help="2x max pooling")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("--skipDims", type=int, nargs="*", default=[])
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_maxpool_image)

    q = add("crop_image", help="crop by origin/size")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("--origin", type=int, nargs="+", required=True)
    q.add_argument("--size", type=int, nargs="+", required=True)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_crop_image)

    q = add("resample_image", help="zoom resample")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("--factor", type=float, required=True)
    q.add_argument("--label", action="store_true",
                   help="nearest-neighbor for label images")
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_resample_image)

    q = add("acc_images", help="accumulate images")
    q.add_argument("-i", "--input", nargs="+", required=True)
    q.add_argument("--average", action="store_true")
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_acc_images)

    q = add("image_vol_to_slices", help="split volume to slices")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("-o", "--output", required=True,
                   help="pattern containing %%d")
    q.set_defaults(fn=cmd_vol_to_slices)

    q = add("threshold_image", help="binary threshold")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("--lower", type=float, default=0.0)
    q.add_argument("--upper", type=float, default=1.0)
    q.add_argument("--inside", type=int, default=1)
    q.add_argument("--outside", type=int, default=0)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_threshold_image)

    q = add("blur_image", help="gaussian blur")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("--sigma", type=float, required=True)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_blur_image)

    q = add("boundary_image_2d", help="BSDS boundary raster")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_boundary_image_2d)

    q = add("relabel_image", help="relabel by size")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("--start", type=int, default=0)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_relabel)

    q = add("labelcc_image", help="connected components")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_labelcc)

    q = add("label_image_stats",
                       help="region count/size summary")
    q.add_argument("-i", "--image", required=True)
    q.add_argument("-m", "--mask")
    q.set_defaults(fn=cmd_label_image_stats)

    q = add("distribute_label_images",
                       help="pick/duplicate label images by region count")
    q.add_argument("-i", "--input", nargs="+", required=True)
    q.add_argument("-n", "--nOutput", type=int, required=True)
    q.add_argument("-t", "--areaThreshold", type=int, required=True)
    q.add_argument("-b", "--includeBG", action="store_true")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("-o", "--output", required=True,
                   help="output pattern with %%d")
    q.set_defaults(fn=cmd_distribute_label_images)

    q = add("resample_rgb_image",
                       help="linear resample per RGB channel")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("-f", "--factor", type=float, required=True)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_resample_rgb_image)

    q = add("image_compression",
                       help="rewrite image (optional 16-bit cast)")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("--write16", action="store_true")
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_image_compression)

    q = add("overlay_image",
                       help="colorized label overlay for inspection")
    q.add_argument("-l", "--labelImage", required=True)
    q.add_argument("-i", "--bgImage")
    q.add_argument("-p", "--opacity", type=float, default=0.6)
    q.add_argument("-b", "--drawBoundary", type=lambda s: s != "0",
                   default=True)
    q.add_argument("--boundaryRGB", type=int, nargs=3, default=[0, 0, 0])
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_overlay_image)

    q = add("gen_image_patches",
                       help="sliding-window patches -> text matrix")
    q.add_argument("-i", "--valImage", required=True)
    q.add_argument("-r", "--radius", type=int, nargs="+", required=True)
    q.add_argument("--stride", type=int, nargs="+", default=None)
    q.add_argument("-o", "--patch", required=True)
    q.set_defaults(fn=cmd_gen_image_patches)

    q = add("unique_sample", help="drop duplicate sample rows")
    q.add_argument("-f", "--feat", nargs="+", required=True)
    q.add_argument("-l", "--label", nargs="+", required=True)
    q.add_argument("-u", "--ufeat", required=True)
    q.add_argument("-o", "--ulabel", required=True)
    q.set_defaults(fn=cmd_unique_sample)

    q = add("distribute_samples",
                       help="3-way split by area-feature threshold")
    q.add_argument("-f", "--feat", nargs="+", required=True)
    q.add_argument("-l", "--label", nargs="+", required=True)
    q.add_argument("--i0", type=int, required=True)
    q.add_argument("--i1", type=int, required=True)
    q.add_argument("-t", "--threshold", type=float, required=True)
    q.add_argument("--outFeat", nargs="+", required=True)
    q.add_argument("--outLabel", nargs="+", required=True)
    q.set_defaults(fn=cmd_distribute_samples)

    q = add("select_hard_samples",
                       help="keep misclassified samples")
    q.add_argument("-f", "--feat", nargs="+", required=True)
    q.add_argument("-l", "--label", nargs="+", required=True)
    q.add_argument("-p", "--pred", nargs="+", required=True)
    q.add_argument("--l0", type=int, default=1)
    q.add_argument("--l1", type=int, default=-1)
    q.add_argument("--t0", type=float, default=0.5)
    q.add_argument("--t1", type=float, default=0.5)
    q.add_argument("--outFeat", required=True)
    q.add_argument("--outLabel", required=True)
    q.set_defaults(fn=cmd_select_hard_samples)

    q = add("match_truth_to_seg",
                       help="best-Jaccard truth label per seg region")
    q.add_argument("-s", "--segImage", required=True)
    q.add_argument("-t", "--truthImage", required=True)
    q.add_argument("-m", "--mask")
    q.add_argument("--mins", dest="minSegSize", type=int, default=0)
    q.set_defaults(fn=cmd_match_truth_to_seg)

    q = add("labelscc_image",
                       help="scalar CC (neighbors within diff join)")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("-d", "--diff", type=float, default=0)
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_labelscc)

    q = add("labelicc_image",
                       help="relabel equal-label connected components")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("-m", "--mask")
    q.add_argument("-o", "--output", required=True)
    q.set_defaults(fn=cmd_labelicc)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
