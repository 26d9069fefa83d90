"""The port's CLI (glia_tpu_torch.cli) against glia_tpu's, subcommand by
subcommand, on the same files.

Inputs: a 64x64 synthetic section (seed 6, 10 cells) as PNG images (pb,
raw intensity, truth), two sections of a (4, 48, 48) stack (seed 5) for
the LINK3D subcommands, and every intermediate file of the file bus
(watershed, pre-merge, merge order, saliencies, BC features with and
without the saliency columns, labels, forests, probabilities, section
pairs, link scores, SSHMT weights, ...) written once by glia_tpu's own
CLI.  Each subcommand then runs in glia_tpu's ``main`` and in the port's
``main`` (with ``--device cpu``), each writing into its own directory, and
every output file must be equal byte for byte and the printed lines
equal.  Exceptions, each with the tolerance of the library call's own
parity test:

- forests (``train_rf``): the ``.npz`` holds the same node arrays (the
  port's file also records the training width);
- SSHMT weights (``train_sshmt``): max |w - w_glia_tpu| <= 1e-6 of the
  largest (tests/test_torch_learn.py);
- Logsig / MLP2 probabilities (``pred_logsig``, ``pred_mlp``): rtol 1e-12
  (float64 on both sides, another order of summation).

``merge_order_pb`` and ``merge_order_bc`` run with both engines; with
``--engine device`` they run glia_tpu_torch's multi-phase device merge and
its classifier-in-the-loop device merge on the CPU.
"""

import contextlib
import importlib
import io

import numpy as np
import pytest

from glia_tpu.data.synthetic import synthetic_em_slice, synthetic_em_stack
from glia_tpu.io.image import write_image

glia_cli = importlib.import_module("glia_tpu.cli.main")
port_cli = importlib.import_module("glia_tpu_torch.cli.main")

W_RTOL = 1e-6
PRED_RTOL = 1e-12


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every input file, written by glia_tpu (the reference)."""
    d = tmp_path_factory.mktemp("cli_in")
    s = synthetic_em_slice((64, 64), n_cells=10, seed=6)
    write_image(str(d / "pb.png"), (s["pb"] * 255).astype(np.uint8))
    write_image(str(d / "raw.png"), (s["intensity"] * 255).astype(np.uint8))
    write_image(str(d / "truth.png"), s["truth"].astype(np.uint16))
    stack = synthetic_em_stack((4, 48, 48), n_cells=8, seed=5)
    for z in range(2):
        sl = stack["slices"][z]
        write_image(str(d / f"s{z}.png"), sl["truth"].astype(np.uint16))
        write_image(str(d / f"pb{z}.png"), (sl["pb"] * 255).astype(np.uint8))
    write_image(str(d / "vol.tif"),
                (stack["pb3d"][:3] * 255).astype(np.uint8))
    rgb = np.random.default_rng(3).integers(0, 255, (16, 16, 3),
                                            dtype=np.uint8)
    write_image(str(d / "rgb.png"), rgb)

    def g(*args):
        run(glia_cli.main, [a.format(i=d) for a in args])

    g("watershed", "-i", "{i}/pb.png", "-l", "0.05", "-o", "{i}/ws.png")
    g("pre_merge", "-s", "{i}/ws.png", "-p", "{i}/pb.png", "-t", "20",
      "-o", "{i}/seg0.png")
    g("merge_order_pb", "-s", "{i}/seg0.png", "-p", "{i}/pb.png",
      "-o", "{i}/order.txt", "-y", "{i}/sal.txt")
    g("bc_feat", "-s", "{i}/seg0.png", "-p", "{i}/pb.png", "-o",
      "{i}/order.txt", "-y", "{i}/sal.txt", "--bins", "8", "-b",
      "{i}/feat.txt")
    # the vector of the BC engines: no saliency columns, merge_order_bc's
    # bins and images
    g("bc_feat", "-s", "{i}/seg0.png", "-p", "{i}/pb.png", "--rawImage",
      "{i}/raw.png", "-o", "{i}/order.txt", "-b", "{i}/feat_bc.txt")
    g("bc_feat", "-s", "{i}/seg0.png", "-p", "{i}/pb.png", "-o",
      "{i}/order.txt", "-y", "{i}/sal.txt", "--simple", "-b",
      "{i}/simple.txt")
    g("bc_label", "-s", "{i}/seg0.png", "-t", "{i}/truth.png", "-o",
      "{i}/order.txt", "-l", "{i}/labels.txt")
    g("train_rf", "-f", "{i}/feat.txt", "-l", "{i}/labels.txt", "--nTree",
      "15", "-m", "{i}/rf.npz")
    g("train_rf", "-f", "{i}/feat_bc.txt", "-l", "{i}/labels.txt",
      "--nTree", "15", "-m", "{i}/rf_bc.npz")
    g("pred_rf", "-m", "{i}/rf.npz", "-f", "{i}/feat.txt", "-o",
      "{i}/probs.txt")
    g("normalize_sample", "-i", "{i}/simple.txt", "-o", "{i}/simple_n.txt",
      "--outputMinMax", "{i}/minmax.txt")
    g("train_sshmt", "--unsFeat", "{i}/simple_n.txt", "--unsOrder",
      "{i}/order.txt", "--supFeat", "{i}/simple_n.txt", "--supLabel",
      "{i}/labels.txt", "--innerSteps", "20", "--nSigmaUpdate", "2",
      "-m", "{i}/logsig.txt")
    g("train_sshmt", "--unsFeat", "{i}/simple.txt", "--unsOrder",
      "{i}/order.txt", "--classifier", "mlp2", "--n1", "4", "--n2", "3",
      "--innerSteps", "5", "--nSigmaUpdate", "1", "-m", "{i}/mlp.txt")
    g("gen_region_pairs", "--s0", "{i}/s0.png", "--s1", "{i}/s1.png",
      "--id0", "0", "--id1", "1", "-o", "{i}/pairs.txt")
    n_pairs = len(np.loadtxt(d / "pairs.txt", ndmin=2))
    np.savetxt(d / "scores.txt",
               np.random.default_rng(8).random(n_pairs), fmt="%.17g")
    g("link_by_threshold", "--pairs", "{i}/pairs.txt", "--scores",
      "{i}/scores.txt", "--minScore", "0.5", "-o", "{i}/links.txt")
    return d


S, P = "{i}/seg0.png", "{i}/pb.png"
FEAT, LAB = "{i}/feat.txt", "{i}/labels.txt"
# name -> (argv, output files, comparison)
CASES = {
    "watershed": (["-i", P, "-l", "0.05", "-o", "{o}/ws.png"], ["ws.png"]),
    "watershed_relabel": (["-i", P, "-l", "0.05", "-r", "-o",
                           "{o}/ws.png"], ["ws.png"]),
    "pre_merge": (["-s", "{i}/ws.png", "-p", P, "-t", "20", "40", "-o",
                   "{o}/seg0.png"], ["seg0.png"]),
    "merge_order_pb": (["-s", S, "-p", P, "-o", "{o}/order.txt", "-y",
                        "{o}/sal.txt"], ["order.txt", "sal.txt"]),
    "merge_order_pb_device_mean": (
        ["-s", S, "-p", P, "-t", "mean", "--engine", "device", "-o",
         "{o}/order.txt", "-y", "{o}/sal.txt"], ["order.txt", "sal.txt"]),
    "merge_order_pb_device_median": (
        ["-s", S, "-p", P, "--engine", "device", "-o", "{o}/order.txt",
         "-y", "{o}/sal.txt"], ["order.txt", "sal.txt"]),
    "bc_feat": (["-s", S, "-p", P, "--rawImage", "{i}/raw.png", "-o",
                 "{i}/order.txt", "-y", "{i}/sal.txt", "--bins", "8",
                 "-b", "{o}/feat.txt"], ["feat.txt"]),
    "bc_label": (["-s", S, "-t", "{i}/truth.png", "-o", "{i}/order.txt",
                  "-l", "{o}/labels.txt"], ["labels.txt"]),
    "train_rf": (["-f", FEAT, "-l", LAB, "--nTree", "15", "-m",
                  "{o}/rf.npz"], ["rf.npz"], "forest"),
    "pred_rf": (["-m", "{i}/rf.npz", "-f", FEAT, "-o", "{o}/probs.txt"],
                ["probs.txt"]),
    "segment_greedy": (["-s", S, "-o", "{i}/order.txt", "-p",
                        "{i}/probs.txt", "-f", "{o}/final.png"],
                       ["final.png"]),
    "segment_ccm": (["-s", S, "-o", "{i}/order.txt", "-p", "{i}/probs.txt",
                     "-r", "-f", "{o}/final.png"], ["final.png"]),
    "apply_merges": (["-s", S, "-o", "{i}/order.txt", "-n", "5", "-f",
                      "{o}/merged.png"], ["merged.png"]),
    "eval_vi": (["-p", S, "-r", "{i}/truth.png"], []),
    "eval_ri": (["-p", S, "{i}/ws.png", "-r", "{i}/truth.png",
                 "{i}/truth.png"], []),
    "merge_order_bc": (["-s", S, "-p", P, "--rawImage", "{i}/raw.png",
                        "-m", "{i}/rf_bc.npz", "-o", "{o}/order.txt", "-y",
                        "{o}/sal.txt"], ["order.txt", "sal.txt"]),
    "merge_order_bc_device": (
        ["-s", S, "-p", P, "--rawImage", "{i}/raw.png", "-m",
         "{i}/rf_bc.npz", "--engine", "device", "-o", "{o}/order.txt",
         "-y", "{o}/sal.txt"], ["order.txt", "sal.txt"]),
    "train_sshmt": (["--unsFeat", "{i}/simple_n.txt", "--unsOrder",
                     "{i}/order.txt", "--supFeat", "{i}/simple_n.txt",
                     "--supLabel", LAB, "--innerSteps", "20",
                     "--nSigmaUpdate", "2", "-m", "{o}/w.txt"], ["w.txt"],
                    "weights"),
    "pred_logsig": (["-m", "{i}/logsig.txt", "-f", "{i}/simple_n.txt",
                     "-o", "{o}/p.txt"], ["p.txt"], "probabilities"),
    "pred_mlp": (["-m", "{i}/mlp.txt", "-f", "{i}/simple.txt", "--minmax",
                  "{i}/minmax.txt", "--n1", "4", "--n2", "3", "-o",
                  "{o}/p.txt"], ["p.txt"], "probabilities"),
    "gen_region_pairs": (["--s0", "{i}/s0.png", "--s1", "{i}/s1.png",
                          "--id0", "0", "--id1", "1", "--cd", "12", "-o",
                          "{o}/pairs.txt"], ["pairs.txt"]),
    "sc_feat": (["--s0", "{i}/s0.png", "--s1", "{i}/s1.png", "-p",
                 "{i}/pb0.png", "--pairs", "{i}/pairs.txt", "--bins", "8",
                 "-o", "{o}/sc.txt"], ["sc.txt"]),
    "sc_label": (["--s0", "{i}/s0.png", "--s1", "{i}/s1.png", "--t0",
                  "{i}/s0.png", "--t1", "{i}/s1.png", "--pairs",
                  "{i}/pairs.txt", "-o", "{o}/sc_labels.txt"],
                 ["sc_labels.txt"]),
    "link_by_threshold": (["--pairs", "{i}/pairs.txt", "--scores",
                           "{i}/scores.txt", "--minScore", "0.7", "-o",
                           "{o}/links.txt"], ["links.txt"]),
    "group_region_profiles": (["-s", "{i}/s0.png", "{i}/s1.png", "--ids",
                               "0", "1", "-l", "{i}/links.txt", "-r", "-o",
                               "{o}/vol%d.png"], ["vol0.png", "vol1.png"]),
    "eval_init_seg": (["-s", S, "-t", "{i}/truth.png", "-o",
                       "{o}/mapped.png"], ["mapped.png"]),
    "seg_stats": (["-s", S], []),
    "normalize_sample": (["-i", FEAT, FEAT, "-o", "{o}/n0.txt",
                          "{o}/n1.txt", "--outputMinMax", "{o}/mm.txt"],
                         ["n0.txt", "n1.txt", "mm.txt"]),
    "eval_ri_threshold": (["-p", P, "-r", "{i}/truth.png", "-n", "3"], []),
    "match_seg_to_truth": (["-s", S, "-t", "{i}/truth.png"], []),
    "maxpool_image": (["-i", P, "-o", "{o}/mp.png"], ["mp.png"]),
    "crop_image": (["-i", P, "--origin", "2", "3", "--size", "8", "9",
                    "-o", "{o}/crop.png"], ["crop.png"]),
    "resample_image": (["-i", S, "--factor", "0.5", "--label", "-o",
                        "{o}/rs.png"], ["rs.png"]),
    "acc_images": (["-i", P, "{i}/raw.png", "--average", "-o",
                    "{o}/acc.png"], ["acc.png"]),
    "image_vol_to_slices": (["-i", "{i}/vol.tif", "-o", "{o}/z%d.png"],
                            ["z0.png", "z1.png", "z2.png"]),
    "threshold_image": (["-i", P, "--lower", "0.2", "--upper", "0.6",
                         "-o", "{o}/th.png"], ["th.png"]),
    "blur_image": (["-i", P, "--sigma", "1.5", "-o", "{o}/blur.png"],
                   ["blur.png"]),
    "boundary_image_2d": (["-i", S, "-o", "{o}/bd.png"], ["bd.png"]),
    "relabel_image": (["-i", S, "--start", "1", "-o", "{o}/rl.png"],
                      ["rl.png"]),
    "labelcc_image": (["-i", S, "-o", "{o}/cc.png"], ["cc.png"]),
    "label_image_stats": (["-i", S], []),
    "distribute_label_images": (["-i", S, "{i}/ws.png", "{i}/truth.png",
                                 "-n", "2", "-t", "4", "-o",
                                 "{o}/d%d.png"], ["d0.png", "d1.png"]),
    "resample_rgb_image": (["-i", "{i}/rgb.png", "-f", "2.0", "-o",
                            "{o}/rgb2.png"], ["rgb2.png"]),
    "image_compression": (["-i", S, "--write16", "-o", "{o}/c.png"],
                          ["c.png"]),
    "overlay_image": (["-l", S, "-i", P, "-p", "0.5", "-o",
                       "{o}/ov.png"], ["ov.png"]),
    "gen_image_patches": (["-i", P, "-r", "2", "--stride", "9", "-o",
                           "{o}/patches.txt"], ["patches.txt"]),
    "unique_sample": (["-f", FEAT, FEAT, "-l", LAB, LAB, "-u",
                       "{o}/uf.txt", "-o", "{o}/ul.txt"],
                      ["uf.txt", "ul.txt"]),
    "distribute_samples": (["-f", FEAT, "-l", LAB, "--i0", "0", "--i1",
                            "1", "-t", "0.01", "--outFeat", "{o}/f0.txt",
                            "{o}/f1.txt", "{o}/f2.txt", "--outLabel",
                            "{o}/l0.txt", "{o}/l1.txt", "{o}/l2.txt"],
                           ["f0.txt", "f1.txt", "f2.txt", "l0.txt",
                            "l1.txt", "l2.txt"]),
    "select_hard_samples": (["-f", FEAT, "-l", LAB, "-p", "{i}/probs.txt",
                             "--outFeat", "{o}/hf.txt", "--outLabel",
                             "{o}/hl.txt"], ["hf.txt", "hl.txt"]),
    "match_truth_to_seg": (["-s", S, "-t", "{i}/truth.png", "--mins",
                            "20"], []),
    "labelscc_image": (["-i", P, "-d", "10", "-o", "{o}/scc.png"],
                       ["scc.png"]),
    "labelicc_image": (["-i", S, "-m", "{i}/ws.png", "-o", "{o}/icc.png"],
                       ["icc.png"]),
}
# the subcommand of a case whose name adds an option's value
COMMAND = {"watershed_relabel": "watershed",
           "merge_order_pb_device_mean": "merge_order_pb",
           "merge_order_pb_device_median": "merge_order_pb",
           "merge_order_bc_device": "merge_order_bc"}


def test_cases_cover_every_subcommand():
    names = set(port_cli.build_parser()._subparsers._group_actions[0]
                .choices)
    assert names == set(glia_cli.build_parser()._subparsers
                        ._group_actions[0].choices)
    assert len(names) == 48
    assert {COMMAND.get(c, c) for c in CASES} == names


def _same_forest(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert set(za.files) | {"n_features"} == set(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(zb[k], za[k])


@pytest.mark.parametrize("case", sorted(CASES))
def test_subcommand_matches_glia_tpu(case, inputs, tmp_path):
    argv, outputs, *kind = CASES[case]
    kind = kind[0] if kind else "bytes"
    command = COMMAND.get(case, case)
    printed = {}
    for side, main in (("glia_tpu", glia_cli.main),
                       ("port", port_cli.main)):
        o = tmp_path / side
        o.mkdir()
        args = [command] + [a.format(i=inputs, o=o) for a in argv]
        if side == "port":
            args += ["--device", "cpu"]
        printed[side] = run(main, args)
    assert printed["port"] == printed["glia_tpu"]
    if not outputs:
        assert printed["port"].strip()
    for name in outputs:
        want, got = tmp_path / "glia_tpu" / name, tmp_path / "port" / name
        assert got.exists(), name
        if kind == "forest":
            _same_forest(want, got)
        elif kind == "weights":
            w, g = np.loadtxt(want), np.loadtxt(got)
            assert np.abs(g - w).max() <= W_RTOL * np.abs(w).max()
        elif kind == "probabilities":
            np.testing.assert_allclose(np.loadtxt(got), np.loadtxt(want),
                                       rtol=PRED_RTOL)
        else:
            assert got.read_bytes() == want.read_bytes(), name
