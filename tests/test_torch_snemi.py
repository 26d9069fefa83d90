"""BASELINE config #5 end to end (glia_tpu_torch.examples: snemi,
run_snemi_e2e, run_snemi_sharded) against glia_tpu's chain of
tools/run_snemi_e2e.py on the same inputs, at a small size: 4 x 128 x 128
voxels, 16 cells, 5 train steps (1,869 regions and 2,279 edges).

glia_tpu runs its library chain as the tool does (x64; a ``make_mesh(n)``
mesh of conftest's CPU devices); the port runs ``snemi_e2e`` on ``n``
gloo ranks on the CPU, for n in WORLDS.  Tolerances: the volume, RAG,
labels, partition counters and every merge row equal; losses within
1e-5 relative and probabilities within 1e-5 (float32, summed in other
orders; glia_tpu's optax Adam and torch.optim round the update
differently); on glia_tpu's own payload, exact saliencies within 1e-12
relative and VI / adapted Rand error within 1e-12 of glia_tpu's device
metrics and of the voxel-level oracle; the whole port flow against the
whole glia_tpu flow: equal merges per tau and VI within 1e-9.

The tool itself is not imported (its import switches on glia_tpu's
compile cache): its two host functions are taken from its source with
``ast``.  Also here, the scale repairs the flow needed: per-rank inputs
of ``spawn_ranks``, the halo step's inputs cut by rank, the histogram
without a one-hot block, and the dense pair-count table.
"""

import ast
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from glia_tpu.data.synthetic import synthetic_em_stack as jx_stack
from glia_tpu.graph.merge import apply_merge_order as jx_apply
from glia_tpu.graph.merge_device import order_to_keys as jx_okeys
from glia_tpu.graph.merge_device import threshold_cut as jx_cut
from glia_tpu.graph.rag import build_rag as jx_build_rag
from glia_tpu.metrics import eval_ri as jx_eval_ri
from glia_tpu.metrics import eval_vi as jx_eval_vi
from glia_tpu.metrics.device import (
    adapted_rand_from_pairs_device as jx_rand_pairs,
    vi_from_pairs_device as jx_vi_pairs)
from glia_tpu.native import watershed_native as jx_watershed
from glia_tpu.ops.pack import pack_csr_values as jx_pack
from glia_tpu.parallel import halo as jx_halo
from glia_tpu.parallel import merge_shard as jx_ms
from glia_tpu.parallel import partition as jx_partition
from glia_tpu.parallel import train as jx_train
from glia_tpu.parallel.mesh import make_mesh as jx_mesh

from glia_tpu_torch.examples import run_snemi_e2e as e2e
from glia_tpu_torch.examples import run_snemi_sharded as shd
from glia_tpu_torch.examples import snemi
from glia_tpu_torch.graph.merge_device import order_to_keys, threshold_cut
from glia_tpu_torch.metrics.device import cell_counts_device
from glia_tpu_torch.parallel import halo, partition
from glia_tpu_torch.parallel.launch import spawn_ranks
from glia_tpu_torch.parallel.train import (_edge_feats_from_pixels,
                                           halo_rank_block,
                                           halo_train_host_inputs)

import torch_parallel_ranks as ranks

Z, SIDE, CELLS, STEPS = 4, 128, 16, 5
WORLDS = (2, 4)
TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "run_snemi_e2e.py")
SHARDED_TOOL = TOOL.replace("run_snemi_e2e", "run_snemi_sharded")
LOSS_RTOL = 1e-5
PROB_ATOL = 1e-5
EXACT_RTOL = 1e-12
METRIC_ATOL = 1e-12
FLOW_VI_ATOL = 1e-9


def _tool_source(path):
    with open(path) as f:
        return ast.parse(f.read())


def _tool_functions(*names):
    """The tool's top-level functions ``names``, executed with numpy."""
    tree = _tool_source(TOOL)
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"np": np}
    exec(compile(ast.Module(body=defs, type_ignores=[]), TOOL, "exec"), ns)
    return [ns[n] for n in names]


def _tool_keys(path):
    """The string keys of the tool's result dict (``out = {...}``) and of
    any dict literal with a "tau" key (a cut row)."""
    out, row = set(), set()
    for node in ast.walk(_tool_source(path)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "out"
                        for t in node.targets):
            out |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "tau" in keys:
                row |= keys
    return out, row


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ok = np.isfinite(want)
    assert np.array_equal(ok, np.isfinite(got))
    return float(np.abs(got[ok] - want[ok]).max()
                 / max(np.abs(want[ok]).max(), 1e-300))


# ---------------------------------------------------------------------------
# glia_tpu's chain, as the tool runs it
# ---------------------------------------------------------------------------

def _jx_volume():
    stack = jx_stack(shape=(Z, SIDE, SIDE), n_cells=CELLS, seed=snemi.SEED)
    pb, truth = stack["pb3d"], stack["truth3d"]
    intensity = np.stack([s["intensity"] for s in stack["slices"]])
    seg = jx_watershed(pb, level=snemi.DEFAULT_LEVEL)
    return pb, intensity, truth, seg, jx_build_rag(seg, contour_only=False)


def _jx_eval(comp_of_region, pairs, T):
    """The tool's pair-table evaluation with glia_tpu's device metrics."""
    rt_regs, rt_labs, rt_cnt = pairs
    keep = rt_labs != 0
    comp = comp_of_region[rt_regs[keep]]
    lab = rt_labs[keep]
    uc, sid = np.unique(comp, return_inverse=True)
    S = len(uc)
    agg = np.bincount(sid * T + lab, weights=rt_cnt[keep],
                      minlength=S * T).astype(np.int64)
    nz = np.nonzero(agg)[0]
    args = ((nz // T).astype(np.int32), (nz % T).astype(np.int32), agg[nz],
            S, T)
    _, _, vi = (float(x) for x in jx_vi_pairs(*args, itk_quirk=True))
    _, _, er = (float(x) for x in jx_rand_pairs(*args))
    return vi, er


def _jx_cuts(jv, okeys, ex, pairs):
    """Per tau: merges, pair-table VI / ARE, voxel-oracle VI / ARE."""
    (resolve,) = _tool_functions("resolve_components")
    _, _, truth, seg, rag = jv
    keys = rag.keys.astype(np.int64)
    n_keys = int(okeys[:, 2].max(initial=int(rag.keys.max()))) + 1
    T = int(pairs[1].max()) + 1
    out = []
    for tau in e2e.TAUS:
        m = np.asarray(jx_cut(okeys, ex, tau))
        vi, er = _jx_eval(resolve(okeys, m, keys, n_keys), pairs, T)
        seg_t = jx_apply(seg, okeys[m])
        out.append({"n_merged": int(m.sum()), "vi": vi, "rand_error": er,
                    "oracle_vi": jx_eval_vi(seg_t, truth)[2],
                    "oracle_rand_error": jx_eval_ri(seg_t, truth)[2]})
    return out


def _jx_flow(jv, labels, n):
    """glia_tpu's chain on an n-device mesh: halo training (losses of
    every step), full-width scoring, sharded merge, exact saliencies."""
    pb, intensity, _, _, rag = jv
    R = rag.n_regions
    ui = rag.key_index(rag.edges[:, 0]).astype(np.int32)
    vi = rag.key_index(rag.edges[:, 1]).astype(np.int32)
    mesh = jx_mesh(n)
    part = jx_partition.partition_rag(rag, n)
    plan = jx_halo.HaloPlan(part, rag)
    batch = jx_train.shard_halo_train_inputs(
        mesh, plan, part, rag, [pb, intensity], labels,
        k_pixels=e2e.K_PIXELS, n_bins=e2e.N_BINS)
    init, step, _ = jx_train.make_halo_train_step(
        mesh, plan, R, n_images=2, k_pixels=e2e.K_PIXELS, n_bins=e2e.N_BINS,
        lr=e2e.LR)
    w, st = init()
    losses = []
    for _ in range(STEPS):
        w, st, loss = step(w, st, batch)
        losses.append(float(loss))
    px, mask = [], None
    for img in (pb, intensity):
        vals, mask = jx_pack(np.asarray(img, np.float32).ravel()[
            rag.edge_pixels], rag.edge_ptr, e2e.K_PIXELS)
        px.append(vals)
    probs = np.asarray(jax.jit(
        lambda w, u, v, px, m, val: jx_train.edge_forward_full(
            w, u, v, px, m, val, R, n_bins=e2e.N_BINS))(
        w, jnp.asarray(ui), jnp.asarray(vi), jnp.asarray(np.stack(px, 1)),
        jnp.asarray(mask.astype(np.float32)),
        jnp.ones(rag.n_edges, np.float32)))
    cnt = np.diff(rag.edge_ptr).astype(np.float64)
    s_arr = (1.0 - probs.astype(np.float64)) * cnt
    order, _, n_m = jx_ms.merge_batched_sharded(
        ui, vi, s_arr, cnt, R, mesh, dmax=e2e.DMAX,
        max_supersteps=e2e.MAX_SUPERSTEPS)
    rows = np.asarray(order)[:n_m]
    ex = np.asarray(jx_ms.exact_saliency_sharded(ui, vi, s_arr, cnt, rows,
                                                 R, mesh))
    return {"losses": losses, "probs": probs, "s": s_arr, "rows": rows,
            "exact": ex, "okeys": jx_okeys(order, n_m, rag)}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vols():
    return _jx_volume(), snemi.make_volume(Z, SIDE, CELLS)


@pytest.fixture(scope="module")
def pairs(vols):
    jv, _ = vols
    (region_majority_truth,) = _tool_functions("region_majority_truth")
    maj, tab = region_majority_truth(jv[4], jv[2])
    ui = jv[4].key_index(jv[4].edges[:, 0])
    vi = jv[4].key_index(jv[4].edges[:, 1])
    return (maj[ui] == maj[vi]).astype(np.float32), tab


@pytest.fixture(scope="module")
def flows(vols, pairs):
    """Per world: glia_tpu's flow, then the port's on n ranks whose merge
    ranks also merge glia_tpu's payload."""
    jv, pv = vols
    labels, tab = pairs
    out = {}
    for n in WORLDS:
        jx = _jx_flow(jv, labels, n)
        jx["cuts"] = _jx_cuts(jv, jx["okeys"], jx["exact"], tab)
        arrays = {}
        res = e2e.snemi_e2e(
            pv, shards=n, steps=STEPS, device="cpu", host_check=True,
            timeout_s=300, arrays=arrays, merge_fn=functools.partial(
                ranks.snemi_merge_rank, glia_s=jx["s"]))
        out[n] = (jx, res, arrays)
    return out


# ---------------------------------------------------------------------------
# the volume stage
# ---------------------------------------------------------------------------

def test_volume_and_rag_match_glia_tpu(vols):
    (pb, intensity, truth, seg, jrag), pv = vols
    for a, b in ((pb, pv.pb), (intensity, pv.intensity), (truth, pv.truth),
                 (seg, pv.seg)):
        np.testing.assert_array_equal(a, b)
    for f in ("keys", "edges", "edge_ptr", "edge_pixels", "region_ptr",
              "region_pixels"):
        np.testing.assert_array_equal(getattr(jrag, f), getattr(pv.rag, f))
    assert (pv.rag.n_regions, pv.rag.n_edges) == (1869, 2279)
    assert set(pv.stages) == {"generate", "watershed", "build_rag"}


def test_labels_and_pair_table_match_the_tool(vols, pairs):
    _, pv = vols
    labels, tab = pairs
    got_labels, got_tab = snemi.edge_labels(pv)
    np.testing.assert_array_equal(got_labels, labels)
    for a, b in zip(got_tab, tab):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    (tool_rmt,) = _tool_functions("region_majority_truth")
    np.testing.assert_array_equal(
        snemi.region_majority_truth(pv.rag, pv.truth)[0],
        tool_rmt(pv.rag, pv.truth)[0])


def test_resolve_components_matches_the_tool(vols, flows):
    (*_, jrag), pv = vols
    (tool_resolve,) = _tool_functions("resolve_components")
    jx = flows[WORLDS[0]][0]
    okeys, keys = jx["okeys"], jrag.keys.astype(np.int64)
    n_keys = int(okeys[:, 2].max()) + 1
    for tau in (0.0, *e2e.TAUS, 1.0):
        m = np.asarray(jx_cut(okeys, jx["exact"], tau))
        np.testing.assert_array_equal(
            snemi.resolve_components(okeys, m, keys, n_keys),
            tool_resolve(okeys, m, keys, n_keys))


def test_partition_counters_match_glia_tpu_at_8_shards(vols):
    (*_, jrag), pv = vols
    jp, pp = jx_partition.partition_rag(jrag, 8), partition.partition_rag(
        pv.rag, 8)
    jh, ph = jx_halo.HaloPlan(jp, jrag), halo.HaloPlan(pp, pv.rag)
    assert (jp.cut_fraction, jp.balance(), jh.H, jh.comm_rows) == \
        (pp.cut_fraction, pp.balance(), ph.H, ph.comm_rows)


# ---------------------------------------------------------------------------
# the chain at 2 and 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", WORLDS)
def test_training_and_scoring_match_glia_tpu(flows, n):
    jx, res, arrays = flows[n]
    assert res["shards"] == n and res["backend"] == "gloo"
    np.testing.assert_allclose(res["losses"], jx["losses"], rtol=LOSS_RTOL)
    assert res["loss_trace"] == [res["losses"][0], res["losses"][-1]]
    np.testing.assert_allclose(arrays["probs"], jx["probs"], rtol=0,
                               atol=PROB_ATOL)


@pytest.mark.parametrize("n", WORLDS)
def test_merge_on_glia_tpu_payload_matches_glia_tpu(vols, pairs, flows, n):
    """The port's sharded merge and exact saliencies on glia_tpu's s:
    rows equal, saliencies within 1e-12, and every cut scored like
    glia_tpu's device metrics and the voxel-level oracle."""
    _, pv = vols
    jx, _, arrays = flows[n]
    got = arrays["merge_ranks"][0]["on_glia_s"]
    np.testing.assert_array_equal(got["rows"], jx["rows"])
    assert _rel(got["exact"], jx["exact"]) <= EXACT_RTOL
    okeys = order_to_keys(got["rows"], got["n"], pv.rag)
    np.testing.assert_array_equal(okeys, jx["okeys"])
    keys = pv.rag.keys.astype(np.int64)
    n_keys = int(okeys[:, 2].max()) + 1
    T = int(pairs[1][1].max()) + 1
    for tau, want in zip(e2e.TAUS, jx["cuts"]):
        m = threshold_cut(okeys, got["exact"], tau)
        assert int(m.sum()) == want["n_merged"]
        _, _, vi, _, _, er, _ = e2e.eval_pairs(
            snemi.resolve_components(okeys, m, keys, n_keys), pairs[1], T,
            "cpu")
        for a, b in ((vi, want["vi"]), (vi, want["oracle_vi"]),
                     (er, want["rand_error"]),
                     (er, want["oracle_rand_error"])):
            assert abs(a - b) <= METRIC_ATOL


@pytest.mark.parametrize("n", WORLDS)
def test_port_flow_matches_glia_tpu_flow(flows, n):
    jx, res, arrays = flows[n]
    np.testing.assert_array_equal(arrays["rows"], jx["rows"])
    assert res["merges"] == len(jx["rows"])
    for got, want in zip(res["cuts"], jx["cuts"]):
        assert got["n_merged"] == want["n_merged"]
        assert abs(got["vi"] - want["vi"]) <= FLOW_VI_ATOL
        assert abs(got["rand_error"] - want["rand_error"]) <= FLOW_VI_ATOL
    chk = res["host_check"]
    assert chk["tau"] == e2e.HOST_CHECK_TAU
    assert max(chk["vi_gap"], chk["rand_error_gap"]) <= e2e.HOST_CHECK_TOL
    assert set(res["launches"]) == {"train", "score", "merge", "replay",
                                    "eval"}


# ---------------------------------------------------------------------------
# the examples' entry points
# ---------------------------------------------------------------------------

def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_e2e_main_prints_the_tools_keys(capsys):
    out = e2e.main(["2", "64", "8", "1", "2", "--device", "cpu"])
    printed = _last_json(capsys)
    keys, row = _tool_keys(TOOL)
    assert keys <= set(printed) and keys <= set(out)
    assert printed["config"] == "SNEMI-scale e2e 2x64x64 @ 1"
    assert all(row <= set(cut) for cut in printed["cuts"])
    assert [c["tau"] for c in printed["cuts"]] == list(e2e.TAUS)


def test_sharded_main_prints_the_tools_keys(capsys):
    out = shd.main(["2", "64", "8", "2", "--device", "cpu"])
    printed = _last_json(capsys)
    keys, _ = _tool_keys(SHARDED_TOOL)
    assert keys <= set(printed) and keys <= set(out)
    assert (printed["shards"], printed["world"], printed["backend"]) == \
        (2, 1, "gloo")
    assert printed["edges_per_s"] == printed["edges"] / printed["step_s"]
    assert printed["step_s"] == float(np.median(printed["steps_s"]))


@pytest.mark.parametrize("entry", ["e2e", "sharded"])
def test_examples_need_a_card_unless_asked_for_the_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = e2e.main if entry == "e2e" else shd.main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["2", "64", "8"])


# ---------------------------------------------------------------------------
# the repairs for scale
# ---------------------------------------------------------------------------

def test_spawn_ranks_wants_one_rank_args_entry_a_rank():
    """(That each rank gets its own entry, the flows above show: their
    train ranks take their blocks of the halo inputs through it.)"""
    with pytest.raises(ValueError, match="rank_args"):
        spawn_ranks(ranks.rank_info, 2, "gloo", "cpu", rank_args=[(1,)])


def test_halo_rank_blocks_cover_every_edge_once(vols):
    _, pv = vols
    part = partition.partition_rag(pv.rag, 4)
    plan = halo.HaloPlan(part, pv.rag)
    labels = np.arange(pv.rag.n_edges, dtype=np.float32)
    host = halo_train_host_inputs(plan, part, pv.rag,
                                  [pv.pb, pv.intensity], labels, 8)
    blocks = [halo_rank_block(host, r) for r in range(4)]
    seen = np.concatenate([b["labels"][b["edge_valid"] > 0]
                           for b in blocks])
    np.testing.assert_array_equal(np.sort(seen), labels)
    for r, b in enumerate(blocks):
        np.testing.assert_array_equal(b["send_ids"], plan.send_ids[r])
        np.testing.assert_array_equal(b["own_ids"], plan.own_ids[r])
        assert b["px"].shape == (host["E_max"], 2, 8)
        assert b["px_mask"].dtype == bool


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_histogram_equals_the_one_hot_sum(dtype):
    """The scattered bin counts give the bits of glia_tpu's one-hot sum
    (its [E, n_img, K, n_bins] block, 17 GB at SNEMI3D scale)."""
    rng = np.random.default_rng(0)
    px = torch.tensor(rng.random((700, 2, 32)), dtype=dtype)
    px[0], px[1], px[2, 0, :5] = 1.0, 0.0, 0.999999
    lens = rng.integers(0, 33, 700)
    mask = torch.tensor(np.arange(32)[None] < lens[:, None], dtype=dtype)
    feats, _ = _edge_feats_from_pixels(px, mask, 16)
    m = mask[:, None, :]
    bins = torch.clamp((px * 16).to(torch.int32), 0, 15)
    one_hot = torch.nn.functional.one_hot(bins.long(), 16).to(dtype)
    want = (one_hot * m[..., None]).sum(dim=2) / torch.clamp(
        mask.sum(dim=1), min=1.0)[:, None, None]
    assert torch.equal(feats[:, :40].reshape(700, 2, 20)[:, :, 4:], want)


def test_cell_counts_equal_the_host_bincount():
    rng = np.random.default_rng(1)
    S, T, K = 50, 7, 400
    sid, tid = rng.integers(0, S, K), rng.integers(0, T, K)
    counts = rng.integers(1, 2 ** 40, K)
    got = cell_counts_device(sid, tid, counts, S, T, device="cpu")
    want = np.zeros(S * T, np.int64)
    np.add.at(want, sid * T + tid, counts)
    assert got.dtype == torch.float64 and got.shape == (S * T,)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
