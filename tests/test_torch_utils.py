"""The port's utils (glia_tpu_torch.utils): stage store files shared with
glia_tpu's, parameter checkpoints through torch.save, the job runner, and
the profiling helpers, on the CPU."""

import io
import json
import os

import numpy as np
import pytest
import torch

from glia_tpu.utils.checkpoint import StageStore as JxStageStore

from glia_tpu_torch.utils import (StageStore, StageTimer, block_and_time,
                                  execute, restore_params, save_params,
                                  trace)


def _stage(store_cls, root):
    store = store_cls(str(root))
    store.save("merge", order=np.arange(12).reshape(4, 3),
               saliencies=np.linspace(0, 1, 4), policy="median", k=7)
    return store


@pytest.mark.parametrize("writer, reader", [(JxStageStore, StageStore),
                                            (StageStore, JxStageStore),
                                            (StageStore, StageStore)],
                         ids=["glia_to_port", "port_to_glia", "port"])
def test_stage_store_files_read_across_packages(tmp_path, writer, reader):
    _stage(writer, tmp_path / "stages")
    store = reader(str(tmp_path / "stages"))
    assert store.has("merge") and not store.has("features")
    out = store.load("merge")
    np.testing.assert_array_equal(out["order"], np.arange(12).reshape(4, 3))
    np.testing.assert_array_equal(out["saliencies"], np.linspace(0, 1, 4))
    assert out["policy"] == "median" and out["k"] == 7
    assert sorted(os.listdir(tmp_path / "stages")) == ["merge.json",
                                                       "merge.npz"]


def test_stage_store_memoized_run(tmp_path):
    store = StageStore(str(tmp_path / "s"))
    calls = []

    def fn():
        calls.append(1)
        return {"x": np.ones(3)}

    a = store.run("stage1", fn)
    b = store.run("stage1", fn)
    assert len(calls) == 1
    np.testing.assert_array_equal(a["x"], b["x"])


def test_params_roundtrip(tmp_path):
    w = torch.arange(6.0).reshape(2, 3)
    opt = torch.optim.Adam([w.clone().requires_grad_()], lr=1e-3)
    params = {"w": w, "b": torch.ones(3, dtype=torch.float64),
              "layers": [torch.zeros(2, dtype=torch.int64), (torch.ones(1),)],
              "opt": opt.state_dict()}
    path = str(tmp_path / "ckpt.pt")
    save_params(path, params)
    got = restore_params(path)
    torch.testing.assert_close(got["w"], w, rtol=0, atol=0)
    assert got["b"].dtype == torch.float64
    torch.testing.assert_close(got["layers"][1][0], torch.ones(1))
    assert got["opt"]["param_groups"][0]["lr"] == 1e-3
    # a template sets structure, dtype and device
    tmpl = {"w": torch.zeros(2, 3, dtype=torch.float64), "b": torch.zeros(3),
            "layers": [torch.zeros(2), (torch.zeros(1),)],
            "opt": params["opt"]}
    got = restore_params(path, tmpl)
    assert got["w"].dtype == torch.float64 and got["b"].dtype == torch.float32
    assert isinstance(got["layers"][1], tuple)
    with pytest.raises(ValueError, match="keys"):
        restore_params(path, {"w": tmpl["w"]})


def test_job_runner(tmp_path):
    f = tmp_path / "a.txt"
    codes = execute([f"echo hi > {f}", "true", "true"], nproc=2)
    assert codes == [0, 0, 0]
    assert f.read_text().strip() == "hi"
    with pytest.raises(RuntimeError, match="exit code 1"):
        execute(["false"], nproc=1)
    assert execute(["exit 3", "true"], nproc=2, check=False) == [3, 0]


def test_stage_timer():
    timer = StageTimer()
    with timer.stage("a", n_items=100, unit="edges"):
        sum(range(1000))
    with timer.stage("b"):
        pass
    recs = json.loads(timer.json())
    assert [r["stage"] for r in recs] == ["a", "b"]
    assert recs[0]["n"] == 100 and recs[0]["edges_per_s"] > 0
    assert "n" not in recs[1]
    buf = io.StringIO()
    timer.report(file=buf)
    assert "[timer] a:" in buf.getvalue() and "edges_per_s=" in buf.getvalue()


def test_block_and_time_and_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    sec, out = block_and_time(torch.matmul, x, x, n_iter=3, warmup=1)
    assert sec > 0
    torch.testing.assert_close(out, x @ x)
    sec, out = block_and_time(lambda: {"y": x + 1}, n_iter=2, warmup=0)
    assert sec > 0 and out["y"].shape == x.shape
    with trace(str(tmp_path / "prof")) as prof:
        torch.matmul(x, x)
    names = {e.key for e in prof.key_averages()}
    assert "aten::matmul" in names
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
