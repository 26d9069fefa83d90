"""The frozen copies still give what the port's originals give.

``benchmark/inputs`` and ``benchmark/reference/host`` hold copies of the
port's generator, bench.py's section recipe and the port's watershed and
RAG, taken at commit 28cc36d, so that a later change
to the program cannot move the yardstick.  These tests hold each copy to
its original at one seed and a small size.

If one of them fails after a change to the program, the program's
original has changed: the benchmark's copy stays as it is (the cells'
inputs and the reference must not move with the program).  Either the
change to the program is undone, or a later change of the benchmark kind
refreezes the copy, says so, and measures every cell again.
"""

import numpy as np
import pytest

from benchmark.inputs.sections import bench_section, membranes
from benchmark.inputs.synthetic import synthetic_em_slice


@pytest.mark.parametrize("kw", [dict(shape=(160, 192), n_cells=60, seed=7),
                                dict(shape=(128, 128), n_cells=40,
                                     seed=[3, 2 ** 40, 1], blur=1.2,
                                     noise=0.12)])
def test_generator_is_the_ports(kw):
    from glia_tpu_torch.data.synthetic import synthetic_em_slice as port

    a, b = synthetic_em_slice(**kw), port(**kw)
    for k in ("truth", "pb", "intensity"):
        assert np.array_equal(a[k], b[k]), k


def test_bench_section_is_the_ports():
    from glia_tpu_torch.bench import bench_section as port
    from glia_tpu_torch.graph.merge_device import edge_mean_arrays

    side = 256
    data, seg, rag, edges = bench_section(side, 11)
    pdata, pseg, prag = port(side, (side // 14) ** 2, seed=11)
    assert np.array_equal(data["pb"], pdata["pb"])
    assert np.array_equal(seg, pseg)
    assert (rag.n_regions, rag.n_edges) == (prag.n_regions, prag.n_edges)
    for x, y in zip(edges, edge_mean_arrays(prag, pdata["pb"])):
        assert np.array_equal(x, y)


def test_membranes_are_the_generators_before_its_noise():
    kw = dict(shape=(128, 160), n_cells=40, seed=9, blur=1.2)
    d = synthetic_em_slice(noise=0.0, **kw)
    assert np.array_equal(
        np.clip(membranes(d["truth"], 1.2), 0, 1).astype(np.float32),
        d["pb"])
