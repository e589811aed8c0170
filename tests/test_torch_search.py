"""repro_torch.search (the streaming joint-space search plane) against
repro.search, byte for byte: the Pareto kernels and archive on seeded
random sets, lazy spaces, chunked pricing on the compiled lattice path and
the generic path, the streaming frontier, the greedy walker, ``evolve``,
and the port's ``launch.search`` against ``tools/search.py``."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import experiment as jxp
from repro.core.placement import Placement as JPlacement
from repro.core.space import DesignPoint as JDesignPoint
from repro.core.space import DesignSpace as JDesignSpace
from repro import search as jsearch
from repro_torch import search
from repro_torch.core import experiment as xp
from repro_torch.core.placement import Placement
from repro_torch.core.space import DesignPoint, DesignSpace
from repro_torch.launch import search as lsearch

ROOT = Path(__file__).resolve().parents[1]


def test_the_api_is_the_references():
    assert search.__all__ == jsearch.__all__
    assert search.OBJECTIVES == jsearch.OBJECTIVES
    assert search.DEFAULT_CHUNK == jsearch.DEFAULT_CHUNK
    assert repr(search.DSE_AXES) == repr(jsearch.DSE_AXES)


def _sets(seed):
    """Seeded objective sets: continuous, heavy ties (small integers),
    duplicated rows, and 1-4 objectives."""
    rng = np.random.default_rng(seed)
    out = []
    for k in (1, 2, 3, 4):
        out.append(rng.random((300, k)))
        out.append(rng.integers(0, 6, (300, k)).astype(float))
    dup = rng.random((50, 2))
    out.append(np.concatenate([dup, dup, dup[:7]]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_mask_and_dominated_by_equal_the_reference(seed):
    for v in _sets(seed):
        for chunk in (256, 17):
            got = search.pareto_mask(v, chunk=chunk)
            assert np.array_equal(got, jsearch.pareto_mask(v, chunk=chunk))
        ref = v[: len(v) // 3]
        assert np.array_equal(search.dominated_by(v, ref),
                              jsearch.dominated_by(v, ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_pareto_archive_equals_the_reference(seed):
    """Chunks folded with ids and a feasibility mask, through a small block
    (the archive grows past it): the same frontier, ids and counters."""
    rng = np.random.default_rng(seed)
    a, ja = search.ParetoArchive(2, block=16), jsearch.ParetoArchive(2,
                                                                     block=16)
    off = 0
    for n in (40, 1, 200, 77):
        v = np.round(rng.random((n, 2)), 2)
        feas = rng.random(n) > 0.2
        ids = np.arange(off, off + n)
        a.update(v, ids=ids, feasible=feas)
        ja.update(v, ids=ids, feasible=feas)
        off += n
    (i, v), (ji, jv) = a.frontier(), ja.frontier()
    assert np.array_equal(i, ji) and np.array_equal(v, jv)
    assert (len(a), a.seen, a.dropped) == (len(ja), ja.seen, ja.dropped)


def _axes(port=True):
    P = Placement if port else JPlacement
    return dict(workload=("detnet", "edsnet"), arch="eyeriss",
                pe_config=("v1", "v2"), weight_bits=(None, 4), node=(45, 7),
                placement=tuple(P.enumerate("eyeriss", ("sram", "stt"))))


def test_lazy_space_point_at_and_chunks_equal_the_reference():
    lazy = DesignSpace.product_iter("s", **_axes())
    jlazy = JDesignSpace.product_iter("s", **_axes(False))
    assert isinstance(lazy, search.LazySpace)
    assert (len(lazy), lazy.shape) == (len(jlazy), jlazy.shape)
    assert [repr(p) for p in lazy] == [repr(p) for p in jlazy]
    for i in (0, 1, 37, len(lazy) - 1, -1):
        assert repr(lazy.point_at(i)) == repr(jlazy.point_at(i))
    got = [[repr(p) for p in c] for c in lazy.chunks(7)]
    want = [[repr(p) for p in c] for c in jlazy.chunks(7)]
    assert got == want and sum(map(len, got)) == len(lazy)
    sub = lazy.where(lambda p: p.node == 7).map(
        lambda p: p.with_(variant="p1"))
    jsub = jlazy.where(lambda p: p.node == 7).map(
        lambda p: p.with_(variant="p1"))
    assert [repr(p) for p in sub] == [repr(p) for p in jsub]
    assert repr(lazy) == repr(jlazy)


def _arrays(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = v
    for name in dir(type(obj)):
        if isinstance(getattr(type(obj), name), property):
            v = getattr(obj, name)
            if isinstance(v, np.ndarray):
                out[name] = v
    return out


def _assert_tables_equal(got, want):
    a, b = _arrays(got), _arrays(want)
    assert a.keys() == b.keys() and a
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


@pytest.mark.parametrize("path", ["compiled", "generic"])
def test_evaluate_stream_chunks_equal_the_reference(path):
    """``Evaluator.evaluate_stream`` with area: a pure-product lazy space
    takes the compiled ``LatticePricer``; a filtered one the generic
    per-point assembly. Every chunk's points, energy and area tables equal
    the reference's, and (chunked against one-shot) the concatenation is
    the port's own ``evaluate_table``."""
    lazy = DesignSpace.product_iter("s", **_axes())
    jlazy = JDesignSpace.product_iter("s", **_axes(False))
    if path == "generic":
        lazy = lazy.where(lambda p: p.weight_bits is None or p.node == 7)
        jlazy = jlazy.where(lambda p: p.weight_bits is None or p.node == 7)
    ev, jev = xp.Evaluator(), jxp.Evaluator()
    chunks = list(ev.evaluate_stream(lazy, chunk_size=11, with_area=True))
    jchunks = list(jev.evaluate_stream(jlazy, chunk_size=11,
                                       with_area=True))
    assert len(chunks) == len(jchunks) > 1
    for c, jc in zip(chunks, jchunks):
        assert c.offset == jc.offset
        assert [repr(p) for p in c.points] == [repr(p) for p in jc.points]
        _assert_tables_equal(c.energy, jc.energy)
        _assert_tables_equal(c.area, jc.area)
    whole = ev.evaluate_table(list(lazy))
    cat = np.concatenate([c.energy.total_pj for c in chunks])
    assert np.array_equal(cat, whole.total_pj)


@pytest.mark.parametrize("objectives,min_ips", [(("edp", "pmem"), 10.0),
                                                (("energy", "area"), None),
                                                (("latency",), 1.0)])
def test_stream_frontier_equals_the_reference(objectives, min_ips):
    lazy = DesignSpace.product_iter("s", **_axes())
    jlazy = JDesignSpace.product_iter("s", **_axes(False))
    arc = search.stream_frontier(xp.Evaluator(), lazy, objectives=objectives,
                                 chunk_size=13, min_ips=min_ips)
    jarc = jsearch.stream_frontier(jxp.Evaluator(), jlazy,
                                   objectives=objectives, chunk_size=13,
                                   min_ips=min_ips)
    (i, v), (ji, jv) = arc.frontier(), jarc.frontier()
    assert np.array_equal(i, ji) and np.array_equal(v, jv)
    assert (arc.seen, arc.dropped) == (jarc.seen, jarc.dropped)


@pytest.mark.parametrize("metric", ["edp", "pmem"])
def test_greedy_equals_the_reference(metric):
    start = DesignPoint(workload="detnet", arch="cpu", node=45,
                        variant="sram")
    jstart = JDesignPoint(workload="detnet", arch="cpu", node=45,
                          variant="sram")
    steps, jsteps = [], []
    got = search.greedy(xp.Evaluator(), start, metric=metric,
                        on_step=lambda *a: steps.append(repr(a)))
    want = jsearch.greedy(jxp.Evaluator(), jstart, metric=metric,
                          on_step=lambda *a: jsteps.append(repr(a)))
    assert repr(got) == repr(want) and steps == jsteps and steps
    assert [repr(p) for p in search.neighbors(got[0])] == \
        [repr(p) for p in jsearch.neighbors(want[0])]


def test_evolve_equals_the_reference():
    """The tool's defaults (10 generations of 24, seed 0) on two
    objectives: best point and value, every generation's history, and the
    evaluated-set frontier."""
    kw = dict(workload="detnet", objectives=("edp", "pmem"), generations=10,
              population=24, seed=0)
    res = search.evolve(xp.Evaluator(), **kw)
    jres = jsearch.evolve(jxp.Evaluator(), **kw)
    assert repr(res.best_point) == repr(jres.best_point)
    assert res.best_value == jres.best_value
    assert (res.generations, res.n_evaluated) == (jres.generations,
                                                  jres.n_evaluated)
    assert json.dumps(res.history) == json.dumps(jres.history)
    (p, v), (jp, jv) = res.frontier(), jres.frontier()
    assert [repr(x) for x in p] == [repr(x) for x in jp]
    assert np.array_equal(v, jv)


def _tool(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, str(ROOT / "tools" / "search.py"),
                    *args], cwd=cwd, env=env, check=True,
                   capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("args", [
    ["--lattice", "--max-placements", "40"],
    ["--lattice", "--arch", "eyeriss", "--workload", "detnet",
     "--workload", "edsnet", "--objectives", "edp,pmem,area",
     "--min-ips", "10", "--chunk", "4096", "--max-placements", "8"],
    ["--evolve", "--budget", "4", "--population", "12"]],
    ids=["simba", "eyeriss-area", "evolve"])
def test_launcher_writes_the_tools_frontier(args, tmp_path, capsys):
    """``launch.search`` and ``tools/search.py`` write the same frontier
    JSON, byte for byte, and print the same lines but for the times."""
    _tool([*args, "--out", "ref.json"], tmp_path)
    lsearch.main([*args, "--out", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    out = capsys.readouterr().out
    assert "frontier written to" in out
