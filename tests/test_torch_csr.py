"""The CSR order (``ops/kernels/csr.py``, ``csrc/csr.cu``) and the view's
CSR build (``core/store.py EdgeTable._csr``).

On the CPU: the operator's route is the host build's order
(``np.lexsort((key, rows))`` and ``_build_csr``'s arrays) for every key
kind and launches nothing; the wrapper refuses what the kernels do not
take; the view's build, run on CPU tensors, gives every array of
``_build_csr`` on both profiles.  The tests marked ``chip`` need a CUDA card
and hold the kernels to the plain version bit for bit; on the card run them
with ``python3 -m pytest --noconftest tests/test_torch_csr.py -m chip``
(this folder's ``conftest.py`` loads JAX, which that machine lacks)."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import (EdgeTable, GraphStore,
                                              _build_csr, unify_ts_bases)
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels import csr
from graph_learn_tpu_torch.utils import profiling

KINDS = ("weights", "timestamps", "coarse_timestamps", "none")


def _edges(n=60, e=1500, seed=0, hub=0):
    """rows / cols with an empty row, duplicated self-loops sharing a
    weight, ties, -0.0 / +0.0, NaN and infinite weights, and ``hub`` more
    edges on row 3."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, e)
    rows[rows == 5] = 6  # row 5 empty
    cols = rng.integers(0, n, e)
    w = (rng.integers(0, 5, e) * 0.25).astype(np.float32)
    w[rng.random(e) < 0.05] = -0.0
    w[rng.random(e) < 0.05] = np.nan
    w[rng.random(e) < 0.02] = np.inf
    if e >= 6:  # self-loops
        rows[:6], cols[:6] = [9, 9, 9, 9, 2, 2], [9, 9, 9, 4, 2, 2]
        w[:6] = [0.5, 0.5, 0.5, 0.5, 0.0, -0.0]
    ts = rng.integers(0, 40, e).astype(np.int64) + 10 ** 6
    if hub:
        rows = np.concatenate([rows, np.full(hub, 3)])
        cols = np.concatenate([cols, rng.integers(0, n, hub)])
        w = np.concatenate([w, (rng.integers(0, 50, hub) * 0.5)
                            .astype(np.float32)])
        ts = np.concatenate([ts, rng.integers(0, 400, hub) + 10 ** 6])
        order = rng.permutation(rows.size)
        rows, cols, w, ts = rows[order], cols[order], w[order], ts[order]
    return n, rows, cols, w, ts


def _table(kind, **kw):
    """An edge table keyed by ``kind``.  "coarse_timestamps": a span past
    int32, so that ``unify_ts_bases`` coarsens the timestamps and ties
    them where the table's own sort key does not."""
    n, rows, cols, w, ts = _edges(**kw)
    timed = kind in ("timestamps", "coarse_timestamps")
    if kind == "coarse_timestamps":
        ts = (ts - 10 ** 6) * 10 ** 8 + np.arange(ts.size) % 10
    et = EdgeTable(
        "rel", "item", "item",
        Decoder(weighted=kind == "weights", timestamped=timed),
        src=rows, dst=cols, num_src_nodes=n, num_dst_nodes=n,
        weights=w if kind == "weights" else None,
        timestamps=ts if timed else None)
    if kind == "coarse_timestamps":
        store = GraphStore()
        store.add_edge_table(et)
        with pytest.warns(UserWarning, match="coarsening"):
            unify_ts_bases(store)
        assert et.ts_scale > 1
    return et


def _offsets(rows, n):
    ro = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=ro[1:])
    return ro


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _key(kind, w, ts, cols):
    """(key, descending, the host's sort key) of each kind."""
    return {"weights": (w, True, w.astype(np.float64)),
            "f32_ascending": (w, False, w.astype(np.float64)),
            "timestamps": (ts.astype(np.float64), False,
                           ts.astype(np.float64)),
            "ids": (cols.astype(np.int32), False, cols.astype(np.int32)),
            "none": (None, False, None)}[kind]


def _same(a, b):
    """Bit for bit (NaN included), as numpy arrays."""
    if a is None or b is None:
        return a is None and b is None
    a, b = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in (a, b)]
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


ORDER_KINDS = ("weights", "f32_ascending", "timestamps", "ids", "none")


@pytest.mark.parametrize("kind", ORDER_KINDS)
def test_the_cpu_route_is_the_host_order(kind):
    n, rows, cols, w, ts = _edges(hub=300)
    key, desc, host_key = _key(kind, w, ts, cols)
    rows32, cols32 = rows.astype(np.int32), cols.astype(np.int32)
    before = csr.LAUNCHES.count
    nbr, eids = csr.csr_order(_t(rows32), _t(cols32), _t(_offsets(rows, n)),
                              None if key is None else _t(key), desc)
    assert csr.LAUNCHES.count == before
    if host_key is None:
        want = np.argsort(rows, kind="stable")
    else:
        want = np.lexsort((-host_key if desc else host_key, rows))
    assert _same(eids, want.astype(np.int32))
    assert _same(nbr, cols32[want])
    if kind in ("weights", "timestamps", "none"):
        ro, h_nbr, h_eids = _build_csr(rows, cols32, n, host_key, desc)[:3]
        assert _same(eids, h_eids) and _same(nbr, h_nbr)
    if kind == "ids":  # the full profile's id-sorted copy
        h = _build_csr(rows, cols32, n, None, False, full=True)
        assert _same(nbr, h[3]) and _same(eids, h[4])


def test_a_cpu_tensor_never_reaches_the_library(monkeypatch):
    def no_library(name):
        raise AssertionError("library(%r) loaded on the CPU" % name)

    monkeypatch.setattr(csr, "library", no_library)
    n, rows, cols, w, _ = _edges()
    before = csr.LAUNCHES.count
    nbr, eids = csr.csr_order(_t(rows.astype(np.int32)),
                              _t(cols.astype(np.int32)),
                              _t(_offsets(rows, n)), _t(w), True)
    assert nbr.device.type == eids.device.type == "cpu"
    assert csr.LAUNCHES.count == before


def test_the_operator_passes_opcheck_and_its_fake_matches():
    from torch._subclasses.fake_tensor import FakeTensorMode
    n, rows, cols, w, _ = _edges(e=200)
    args = (_t(rows.astype(np.int32)), _t(cols.astype(np.int32)),
            _t(_offsets(rows, n)), _t(w), True)
    torch.library.opcheck(torch.ops.glt.csr_order.default, args)
    real = torch.ops.glt.csr_order(*args)
    with FakeTensorMode() as mode:
        fake = torch.ops.glt.csr_order(
            *[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
              for a in args])
    assert [(f.shape, f.dtype) for f in fake] == \
        [(r.shape, r.dtype) for r in real]


@pytest.mark.parametrize("bad", ["int64_rows", "cols_shape", "key_dtype",
                                 "descending_ids", "descending_none",
                                 "offsets_dtype"])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(bad):
    n, rows, cols, w, _ = _edges(e=50)
    args = dict(rows=_t(rows.astype(np.int32)), cols=_t(cols.astype(np.int32)),
                row_offsets=_t(_offsets(rows, n)), key=_t(w), descending=True)
    if bad == "int64_rows":
        args["rows"] = _t(rows.astype(np.int64))
    elif bad == "cols_shape":
        args["cols"] = args["cols"][1:]
    elif bad == "key_dtype":
        args["key"] = args["key"].to(torch.float16)
    elif bad == "descending_ids":
        args["key"] = args["cols"]
    elif bad == "descending_none":
        args["key"] = None
    else:
        args["row_offsets"] = args["row_offsets"].long()
    with pytest.raises(InvalidArgumentError, match="csr_order"):
        csr.csr_order(**args)


def test_long_rows_are_batched_within_the_scratch(monkeypatch):
    monkeypatch.setattr(csr, "LONG_BATCH_ITEMS", 8000)
    lens = np.array([5000, 2049, 3000, 9000, 2100], dtype=np.int64)
    cap, batches = csr._batches(lens)
    assert cap == 9000
    assert [(a, b) for a, b, _ in batches] == [(0, 2), (2, 3), (3, 4),
                                               (4, 5)]
    for a, b, offs in batches:
        assert offs[0] == 0 and np.all(offs + lens[a:b] <= cap)
        np.testing.assert_array_equal(offs[1:], np.cumsum(lens[a:b])[:-1])


class _FakeLibrary:
    """Records the C calls of ``csr._launch_order`` and the rows (and
    scratch offsets) each listed-rows launch is given; every call returns
    0."""

    NAMES = ("glt_csr_check", "glt_csr_scatter", "glt_csr_sort_rows",
             "glt_csr_sort_listed")

    def __init__(self):
        self.calls = []
        for name in self.NAMES:
            setattr(self, name, self._fn(name))

    def _fn(self, name):
        def call(*args):
            if name == "glt_csr_sort_listed":
                n = args[3]
                rows = np.ctypeslib.as_array(
                    (ctypes.c_int32 * n).from_address(args[1])).tolist()
                offs = (None if not args[2] else np.ctypeslib.as_array(
                    (ctypes.c_int64 * n).from_address(args[2])).tolist())
                self.calls.append((name, rows, offs))
            else:
                self.calls.append((name,))
            return 0

        call.argtypes = call.restype = None
        return call


def test_rows_past_the_warp_tier_are_listed_and_long_ones_batched(
        monkeypatch):
    fake = _FakeLibrary()
    monkeypatch.setattr(csr, "library", lambda name: fake)
    monkeypatch.setattr(csr, "LONG_BATCH_ITEMS", 7100)
    degrees = np.array([3, 300, 0, 5000, 2049, 256, 2048, 4000])
    rows = np.repeat(np.arange(degrees.size), degrees).astype(np.int32)
    before = csr.LAUNCHES.count
    profiling.reset()
    profiling.enable()
    try:
        csr._launch_order(_t(rows), _t(rows),
                          _t(_offsets(rows, degrees.size)), None, False, 0)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    assert fake.calls == [
        ("glt_csr_check",), ("glt_csr_scatter",), ("glt_csr_sort_rows",),
        ("glt_csr_sort_listed", [1, 3], [0, 300]),
        ("glt_csr_sort_listed", [4, 6], [0, 2049]),
        ("glt_csr_sort_listed", [7], [0])]
    assert csr.LAUNCHES.count - before == 5
    assert counters["store.csr.long_rows"] == 5


def _views_equal(got, want, profile):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("out", "inc"):
            if b is None:
                assert a is None, f.name
                continue
            for g in dataclasses.fields(b):
                x, y = getattr(a, g.name), getattr(b, g.name)
                if g.name == "max_degree":
                    assert x == y
                else:
                    assert _same(x, y), "%s.%s (%s)" % (f.name, g.name,
                                                        profile)
        else:
            assert _same(a, b), f.name


@pytest.mark.parametrize("profile", ["minimal", "full"])
@pytest.mark.parametrize("kind", KINDS)
def test_the_card_builds_assembly_gives_the_host_arrays(kind, profile):
    """The view's build (``EdgeTable._csr``, the card's assembly) on CPU
    tensors, where the order is the plain version's, equals
    ``_build_csr`` on every array of both directions."""
    with bench.bench_conf(storage_profile=profile):
        et = _table(kind, hub=400)
        view = et.device("cpu")
        full = profile == "full"
        for name, rows, cols, n, nbr_deg in (
                ("out", et.src, et.dst, et.num_src_nodes, et.in_degrees),
                ("inc", et.dst, et.src, et.num_dst_nodes, et.out_degrees)):
            got = getattr(view, name)
            if not full and name == "inc":
                assert got is None
                continue
            host = _build_csr(rows, cols.astype(np.int32), n, et._sort_key,
                              et._sort_desc, et.weights, nbr_deg, full=full,
                              timestamps=et.timestamps)
            fields = ("row_offsets", "nbr_ids", "nbr_edge_ids",
                      "nbr_ids_sorted", "nbr_edge_ids_sorted", "cum_weights",
                      "cum_in_degrees", "nbr_ts")
            for field, a in zip(fields, host):
                assert _same(getattr(got, field), a), (name, field)
            assert got.max_degree == int(np.diff(host[0]).max())


@pytest.mark.parametrize("kind", KINDS)
def test_the_view_sorts_by_its_own_timestamps_where_they_order_alike(kind):
    """The key of a view's build: the view's weights, or its own int32
    timestamps (no copy) where they are the table's sort key up to a shift;
    a coarsened table, whose ties its sort key still orders, sorts by a
    float64 copy of that key."""
    et = _table(kind)
    view = et.device("cpu")
    key = et._csr_key(view.weights, view.timestamps, torch.device("cpu"))
    if kind == "weights":
        assert key is view.weights
    elif kind == "timestamps":
        assert key is view.timestamps
    elif kind == "coarse_timestamps":
        assert key.dtype == torch.float64
        assert _same(key, et._sort_key)
        order = np.lexsort((et.timestamps, et.src))
        assert not np.array_equal(order, np.lexsort((et._sort_key, et.src)))
    else:
        assert key is None


def test_the_cpu_view_counts_no_card_build():
    profiling.reset()
    profiling.enable()
    try:
        with bench.bench_conf(storage_profile="minimal"):
            _table("weights").device("cpu")
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    assert "store.csr.device_builds" not in counters
    assert "store.csr.long_rows" not in counters


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from graph_learn_tpu_torch.ops.kernels import build
    build.build(["csr"])
    return torch.device("cuda")


CARD_CASES = {
    # ties, self-loops sharing a weight, -0.0 / +0.0, NaN, inf, empty row
    "small": dict(),
    # one hub row of many tiles
    "hub": dict(n=500, e=20000, hub=200_000),
    # rows of one tile (Poisson(200) degrees: 257-2048 edges)
    "tile_rows": dict(n=300, e=60_000, hub=3000),
    "zero_edges": dict(e=0),
}


@pytest.mark.chip
@pytest.mark.parametrize("kind", ORDER_KINDS)
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_the_kernel_equals_the_plain_version(card, case, kind):
    n, rows, cols, w, ts = _edges(**CARD_CASES[case])
    key, desc, _ = _key(kind, w, ts, cols)
    args = [_t(rows.astype(np.int32)), _t(cols.astype(np.int32)),
            _t(_offsets(rows, n)), None if key is None else _t(key)]
    want = csr.csr_order(*args, descending=desc)
    before = csr.LAUNCHES.count
    got = csr.csr_order(*[None if a is None else a.to(card) for a in args],
                        descending=desc)
    torch.cuda.synchronize()
    assert (csr.LAUNCHES.count > before) == (rows.size > 0)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.chip
@pytest.mark.parametrize("profile", ["minimal", "full"])
@pytest.mark.parametrize("kind", KINDS)
def test_the_card_view_equals_the_cpu_view(card, kind, profile):
    with bench.bench_conf(storage_profile=profile):
        et = _table(kind, n=400, e=30000, hub=5000)
        want = et.device("cpu")
        profiling.reset()
        profiling.enable()
        try:
            got = et.device(card)
            counters = profiling.snapshot()["counters"]
        finally:
            profiling.disable()
            profiling.reset()
    _views_equal(got, want, profile)
    directions = 1 if profile == "minimal" else 2
    assert counters["store.csr.device_builds"] == directions
    # each sort counts its rows past the warp tier: "full" sorts each
    # direction twice (the key's order and the id order)
    long_rows = int(np.count_nonzero(et.out_degrees > csr.WARP_ROWS))
    if profile == "full":
        long_rows = 2 * (long_rows + int(np.count_nonzero(
            et.in_degrees > csr.WARP_ROWS)))
    assert counters["store.csr.long_rows"] == long_rows >= 1
