"""k-NN over node float attributes: Flat, IVFFlat and IVFPQ indexes.

Counterpart of ``graph_learn_tpu/ops/knn.py`` ``KnnOption:29``,
``_scores:39``, ``FlatIndex:49``, ``IVFFlatIndex:90``, ``IVFPQIndex:162``
and ``build_index:260`` on one device, with the same semantics:

- scores are ``-(|q|^2 - 2 q.x + |x|^2)`` in float32 (L2, metric 0) or
  ``q.x`` (inner product, metric 1), higher is closer; distances are the
  negated L2 scores, or the inner products;
- ids past ``ntotal`` are -1 and their distances +inf (L2) or -inf (inner
  product); an IVF point outside every probed cell scores -inf, and a
  non-finite score gives id -1;
- ``IVFFlatIndex.add`` assigns cells by L2 whatever the metric, while its
  search ranks cells by ``self.metric``;
- ``IVFPQIndex`` scores by asymmetric (ADC) L2 whatever the metric, each
  point with the look-up table of its own cell's probe, and returns
  ``-top``;
- k-means keeps the old centroid of a cell that lost every point
  (``:115-123``);
- ties break toward the lower data row, as ``lax.top_k`` and
  ``jnp.argmax`` do.

The JAX search builds its [m, n] scores whole, the IVFFlat search an
[m, n, nprobe] probe mask and the IVFPQ search an [n, m, ksub] one-hot and
[nq, P, n] scores: at a million points and ten thousand queries these are
tens to hundreds of GB.  Here a search takes ``QUERY_CHUNK`` queries at a
time against ``DATA_CHUNK`` data rows at a time and keeps a running top k,
merged in ascending row order so that ties resolve as one ``top_k`` over
the whole row does (:func:`_chunk_top`, :func:`_merge`).  An IVF point is
scored through its cell's probe slot: a [q, nlist] map from cell to probe
slot (-1: not probed), then, for IVFPQ, ``lut[q, slot, s, code]`` summed
over the ``m`` subspaces.  k-means assigns ``DATA_CHUNK`` rows at a time.
The products and ``topk`` are ``torch.matmul`` / ``torch.topk``, as the
JAX package computes them in XLA, not in a Pallas kernel.

``train(data, init_rows=None)`` takes the k-means starting rows (a test
passes the rows JAX's ``jax.random.choice`` picks) or draws them from the
index's own ``torch.Generator``.  :class:`ShardedIndex` (``shard_index``,
``:281-431``) range-partitions a built index over a mesh axis of the
parallel store's process groups.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.segment import segment_sum
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

# queries scored together against one block of data rows
QUERY_CHUNK = 1024
# data rows scored together (and k-means rows assigned together)
DATA_CHUNK = 65536


@dataclasses.dataclass
class KnnOption:
    """Index type, k, IVF cells and probes, metric (None: conf)."""

    k: int = 10
    index_type: str = "flat"  # flat | ivfflat | ivfpq
    nlist: int = 64
    nprobe: int = 8
    metric: Optional[int] = None  # 0 = L2, 1 = inner product


def _scores(queries: torch.Tensor, data: torch.Tensor, metric: int,
            data_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[m, n] similarity (higher = closer): ``-(qn - 2 ip + dn)`` or
    ``ip``; ``data_norms`` [n] are the rows' squared norms when known."""
    ip = queries @ data.T
    if metric == 1:
        return ip
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    dn = (torch.sum(data * data, dim=1) if data_norms is None
          else data_norms)[None, :]
    return -(qn - 2.0 * ip + dn)


def _chunk_top(s: torch.Tensor, k: int, base: int = 0):
    """``lax.top_k`` of scores ``s`` [q, w] over data rows ``base ...
    base + w - 1``: (values, rows) [q, min(k, w)], values descending and
    equal values in ascending row order, the k kept among equal values at
    the k-th being those of the lowest rows."""
    q, w = s.shape
    if w <= k:
        vals, pos = torch.sort(s, dim=1, descending=True, stable=True)
        return vals, pos + base
    kth = torch.topk(s, k, dim=1).values[:, -1:]
    above = s > kth
    at = s == kth
    room = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
    keep = above | (at & (torch.cumsum(at, dim=1, dtype=torch.int32)
                          <= room))
    # each kept position's slot, in row order; the rest to a spare column
    slot = torch.where(keep, torch.cumsum(keep, dim=1, dtype=torch.int32)
                       - 1, k).long()
    pos = torch.arange(w, device=s.device).expand(q, w)
    rows = torch.zeros((q, k + 1), dtype=torch.long,
                       device=s.device).scatter_(1, slot, pos)[:, :k]
    vals, order = torch.sort(torch.gather(s, 1, rows), dim=1,
                             descending=True, stable=True)
    return vals, torch.gather(rows, 1, order) + base


def _merge(vals: torch.Tensor, rows: torch.Tensor, new_vals: torch.Tensor,
           new_rows: torch.Tensor, k: int):
    """The top k of a running (values, rows) and a later block's: every
    running row is lower than the block's and each side orders equal
    values by row, so a stable sort keeps ties in row order."""
    v = torch.cat([vals, new_vals], dim=1)
    r = torch.cat([rows, new_rows], dim=1)
    v, order = torch.sort(v, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(r, 1, order[:, :k])


def _search_top(queries: torch.Tensor, n: int, k: int, scorer,
                start: int = 0):
    """(values, rows) [m, min(k, n)]: the top k over the ``n`` data rows
    from ``start``, with ``scorer(q_chunk)`` returning a function ``(lo,
    hi) -> [q, hi - lo]`` scores of the data rows ``lo ... hi - 1``.  The
    blocks end at multiples of ``DATA_CHUNK``, so a range that starts
    inside the data (a shard's) is scored in the blocks the whole search
    scores, but at its ends."""
    out_v, out_r = [], []
    edges = [start] + list(range((start // DATA_CHUNK + 1) * DATA_CHUNK,
                                 start + n, DATA_CHUNK)) + [start + n]
    for q0 in range(0, queries.shape[0], QUERY_CHUNK):
        qc = queries[q0:q0 + QUERY_CHUNK]
        block = scorer(qc)
        vals = torch.empty((qc.shape[0], 0), dtype=torch.float32,
                           device=qc.device)
        rows = torch.empty((qc.shape[0], 0), dtype=torch.long,
                           device=qc.device)
        for lo, hi in zip(edges[:-1], edges[1:]):
            if hi <= lo:
                continue
            bv, br = _chunk_top(block(lo, hi), k, lo)
            vals, rows = _merge(vals, rows, bv, br, k)
        out_v.append(vals)
        out_r.append(rows)
    return torch.cat(out_v), torch.cat(out_r)


def _finish(vals: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
            k: int, metric: int, finite_only: bool):
    """-> (ids [m, k] int64, distances [m, k] float32) numpy: distances
    ``-top`` (L2) or ``top``, ids -1 where the score is not finite (IVF)
    and both padded past ``ntotal``."""
    out_ids = ids[rows]
    if finite_only:
        out_ids = torch.where(torch.isfinite(vals), out_ids, -1)
    dist = -vals if metric == 0 else vals
    pad = k - vals.shape[1]
    if pad:
        fill = float("inf") if metric == 0 else float("-inf")
        out_ids = torch.nn.functional.pad(out_ids, (0, pad), value=-1)
        dist = torch.nn.functional.pad(dist, (0, pad), value=fill)
    return out_ids.cpu().numpy(), dist.cpu().numpy()


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Each row's nearest centroid by L2 (``argmax`` of ``_scores``, the
    lowest cell on a tie), ``DATA_CHUNK`` rows at a time: [n] int64."""
    return torch.cat([torch.argmax(_scores(x[lo:lo + DATA_CHUNK],
                                           centroids, 0), dim=1)
                      for lo in range(0, x.shape[0], DATA_CHUNK)])


def _kmeans(x: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd's iterations from the centroids ``init``; a cell that gets no
    point keeps its centroid."""
    c = init
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(iters):
        assign = _assign(x, c)
        sums = segment_sum(x, assign, c.shape[0])
        cnt = segment_sum(ones, assign, c.shape[0])
        c = torch.where(cnt[:, None] > 0,
                        sums / torch.clamp(cnt, min=1.0)[:, None], c)
    return c


def _choice(n: int, size: int, generator: torch.Generator) -> torch.Tensor:
    """``size`` row numbers of [0, n): distinct where n allows, with
    replacement otherwise (``jax.random.choice(..., replace=n < size)``)."""
    dev = generator.device
    if n >= size:
        return torch.randperm(n, generator=generator, device=dev)[:size]
    return torch.randint(0, n, (size,), generator=generator, device=dev)


def _rows(x: torch.Tensor, init_rows, size: int,
          generator: torch.Generator) -> torch.Tensor:
    """The starting centroids: ``x`` at the given row numbers, or at
    ``size`` drawn ones."""
    if init_rows is None:
        idx = _choice(x.shape[0], size, generator)
    else:
        idx = torch.as_tensor(np.asarray(init_rows, np.int64),
                              device=x.device)
        if idx.shape != (size,):
            raise InvalidArgumentError(
                "init_rows: want %d row numbers, got shape %s"
                % (size, tuple(idx.shape)))
    return x[idx]


class _Index:
    """Shared state: device, generator, the added ids."""

    def __init__(self, dim: int, metric: Optional[int], seed: int,
                 device: DeviceLike):
        self.dim = dim
        self.metric = conf.knn_metric if metric is None else metric
        self.device = resolve_device(device)
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._ids: Optional[torch.Tensor] = None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _append(self, name: str, value: torch.Tensor):
        old = getattr(self, name)
        setattr(self, name, value if old is None else torch.cat([old, value]))

    def _add_ids(self, ids):
        self._append("_ids", torch.as_tensor(np.asarray(ids, np.int64),
                                             device=self.device))

    @property
    def ntotal(self) -> int:
        return 0 if self._ids is None else self._ids.shape[0]


class FlatIndex(_Index):
    """Brute-force index (reference flat_index.cc)."""

    def __init__(self, dim: int, metric: Optional[int] = None, seed: int = 0,
                 device: DeviceLike = "cuda"):
        super().__init__(dim, metric, seed, device)
        self._data: Optional[torch.Tensor] = None
        self._norms: Optional[torch.Tensor] = None

    def train(self, data, init_rows=None):  # a flat index needs none
        pass

    def add(self, data, ids):
        x = self._tensor(data)
        self._append("_data", x)
        self._append("_norms", torch.sum(x * x, dim=1))
        self._add_ids(ids)

    def scorer(self, data=None, norms=None, off: int = 0):
        """The block scorer of :func:`_search_top` over ``data`` (default
        the index's rows), whose first row is data row ``off``."""
        data = self._data if data is None else data
        norms = self._norms if norms is None else norms

        def scorer(qc):
            return lambda lo, hi: _scores(qc, data[lo - off:hi - off],
                                          self.metric,
                                          norms[lo - off:hi - off])
        return scorer

    def search(self, queries, k: int):
        """-> (ids [m, k] int64, -1 padded; distances [m, k] float32)."""
        vals, rows = _search_top(self._tensor(queries), self.ntotal, k,
                                 self.scorer())
        return _finish(vals, rows, self._ids, k, self.metric, False)


def _probe_slots(qc: torch.Tensor, centroids: torch.Tensor, metric: int,
                 nprobe: int):
    """(probe [q, nprobe] cells, slot [q, nlist]: each cell's probe slot
    or -1) of the queries ``qc``: the ``nprobe`` best cells by ``metric``,
    ``lax.top_k``'s choice."""
    _, probe = _chunk_top(_scores(qc, centroids, metric), nprobe)
    slot = torch.full((qc.shape[0], centroids.shape[0]), -1,
                      dtype=torch.int32, device=qc.device)
    slot.scatter_(1, probe, torch.arange(
        nprobe, dtype=torch.int32, device=qc.device).expand(
            qc.shape[0], nprobe).contiguous())
    return probe, slot


class IVFFlatIndex(_Index):
    """Cell-probed index (reference ivfflat_index.cc): k-means cells, then
    only the points of the ``nprobe`` best cells of a query are ranked."""

    def __init__(self, dim: int, nlist: int = 64, nprobe: int = 8,
                 metric: Optional[int] = None, iters: int = 10, seed: int = 0,
                 device: DeviceLike = "cuda"):
        super().__init__(dim, metric, seed, device)
        self.nlist = nlist
        self.nprobe = min(nprobe, nlist)
        self.iters = iters
        self.centroids: Optional[torch.Tensor] = None
        self._data: Optional[torch.Tensor] = None
        self._norms: Optional[torch.Tensor] = None
        self._cell: Optional[torch.Tensor] = None

    def train(self, data, init_rows=None):
        """k-means (Lloyd, ``iters`` rounds) from ``init_rows`` or from
        ``nlist`` rows drawn from the index's generator."""
        x = self._tensor(data)
        self.centroids = _kmeans(
            x, _rows(x, init_rows, self.nlist, self.generator), self.iters)

    def add(self, data, ids):
        if self.centroids is None:
            raise InvalidArgumentError("IVFFlatIndex.add: train() first")
        x = self._tensor(data)
        self._append("_data", x)
        self._append("_norms", torch.sum(x * x, dim=1))
        self._append("_cell", _assign(x, self.centroids))
        self._add_ids(ids)

    def scorer(self, data=None, norms=None, cell=None, centroids=None,
               off: int = 0):
        """The block scorer of :func:`_search_top` over ``data`` /
        ``norms`` / ``cell`` (default the index's), whose first row is data
        row ``off``, probing ``centroids`` (default the index's)."""
        data = self._data if data is None else data
        norms = self._norms if norms is None else norms
        cell = self._cell if cell is None else cell
        centroids = self.centroids if centroids is None else centroids

        def scorer(qc):
            _, slot = _probe_slots(qc, centroids, self.metric, self.nprobe)

            def block(lo, hi):
                probed = torch.gather(slot, 1, cell[lo - off:hi - off].expand(
                    qc.shape[0], hi - lo)) >= 0
                s = _scores(qc, data[lo - off:hi - off], self.metric,
                            norms[lo - off:hi - off])
                return torch.where(probed, s, float("-inf"))
            return block
        return scorer

    def search(self, queries, k: int):
        vals, rows = _search_top(self._tensor(queries), self.ntotal, k,
                                 self.scorer())
        return _finish(vals, rows, self._ids, k, self.metric, True)


class IVFPQIndex(_Index):
    """IVF plus product quantisation (reference ivfpq_index.cc): each
    point's residual to its cell's centroid, cut into ``m`` subspaces, is
    stored as the nearest of ``ksub`` codewords per subspace; a search
    ranks a point by the look-up table of the query's residual to the
    point's own (probed) cell, summed over the subspaces."""

    def __init__(self, dim: int, nlist: int = 64, nprobe: int = 8,
                 m: int = 4, ksub: int = 64, metric: Optional[int] = None,
                 iters: int = 10, seed: int = 0,
                 device: DeviceLike = "cuda"):
        if dim % m:
            raise InvalidArgumentError(
                "IVFPQIndex: dim %d does not divide into %d subspaces"
                % (dim, m))
        super().__init__(dim, metric, seed, device)
        self.m, self.ksub, self.dsub = m, ksub, dim // m
        self.iters = iters
        self.coarse = IVFFlatIndex(dim, nlist=nlist, nprobe=nprobe, metric=0,
                                   iters=iters, seed=seed,
                                   device=self.device)
        self.codebooks: Optional[torch.Tensor] = None  # [m, ksub, dsub]
        self.codes: Optional[torch.Tensor] = None  # [n, m] int64
        self._cell: Optional[torch.Tensor] = None

    def _residuals(self, x: torch.Tensor):
        cell = _assign(x, self.coarse.centroids)
        return cell, x - self.coarse.centroids[cell]

    def _sub(self, resid: torch.Tensor, s: int) -> torch.Tensor:
        return resid[:, s * self.dsub:(s + 1) * self.dsub].contiguous()

    def train(self, data, init_rows: Optional[Tuple] = None):
        """The coarse k-means, then one k-means per subspace of the
        residuals.  ``init_rows`` is (coarse rows [nlist], codebook rows
        [m][ksub]), or None to draw both from the index's generator."""
        x = self._tensor(data)
        coarse_rows, book_rows = (None, None) if init_rows is None \
            else init_rows
        self.coarse.train(x, coarse_rows)
        _, resid = self._residuals(x)
        books = []
        for s in range(self.m):
            sub = self._sub(resid, s)
            rows = None if book_rows is None else book_rows[s]
            books.append(_kmeans(sub, _rows(sub, rows, self.ksub,
                                            self.generator), self.iters))
        self.codebooks = torch.stack(books)

    def add(self, data, ids):
        if self.codebooks is None:
            raise InvalidArgumentError("IVFPQIndex.add: train() first")
        x = self._tensor(data)
        cell, resid = self._residuals(x)
        codes = torch.stack([_assign(self._sub(resid, s), self.codebooks[s])
                             for s in range(self.m)], dim=1)
        self._append("codes", codes)
        self._append("_cell", cell)
        self._add_ids(ids)

    def _lut(self, qc: torch.Tensor, probe: torch.Tensor,
             centroids: Optional[torch.Tensor] = None,
             codebooks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[q, P * m * ksub] ADC table: minus the squared L2 of each
        subspace of the query's residual to each probed centroid against
        each codeword (default the index's centroids and codebooks)."""
        centroids = self.coarse.centroids if centroids is None else centroids
        codebooks = self.codebooks if codebooks is None else codebooks
        q, p = probe.shape
        resid = qc[:, None, :] - centroids[probe]
        rs = resid.reshape(q, p, self.m, self.dsub)
        diff = rs[:, :, :, None, :] - codebooks[None, None]
        return (-torch.sum(diff * diff, dim=-1)).reshape(q, -1)

    def scorer(self, codes=None, cell=None, centroids=None, codebooks=None,
               off: int = 0):
        """The block scorer of :func:`_search_top` over ``codes`` /
        ``cell`` (default the index's), whose first row is data row
        ``off``, with the coarse ``centroids`` and ``codebooks`` (default
        the index's)."""
        codes_all = self.codes if codes is None else codes
        cell = self._cell if cell is None else cell
        centroids = self.coarse.centroids if centroids is None else centroids
        mk = self.m * self.ksub

        def scorer(qc):
            probe, slot = _probe_slots(qc, centroids, 0, self.coarse.nprobe)
            lut = self._lut(qc, probe, centroids, codebooks)

            def block(lo, hi):
                at = torch.gather(slot, 1, cell[lo - off:hi - off].expand(
                    qc.shape[0], hi - lo))
                base = torch.clamp(at, min=0) * mk
                codes = codes_all[lo - off:hi - off]
                s = torch.gather(lut, 1, base + codes[:, 0])
                for j in range(1, self.m):
                    s = s + torch.gather(lut, 1,
                                         base + (j * self.ksub + codes[:, j]))
                return torch.where(at >= 0, s, float("-inf"))
            return block
        return scorer

    def search(self, queries, k: int):
        vals, rows = _search_top(self._tensor(queries), self.ntotal, k,
                                 self.scorer())
        return _finish(vals, rows, self._ids, k, 0, True)


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_once(index, data, mesh, axis: str):
    """Train ``index`` on the first rank of the mesh's ``axis`` and give
    every other rank of the axis its trained state (coarse centroids,
    codebooks) by broadcast."""
    from graph_learn_tpu_torch.core.sharding import (bind_axes, broadcast,
                                                     mesh_axis)
    ax = mesh_axis(mesh, axis)
    if ax.index == 0:
        index.train(data)
    coarse = index.coarse if isinstance(index, IVFPQIndex) else index
    if not isinstance(coarse, IVFFlatIndex):
        return  # a flat index has nothing trained
    dev = index.device
    with bind_axes(**{axis: ax}):
        if ax.index:
            coarse.centroids = torch.zeros((coarse.nlist, index.dim),
                                           device=dev)
        coarse.centroids = broadcast(coarse.centroids, axis)
        if isinstance(index, IVFPQIndex):
            if ax.index:
                index.codebooks = torch.zeros(
                    (index.m, index.ksub, index.dsub), device=dev)
            index.codebooks = broadcast(index.codebooks, axis)


def build_index(data, ids, option: KnnOption, device: DeviceLike = "cuda",
                mesh=None, axis: str = "graph"):
    """Index factory (reference index_factory.cc): the option's index,
    trained on ``data`` and holding ``data`` under ``ids``.  The index
    records the wall seconds of its ``train`` and ``add`` (``train_s``,
    ``add_s``, the device's work included).  With ``mesh`` every rank of
    its ``axis`` calls it with the same data: the first rank trains and
    the others take its trained state (:func:`_train_once`)."""
    dim = np.shape(data)[1]
    if option.index_type == "flat":
        index = FlatIndex(dim, metric=option.metric, device=device)
    elif option.index_type == "ivfflat":
        index = IVFFlatIndex(dim, nlist=option.nlist, nprobe=option.nprobe,
                             metric=option.metric, device=device)
    elif option.index_type == "ivfpq":
        index = IVFPQIndex(dim, nlist=option.nlist, nprobe=option.nprobe,
                           metric=option.metric, device=device)
    else:
        raise InvalidArgumentError("unknown index type %r"
                                   % option.index_type)
    t0 = time.perf_counter()
    if mesh is None:
        index.train(data)
    else:
        _train_once(index, data, mesh, axis)
    _synchronize(index.device)
    t1 = time.perf_counter()
    index.add(data, ids)
    _synchronize(index.device)
    index.train_s, index.add_s = t1 - t0, time.perf_counter() - t1
    return index


# the row a padding candidate of the merge carries (past every data row)
_PAD_ROW = 2 ** 31 - 1


class ShardedIndex:
    """A built index whose per-point arrays are range-partitioned over the
    mesh's ``axis`` (``graph_learn_tpu/ops/knn.py:281-426``): each rank of
    the axis searches its block of ``rps = ceil(n / P)`` rows and one
    ``all_gather`` of every rank's top k merges them into the answer of
    the whole index.

    Every rank of the axis builds it from its own ``base`` (the same data
    and ids) and calls :meth:`search` with the same queries, as every
    device runs the JAX package's one SPMD program.  The trained state is
    the axis's first rank's: its coarse centroids and codebooks are
    broadcast and replicated, and so are its cell assignments and codes,
    of which each rank keeps its block (a k-means whose sums are atomic
    on the card need not give two ranks the same bits).  Each rank keeps
    its block of the data rows (``flat``, ``ivfflat``) or codes
    (``ivfpq``) and of the cells.

    A rank scores its block through the chunked scorer of the base index
    (``_search_top``, no [m, n] tensor), pads its top ``min(k, rows)``
    to k with -inf at row ``2**31 - 1``, and the gathered candidates are
    merged by one stable sort: they come in rank order, each rank's equal
    values in ascending row, so equal scores resolve to the lower global
    row as one ``top_k`` over the whole index does.  Ids and the -1 and
    inf padding follow the base index; IVFPQ distances are the negated
    top whatever the metric."""

    def __init__(self, base, mesh, axis: str = "graph"):
        from graph_learn_tpu_torch.core.sharding import (all_gather,
                                                         bind_axes,
                                                         broadcast,
                                                         mesh_axis)
        ax = mesh_axis(mesh, axis)
        self.base, self.mesh, self.axis = base, mesh, axis
        self._axis = ax
        self.nshards = p = ax.size
        n = base.ntotal
        self.rps = rps = max(-(-n // p), 1)
        self.lo = min(ax.index * rps, n)
        self.rows = min(self.lo + rps, n) - self.lo
        if isinstance(base, FlatIndex):
            self._kind = "flat"
        elif isinstance(base, IVFFlatIndex):
            self._kind = "ivfflat"
        elif isinstance(base, IVFPQIndex):
            self._kind = "ivfpq"
        else:
            raise InvalidArgumentError("cannot shard index type %s"
                                       % type(base).__name__)
        dev = base.device
        with bind_axes(**{axis: ax}):
            shape = torch.tensor([n, base.dim], device=dev)
            if not bool((all_gather(shape[None], axis) == shape).all()):
                raise InvalidArgumentError(
                    "shard_index: the ranks of the %r axis hold indexes of "
                    "different sizes" % axis)
            block = slice(self.lo, self.lo + self.rows)
            self.repl = {}
            if self._kind == "flat":
                self.block = {"data": base._data[block],
                              "norms": base._norms[block]}
                return
            coarse = base.coarse if self._kind == "ivfpq" else base
            self.repl["centroids"] = broadcast(coarse.centroids, axis)
            cell = broadcast(base._cell, axis)[block]
            if self._kind == "ivfflat":
                self.block = {"data": base._data[block],
                              "norms": base._norms[block], "cell": cell}
            else:
                self.repl["codebooks"] = broadcast(base.codebooks, axis)
                self.block = {"codes": broadcast(base.codes, axis)[block],
                              "cell": cell}

    @property
    def ntotal(self) -> int:
        return self.base.ntotal

    def _scorer(self):
        b, r, off = self.block, self.repl, self.lo
        if self._kind == "flat":
            return self.base.scorer(b["data"], b["norms"], off=off)
        if self._kind == "ivfflat":
            return self.base.scorer(b["data"], b["norms"], b["cell"],
                                    r["centroids"], off=off)
        return self.base.scorer(b["codes"], b["cell"], r["centroids"],
                                r["codebooks"], off=off)

    def search(self, queries, k: int):
        """-> (ids [m, k] int64, distances [m, k] float32), numpy: the
        base index's answer.  Every rank of the axis calls it with the
        same queries."""
        from graph_learn_tpu_torch.core.sharding import all_gather, bind_axes
        base = self.base
        q = base._tensor(queries)
        m = q.shape[0]
        vals, rows = _search_top(q, self.rows, k, self._scorer(),
                                 start=self.lo)
        pad = k - vals.shape[1]
        if pad:
            vals = torch.nn.functional.pad(vals, (0, pad),
                                           value=float("-inf"))
            rows = torch.nn.functional.pad(rows, (0, pad), value=_PAD_ROW)
        with bind_axes(**{self.axis: self._axis}):
            gv = all_gather(vals.contiguous(), self.axis)
            gr = all_gather(rows.contiguous(), self.axis)
        p = self.nshards
        cand_v = gv.reshape(p, m, k).permute(1, 0, 2).reshape(m, p * k)
        cand_r = gr.reshape(p, m, k).permute(1, 0, 2).reshape(m, p * k)
        top, order = torch.sort(cand_v, dim=1, descending=True, stable=True)
        top = top[:, :k]
        rows = torch.gather(cand_r, 1, order[:, :k])
        valid = torch.isfinite(top)
        ids = torch.where(valid, base._ids[torch.where(valid, rows, 0)], -1)
        if self._kind == "ivfpq" or base.metric == 0:
            dist = torch.where(valid, -top, float("inf"))
        else:
            dist = torch.where(valid, top, float("-inf"))
        return ids.cpu().numpy(), dist.cpu().numpy()


def shard_index(index, mesh, axis: str = "graph") -> ShardedIndex:
    """``index`` (built on every rank of the axis from the same data)
    distributed over the mesh's ``axis``: :class:`ShardedIndex`."""
    return ShardedIndex(index, mesh, axis=axis)
