"""The benchmark's one graph generator: a directed graph whose endpoints
are drawn with probability proportional to ``(rank + 1) ** -alpha``.

Every number comes from one ``torch.Generator`` seeded with the run's seed,
drawn on the run's device in a fixed order and copied to the host once:

1. ``order``: a random permutation of the nodes; rank r is node
   ``order[r]``, so the hubs' ids are scattered over the id range;
2. ``features``: standard normal, [n, feat_dim] float32;
3. ``labels``: uniform over ``classes``, int32;
4. ``src`` and ``dst``: ``edges`` endpoints each, drawn independently by
   rank (uniform ids where ``alpha`` is 0), int64;
5. ``weights``: uniform on [0, 1), float32.

With ``symmetric`` each drawn edge is stored in both directions (the
reversed copies after the drawn ones, with the same weights), as an
undirected graph's edge list holds it: ``2 * edges`` directed edges.

With ``alpha`` 0 every out-degree is Binomial(edges, 1/n); with ``alpha``
0.5 the largest expected degree is about ``edges / (2 sqrt(n))`` and the
smallest about half the mean.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# endpoints drawn per call: bounds the float64 draws' memory
CHUNK = 1 << 24


def rank_cdf(n: int, alpha: float, device) -> torch.Tensor:
    """The float64 CDF over ranks 0..n-1 of weights ``(r + 1) ** -alpha``."""
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** -alpha
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def draw_endpoints(count: int, n: int, alpha: float, order: torch.Tensor,
                   cdf, gen: torch.Generator) -> torch.Tensor:
    """``count`` node ids, each of rank r with probability ∝ (r+1)^-alpha."""
    dev = gen.device
    if alpha == 0:
        return torch.randint(0, n, (count,), generator=gen, device=dev)
    out = torch.empty(count, dtype=torch.int64, device=dev)
    for lo in range(0, count, CHUNK):
        hi = min(lo + CHUNK, count)
        u = torch.rand(hi - lo, generator=gen, device=dev, dtype=torch.float64)
        r = torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)
        out[lo:hi] = order[r]
    return out


def generate(params: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """The graph of ``params`` (``nodes``, ``edges``, ``feat_dim``,
    ``classes``, ``alpha``, optionally ``symmetric``) for ``seed``, as host
    arrays: ``features``, ``labels``, ``src``, ``dst``, ``weights``."""
    n, m = int(params["nodes"]), int(params["edges"])
    alpha = float(params["alpha"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    order = torch.randperm(n, generator=gen, device=dev)
    out = {"features": torch.randn((n, int(params["feat_dim"])),
                                   generator=gen, device=dev),
           "labels": torch.randint(0, int(params["classes"]), (n,),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)}
    cdf = rank_cdf(n, alpha, dev) if alpha else None
    out["src"] = draw_endpoints(m, n, alpha, order, cdf, gen)
    out["dst"] = draw_endpoints(m, n, alpha, order, cdf, gen)
    out["weights"] = torch.rand(m, generator=gen, device=dev)
    if params.get("symmetric", False):
        src, dst = out["src"], out["dst"]
        out["src"], out["dst"] = torch.cat([src, dst]), torch.cat([dst, src])
        out["weights"] = out["weights"].repeat(2)
        del src, dst
    host = {k: v.cpu().numpy() for k, v in out.items()}
    del out, order, cdf
    return host
