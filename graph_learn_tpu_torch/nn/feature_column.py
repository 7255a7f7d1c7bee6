"""Feature encoding: attribute columns -> dense float features.

Counterpart of ``graph_learn_tpu/nn/feature_column.py`` ``FeatureEncoder:32``:
numeric columns pass through; each int (embedding id) column looks its
ids, clipped to ``[0, bucket - 1]``, up in a table ``embedding_<index>`` of
``(bucket or DYNAMIC_BUCKET, dim or 8)``; each multi-value column takes
the mean of its first ``len`` items' rows in ``embedding_mv_<index>``
(over ``max(len, 1)``, so an empty row encodes to zeros).  The parts are
concatenated floats, then int embeddings, then multi-value, each cast to
``conf.compute_dtype`` (a bf16 feature table is encoded in f32), and
``proj`` (a Linear to ``output_dim``) follows when it is given.

Tables start as flax's ``variance_scaling(1.0, "fan_out", "uniform")``
draws, uniform in ``±sqrt(3 / dim)``, from an explicit generator.  Their
gradients are dense, as in the JAX package.  The lookups are
``torch.nn.functional.embedding``, in plain PyTorch: the JAX package
computes them outside any Pallas kernel, and Kernel 2 refuses a table
that needs a gradient.  Its backward sorts the ids and sums each id's rows
in segments; the backward of ``table[ids]`` adds an id's rows one after
another, which took 32.5 of a 35.3 ms bipartite step on an H100 when a
skewed category repeated one id thousands of times in a batch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.schema import AttrDef, Decoder
from graph_learn_tpu_torch.utils.platform import torch_dtype

# rows of the table of a column without a bucket (a "string" column with
# no bucket is hashed modulo 2**31 - 1 at parse time, so its ids clip to
# the last row)
DYNAMIC_BUCKET = 1 << 20


def _table_shape(a: AttrDef):
    return (a.bucket_size or DYNAMIC_BUCKET, a.dim or 8)


class FeatureEncoder(nn.Module):
    """Encode one node or edge type's attributes into [n, out_dim]."""

    def __init__(self, decoder: Decoder, output_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.decoder = decoder
        self.output_dim = output_dim
        for prefix, attrs in (("embedding_", decoder.int_attrs),
                              ("embedding_mv_", decoder.multival_attrs)):
            for a in attrs:
                self.register_parameter(
                    prefix + str(a.index),
                    nn.Parameter(torch.empty(_table_shape(a))))
        self.proj = (nn.Linear(self.out_dim(decoder), output_dim)
                     if output_dim is not None else None)
        self.reset_embeddings(generator)

    def reset_embeddings(self, generator: Optional[torch.Generator] = None):
        """Every embedding table uniform in ``±sqrt(3 / dim)`` (flax's
        ``variance_scaling(1.0, "fan_out", "uniform")``), drawn on the
        tables' device from ``generator`` (default: seeded with 0)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for _, table in self.embedding_tables():
                limit = math.sqrt(3.0 / table.shape[1])
                table.uniform_(-limit, limit, generator=generator)

    def embedding_tables(self):
        """(name, table) of every embedding table, in attribute order."""
        for prefix, attrs in (("embedding_", self.decoder.int_attrs),
                              ("embedding_mv_", self.decoder.multival_attrs)):
            for a in attrs:
                yield prefix + str(a.index), getattr(self, prefix
                                                     + str(a.index))

    def forward(self, nodes) -> torch.Tensor:
        d = self.decoder
        feats = []
        if nodes.float_attrs is not None and d.float_attr_num:
            f = nodes.float_attrs
            feats.append(f.reshape(-1, f.shape[-1]))
        if nodes.int_attrs is not None and d.int_attr_num:
            ia = nodes.int_attrs.reshape(-1, nodes.int_attrs.shape[-1])
            for col, a in enumerate(d.int_attrs):
                emb = getattr(self, "embedding_%d" % a.index)
                ids = torch.clamp(ia[:, col], 0, emb.shape[0] - 1)
                feats.append(F.embedding(ids.long(), emb))
        if nodes.multival_attrs is not None and d.multival_attr_num:
            mv = nodes.multival_attrs.reshape(
                (-1,) + tuple(nodes.multival_attrs.shape[-2:]))
            ml = nodes.multival_lens.reshape(
                -1, nodes.multival_lens.shape[-1])
            for col, a in enumerate(d.multival_attrs):
                emb = getattr(self, "embedding_mv_%d" % a.index)
                ids = torch.clamp(mv[:, col], 0, emb.shape[0] - 1)  # [n, L]
                vecs = F.embedding(ids.long(), emb)  # [n, L, dim]
                L = ids.shape[-1]
                lens = ml[:, col][:, None]
                mask = torch.arange(L, device=ids.device)[None, :] < lens
                s = torch.where(mask[..., None], vecs, 0.0).sum(dim=1)
                feats.append(s / torch.clamp(lens, min=1).to(s.dtype))
        if not feats:
            raise ValueError("node type %r has no encodable attributes"
                             % getattr(nodes, "type_name", "?"))
        compute = torch_dtype(conf.compute_dtype)
        out = torch.cat([f.to(compute) for f in feats], dim=-1)
        if self.proj is not None:
            out = self.proj(out)
        return out

    @staticmethod
    def out_dim(decoder: Decoder, output_dim: Optional[int] = None) -> int:
        """The encoder's output width."""
        if output_dim is not None:
            return output_dim
        dim = decoder.float_attr_num
        for a in decoder.int_attrs + decoder.multival_attrs:
            dim += a.dim or 8
        return dim
