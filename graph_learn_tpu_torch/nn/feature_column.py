"""Feature encoding: numeric attr columns -> dense float features.

Counterpart of ``graph_learn_tpu/nn/feature_column.py`` ``FeatureEncoder:32``
for float-only decoders (numeric passthrough plus an optional projection).
Embedding and multi-value columns are not yet ported.  The output is cast
to ``conf.compute_dtype``, as at ``feature_column.py:84-87`` of the JAX
package: a bf16 feature table is encoded in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.utils.platform import torch_dtype


class FeatureEncoder(nn.Module):
    """Encode one node type's float attrs into [n, out_dim]."""

    def __init__(self, decoder: Decoder, output_dim: Optional[int] = None):
        super().__init__()
        self.decoder = decoder
        self.output_dim = output_dim
        self.proj = (nn.Linear(decoder.float_attr_num, output_dim)
                     if output_dim is not None else None)

    def forward(self, nodes) -> torch.Tensor:
        f = nodes.float_attrs
        if f is None or not self.decoder.float_attr_num:
            raise ValueError("node type %r has no encodable attributes"
                             % getattr(nodes, "type_name", "?"))
        out = f.reshape(-1, f.shape[-1]).to(torch_dtype(conf.compute_dtype))
        if self.proj is not None:
            out = self.proj(out)
        return out
