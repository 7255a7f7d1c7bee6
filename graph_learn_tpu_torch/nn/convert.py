"""Weight carry-over from the JAX package's flax models.

``load_flax_params(model, params)`` copies the params of a flax
``EgoGraphSAGE`` (``graph_learn_tpu/nn/models/ego_gnn.py:126``), given as
the nested dict of numpy arrays that ``model.init`` / training produce,
into the port's ``EgoGNN``.  The flax tree is

    params/layers_<i>/convs_0/trans_nodes/{kernel, bias?}
    params/encoder/proj/{kernel, bias?}      (only with an output_dim)

``EgoLayer`` shares one conv across its hop pairs, so each layer holds a
single ``convs_0`` whatever its pair count.  A flax ``Dense`` kernel is
[in, out]; a ``torch.nn.Linear`` weight is [out, in].  Every leaf of the
tree must be used: a leftover raises.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np
import torch
from torch import nn

from graph_learn_tpu_torch.errors import InvalidArgumentError


def _leaves(tree, prefix=()) -> Set[Tuple[str, ...]]:
    if isinstance(tree, dict):
        out = set()
        for k, v in tree.items():
            out |= _leaves(v, prefix + (k,))
        return out
    return {prefix}


def _load_dense(linear: nn.Linear, tree: Dict, path, used):
    kernel = np.asarray(tree["kernel"], np.float32)
    if kernel.shape != (linear.in_features, linear.out_features):
        raise InvalidArgumentError(
            "%s: flax kernel %s does not fit Linear(%d -> %d)"
            % ("/".join(path), kernel.shape, linear.in_features,
               linear.out_features))
    with torch.no_grad():
        w = linear.weight
        w.copy_(torch.from_numpy(kernel.T.copy()).to(w.device, w.dtype))
        used.add(path + ("kernel",))
        if "bias" in tree:
            if linear.bias is None:
                raise InvalidArgumentError(
                    "%s: flax Dense has a bias, the Linear has none"
                    % "/".join(path))
            b = torch.from_numpy(np.asarray(tree["bias"], np.float32))
            linear.bias.copy_(b.to(linear.bias.device, linear.bias.dtype))
            used.add(path + ("bias",))


def load_flax_params(model: nn.Module, params: Dict) -> nn.Module:
    """Copy flax ``EgoGraphSAGE`` params into the port's ``EgoGNN``."""
    tree = params["params"] if "params" in params else params
    used: Set[Tuple[str, ...]] = set()
    for i, layer in enumerate(model.layers):
        convs = layer.convs[:1] if layer.share else layer.convs
        for j, conv in enumerate(convs):
            path = ("layers_%d" % i, "convs_%d" % j, "trans_nodes")
            sub = tree
            for key in path:
                if key not in sub:
                    raise InvalidArgumentError(
                        "flax params lack %s" % "/".join(path))
                sub = sub[key]
            _load_dense(conv.trans_nodes, sub, path, used)
    proj = getattr(model.encoder, "proj", None)
    if proj is not None:
        _load_dense(proj, tree["encoder"]["proj"], ("encoder", "proj"), used)
    extra = _leaves(tree) - used
    if extra:
        raise InvalidArgumentError(
            "flax params not carried over: %s"
            % sorted("/".join(p) for p in extra))
    return model
