"""Weight carry-over to and from the JAX package's flax models.

``load_flax_params(model, params)`` copies the params of a flax
``EgoGraphSAGE``, ``EgoGAT``, ``EgoGIN`` or ``EgoRGCN``
(``graph_learn_tpu/nn/models/ego_gnn.py:126, 140, 157, 169``), or of the
temporal models (``graph_learn_tpu/nn/models/tgat.py``: ``EgoTGAT``,
``LinkScorePredict``, and modules built of them such as the ego_tgat
example's ``TGATLink``), or of the SubGraph models
(``graph_learn_tpu/nn/models/sub_models.py``: ``SubGraphStack`` as
``GraphSAGE`` / ``GCN`` / ``GAT`` make it, ``LinkPredictor``, the convs
of ``nn/layers/sub.py`` and ``HeteroConv``, and modules built of them
such as the sage_unsupervised example's ``SageLink``), given as the
nested dict of numpy arrays that
``model.init`` / training produce, into the port's model;
``to_flax_params(model)`` is the inverse, so that weights trained in
either package can be compared.  The flax tree is

    params/layers_<i>/convs_0/trans_nodes/{kernel, bias?}       (SAGE)
    params/layers_<i>/convs_0/{x_<h>, n_<h>, attn_<h>}/{kernel, bias?}
                                  (GAT; n_<h> only with hetero dims)
    params/layers_<i>/convs_0/{trans_x, trans_nbrs, output}/{kernel, bias?}
                     (GIN; trans_x and trans_nbrs only with hetero dims)
    params/encoder/proj/{kernel, bias?}      (only with an output_dim)
    params/encoder/{embedding_<a>, embedding_mv_<a>}
                   (a FeatureEncoder's tables, <a> the attribute's index)
    params/hop_encoders_<i>/{proj, embedding_<a>, embedding_mv_<a>}
                          (with ``hop_encoders``, in place of ``encoder``)
    params/rgcn_<i>/{weight, coefficient?, bias?, root_weight/kernel}
                  (RGCN; its encoder never projects, so it has no params)
    params/time_encoder/{basis_freq, phase}                   (EgoTGAT)
    params/tgat_conv_<l>/{x_<h>, n_<h>, attn_<h>}/kernel
                                (EgoTGAT; n_<h> on level 0 only)
    params/affinity_score/{merge_layer1, merge_layer2}/{kernel, bias}
                                                    (LinkScorePredict)
    params/{ir, iz, in, hn}/{kernel, bias}, params/{hr, hz}/kernel
                                          (GRUCell, a torch.nn.GRUCell)
    params/convs_<i>/{neigh_weights, self_weights?}/kernel, bias?
    params/convs_<i>/weights/kernel, bias?
    params/convs_<i>/{w/kernel, attn_src, attn_dst, bias?}
                  (SubGraphStack: SAGE, GCN or GAT convs; a bare conv is
                   the tree of one convs_<i>; HeteroConv: convs_<edge type>)
    params/{sage, gcn, gat}_<i>/...
                  (a stack built inside another module's setup, as the
                   sage_unsupervised example's SageLink builds ``sage``:
                   flax adopts its convs into that module under the names
                   GraphSAGE / GCN / GAT give them, and the stack's own
                   name holds nothing)
    params/{mlp_<i>, out}/{kernel, bias}                 (LinkPredictor)

Any other module maps its named children to subtrees of the same names
(``TGATLink``: ``u_enc``, ``i_enc`` (a ``FeatureEncoder``'s ``proj``, where
it projects), ``u_tower``, ``i_tower``, ``scorer``; the tgn example's
``TGNScorer``: ``proj_u``, ``proj_i``); an ``EgoTGAT``'s encoders belong
to the module that names them, so its own tree does not repeat them.

A ``torch.nn.GRUCell``'s ``weight_ih`` / ``weight_hh`` stack the r, z and n
gates' [out, in] weights, which are flax's ``i<gate>`` / ``h<gate>``
kernels transposed; ``bias_ih`` holds flax's three input biases and
``bias_hh`` the ``hn`` bias after two zeros (flax's r and z gates have no
hidden bias, and the port's cell holds those two at zero).

Each Dense of a conv is a ``torch.nn.Linear`` child of the same name.  A
two-tower model, a dict or ``nn.ModuleDict`` of ``EgoGNN`` such as
``{"u": u_tower, "i": i_tower}``, maps to the dict of the towers' params
under the same keys.

``EgoLayer`` shares one conv across its hop pairs, so each layer holds a
single ``convs_0`` whatever its pair count.  A flax ``Dense`` kernel is
[in, out]; a ``torch.nn.Linear`` weight is [out, in].  The RGCN's raw
``weight``, ``coefficient`` and ``bias`` arrays carry over as they are.
Every leaf of the tree must be used: a leftover raises.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np
import torch
from torch import nn

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.layers.sub import (GATConv, GCNConv,
                                                 HeteroConv, SAGEConv)
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGNN, EgoRGCN
from graph_learn_tpu_torch.nn.models.sub_models import SubGraphStack
from graph_learn_tpu_torch.nn.models.tgat import EgoTGAT, TimeEncoder


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
            b = torch.from_numpy(np.array(tree["bias"], np.float32))
            linear.bias.copy_(b.to(linear.bias.device, linear.bias.dtype))
            used.add(path + ("bias",))


def _load_array(param: nn.Parameter, value, path, used):
    a = np.asarray(value, np.float32)
    if a.shape != tuple(param.shape):
        raise InvalidArgumentError("%s: flax array %s, the port's %s"
                                   % ("/".join(path), a.shape,
                                      tuple(param.shape)))
    with torch.no_grad():
        param.copy_(torch.from_numpy(a.copy()).to(param.device, param.dtype))
    used.add(path)


_GATES = ("r", "z", "n")


def _load_gru(cell: nn.GRUCell, tree: Dict, path, used):
    h = cell.hidden_size

    def kernel(name, rows):
        k = np.asarray(_at(tree, (name, "kernel")), np.float32)
        if k.shape != (rows, h):
            raise InvalidArgumentError("%s: flax kernel %s does not fit "
                                       "GRUCell(%d -> %d)"
                                       % ("/".join(path + (name,)), k.shape,
                                          cell.input_size, h))
        used.add(path + (name, "kernel"))
        return k.T

    def bias(name):
        used.add(path + (name, "bias"))
        return np.asarray(_at(tree, (name, "bias")), np.float32)

    w_ih = np.concatenate([kernel("i" + g, cell.input_size) for g in _GATES])
    w_hh = np.concatenate([kernel("h" + g, h) for g in _GATES])
    b_ih = np.concatenate([bias("i" + g) for g in _GATES])
    b_hh = np.concatenate([np.zeros(2 * h, np.float32), bias("hn")])
    with torch.no_grad():
        for param, value in ((cell.weight_ih, w_ih), (cell.weight_hh, w_hh),
                             (cell.bias_ih, b_ih), (cell.bias_hh, b_hh)):
            param.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(
                param.device, param.dtype))


def _gru_tree(cell: nn.GRUCell) -> Dict:
    w_ih, w_hh = (cell.weight_ih.detach().cpu().numpy(),
                  cell.weight_hh.detach().cpu().numpy())
    b_ih, b_hh = (cell.bias_ih.detach().cpu().numpy(),
                  cell.bias_hh.detach().cpu().numpy())
    h = cell.hidden_size
    tree: Dict = {}
    for j, g in enumerate(_GATES):
        rows = slice(j * h, (j + 1) * h)
        tree["i" + g] = {"kernel": w_ih[rows].T.copy(),
                         "bias": b_ih[rows].copy()}
        tree["h" + g] = {"kernel": w_hh[rows].T.copy()}
    tree["hn"]["bias"] = b_hh[2 * h:].copy()
    return tree


def _rgcn_arrays(model: nn.Module):
    """(flax path, Parameter) of an EgoRGCN's raw arrays."""
    for i, conv in enumerate(model.convs):
        for name in ("weight", "coefficient", "bias"):
            p = getattr(conv, name)
            if p is not None:
                yield ("rgcn_%d" % i, name), p


def _denses(model: nn.Module):
    """(flax path, Linear) of every Dense the flax tree of ``model`` holds."""
    if isinstance(model, EgoRGCN):
        for i, conv in enumerate(model.convs):
            yield ("rgcn_%d" % i, "root_weight"), conv.root_weight
        return
    for i, layer in enumerate(model.layers):
        convs = layer.convs[:1] if layer.share else layer.convs
        for j, conv in enumerate(convs):
            for name, child in conv.named_children():
                if isinstance(child, nn.Linear):
                    yield ("layers_%d" % i, "convs_%d" % j, name), child
    if model.hop_encoders is not None:
        encoders = [("hop_encoders_%d" % i, enc)
                    for i, enc in enumerate(model.hop_encoders)]
    else:
        encoders = [("encoder", model.encoder)]
    for name, enc in encoders:
        yield from _encoder_items(enc, (name,))


def _encoder_items(enc: nn.Module, prefix):
    """(flax path, Linear or Parameter) of a ``FeatureEncoder``'s tree:
    its ``proj`` and its embedding tables."""
    if not isinstance(enc, FeatureEncoder):
        return
    if enc.proj is not None:
        yield prefix + ("proj",), enc.proj
    for name, table in enc.embedding_tables():
        yield prefix + (name,), table


# the conv names GraphSAGE / GCN / GAT give (sub_models.py:38-61)
_STACK_CONV_NAMES = {SAGEConv: "sage_%d", GCNConv: "gcn_%d", GATConv: "gat_%d"}


def _module_items(model: nn.Module, prefix=(), owned=frozenset()):
    """(flax path, Linear or Parameter) of a temporal or SubGraph model's
    tree, or of any module made of such parts.

    ``owned`` holds the ids of the modules an enclosing module names (a
    flax module made in its parent's ``setup``); an EgoTGAT's node and
    edge encoders that no enclosing module names are its own, under
    ``encoders_<i>`` / ``edge_encoders_<i>``, as flax adopts them."""
    if isinstance(model, SubGraphStack):
        for i, conv in enumerate(model.convs):
            path = (prefix[:-1] + (_STACK_CONV_NAMES[type(conv)] % i,)
                    if prefix else ("convs_%d" % i,))
            yield from _module_items(conv, path)
    elif isinstance(model, HeteroConv):
        for et, conv in model.convs.items():
            yield from _module_items(conv, prefix + ("convs_%s" % et,))
    elif isinstance(model, (SAGEConv, GCNConv, GATConv)):
        for name, child in model.named_children():
            yield prefix + (name,), child
        for name, param in model.named_parameters(recurse=False):
            yield prefix + (name,), param
    elif isinstance(model, TimeEncoder):
        yield prefix + ("basis_freq",), model.basis_freq
        yield prefix + ("phase",), model.phase
    elif isinstance(model, EgoTGAT):
        yield from _module_items(model.time_encoder,
                               prefix + ("time_encoder",))
        for lvl, conv in enumerate(model.convs):
            for name, child in conv.named_children():
                yield prefix + ("tgat_conv_%d" % lvl, name), child
        seen = set(owned)
        for name, encs in (("encoders", dict(enumerate(model.encoders))),
                           ("edge_encoders", {
                               int(i): enc for i, enc in
                               model.edge_encoders.items()})):
            for i, enc in sorted(encs.items()):
                if id(enc) not in seen:
                    seen.add(id(enc))
                    yield from _encoder_items(enc, prefix + (
                        "%s_%d" % (name, i),))
    elif isinstance(model, FeatureEncoder):
        yield from _encoder_items(model, prefix)
    elif isinstance(model, (nn.Linear, nn.GRUCell)):
        yield prefix, model
    else:
        owned = owned | {id(c) for c in model.children()}
        for name, child in model.named_children():
            yield from _module_items(child, prefix + (name,), owned)


def _items(model: nn.Module):
    """(flax path, Linear or Parameter) of every leaf group of the tree."""
    if isinstance(model, (EgoGNN, EgoRGCN)):
        yield from _denses(model)
        if isinstance(model, EgoRGCN):
            yield from _rgcn_arrays(model)
    else:
        yield from _module_items(model)


def _towers(model) -> bool:
    """Is ``model`` a dict (or ModuleDict) of towers?"""
    return isinstance(model, (dict, nn.ModuleDict))


def _at(tree: Dict, path):
    for key in path:
        if key not in tree:
            raise InvalidArgumentError("flax params lack %s" % "/".join(path))
        tree = tree[key]
    return tree


def load_flax_params(model, params: Dict):
    """Copy flax ``EgoGraphSAGE`` / ``EgoGAT`` / ``EgoGIN`` / ``EgoGNN``
    params into the port's ``EgoGNN``, flax ``EgoRGCN`` params into the
    port's ``EgoRGCN``, a temporal model's into its port, or each tower's
    params into its tower."""
    if _towers(model):
        if sorted(model.keys()) != sorted(params.keys()):
            raise InvalidArgumentError(
                "towers %s, flax params for %s"
                % (sorted(model.keys()), sorted(params.keys())))
        for k in model.keys():
            load_flax_params(model[k], params[k])
        return model
    tree = params["params"] if "params" in params else params
    used: Set[Tuple[str, ...]] = set()
    for path, leaf in _items(model):
        if isinstance(leaf, nn.Linear):
            _load_dense(leaf, _at(tree, path), path, used)
        elif isinstance(leaf, nn.GRUCell):
            _load_gru(leaf, _at(tree, path), path, used)
        else:
            _load_array(leaf, _at(tree, path), path, used)
    extra = _leaves(tree) - used
    if extra:
        raise InvalidArgumentError(
            "flax params not carried over: %s"
            % sorted("/".join(p) for p in extra))
    return model


def to_flax_params(model) -> Dict:
    """The port's ``EgoGNN`` or ``EgoRGCN`` weights as the flax tree (numpy
    arrays), or a dict of the towers' trees; the inverse of
    :func:`load_flax_params`."""
    if _towers(model):
        return {k: to_flax_params(model[k]) for k in model.keys()}
    tree: Dict = {}
    for path, leaf in _items(model):
        if isinstance(leaf, nn.GRUCell):
            # the cell's own tree, at the top when the model is the cell
            sub = tree
            for key in path:
                sub = sub.setdefault(key, {})
            sub.update(_gru_tree(leaf))
            continue
        sub = tree
        for key in path[:-1]:
            sub = sub.setdefault(key, {})
        if isinstance(leaf, nn.Linear):
            sub = sub.setdefault(path[-1], {})
            sub["kernel"] = leaf.weight.detach().cpu().numpy().T.copy()
            if leaf.bias is not None:
                sub["bias"] = leaf.bias.detach().cpu().numpy().copy()
        else:
            sub[path[-1]] = leaf.detach().cpu().numpy().copy()
    return {"params": tree}
