"""The port's ``Checkpointer`` (nn/checkpoint.py, over ``torch.save``):
save, the latest step, restore, ``max_to_keep``, ``force``, an empty
directory, a resumed run that continues bit for bit; and params the JAX
package trained and restored through its own (orbax) ``Checkpointer``,
carried over by ``nn/convert.load_flax_params``, give the port's model
the JAX logits."""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from graph_learn_tpu.core.schema import Decoder as JaxDecoder
from graph_learn_tpu.nn.checkpoint import Checkpointer as JaxCheckpointer
from graph_learn_tpu.nn.loss import supervised_softmax_loss as jax_loss
from graph_learn_tpu.nn.models.ego_gnn import EgoGraphSAGE as JaxEgoGraphSAGE
from graph_learn_tpu_torch import Decoder
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.nn.checkpoint import Checkpointer
from graph_learn_tpu_torch.nn.convert import load_flax_params
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from torch_parity import ego_pair

D = 8
# f32 throughout; the two frameworks sum in other orders
TOL = dict(rtol=1e-5, atol=1e-5)


def _model(seed=0):
    torch.manual_seed(seed)
    return EgoGraphSAGE([D, 16, 4], Decoder(attr_types=["float"] * D),
                        agg_type="gcn", device="cpu")


def _step(model, opt, ego, labels):
    loss = supervised_softmax_loss(model(ego, training=False), labels)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def test_save_latest_restore_and_resume_bit_for_bit(tmp_path):
    _, ego, labels = ego_pair(D)
    labels = torch.from_numpy(labels)
    model = _model()
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    ck = Checkpointer(str(tmp_path / "ck"), device="cpu")
    assert ck.latest_step() is None and ck.restore() is None
    for step in range(1, 6):
        _step(model, opt, ego, labels)
    assert ck.save(5, {"model": model.state_dict(),
                       "optimizer": opt.state_dict(), "step": 5,
                       "extra": {"epoch": 1, "note": "five"}})
    assert ck.latest_step() == 5 and ck.all_steps() == [5]
    assert os.listdir(tmp_path / "ck") == ["step_5.pt"]

    fresh = _model(seed=1)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=0.05)
    state = ck.restore({"model": None, "optimizer": None})
    assert state["step"] == 5 and state["extra"] == {"epoch": 1,
                                                     "note": "five"}
    fresh.load_state_dict(state["model"])
    fresh_opt.load_state_dict(state["optimizer"])
    a = _step(model, opt, ego, labels)
    b = _step(fresh, fresh_opt, ego, labels)
    assert torch.equal(a, b)
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(InvalidArgumentError, match="lacks"):
        ck.restore({"model": None, "ema": None})


def test_max_to_keep_force_and_old_steps(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2, device="cpu")
    for step in (1, 2, 3, 4):
        assert ck.save(step, {"w": torch.full((3,), float(step))})
    assert ck.all_steps() == [3, 4]
    assert ck.restore(step=3)["w"][0].item() == 3.0
    # a step not newer than the latest is skipped, unless forced
    assert not ck.save(2, {"w": torch.zeros(3)})
    assert not ck.save(4, {"w": torch.zeros(3)})
    assert ck.restore()["w"][0].item() == 4.0
    assert ck.save(4, {"w": torch.zeros(3)}, force=True)
    assert ck.restore()["w"][0].item() == 0.0
    with pytest.raises(InvalidArgumentError, match="no checkpoint"):
        ck.restore(step=1)
    keep_all = Checkpointer(str(tmp_path / "all"), max_to_keep=None,
                            device="cpu")
    for step in range(5):
        keep_all.save(step, {"s": step})
    assert keep_all.all_steps() == list(range(5))
    with pytest.raises(InvalidArgumentError, match="max_to_keep"):
        Checkpointer(str(tmp_path / "bad"), max_to_keep=0, device="cpu")
    # no temporary file is left behind
    assert all(n.endswith(".pt") for n in os.listdir(tmp_path / "ck"))


def test_jax_params_through_the_jax_checkpointer_give_the_same_logits(
        tmp_path):
    jego, tego, labels = ego_pair(D)
    jmodel = JaxEgoGraphSAGE([D, 16, 4], JaxDecoder(attr_types=["float"] * D),
                             agg_type="gcn")
    params = jmodel.init(jax.random.key(0), jego, training=False)
    opt = optax.adam(0.05)
    opt_state = opt.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(lambda q: jax_loss(
            jmodel.apply(q, jego, training=False), labels))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    for _ in range(3):
        params, opt_state, _ = step(params, opt_state)
    jck = JaxCheckpointer(str(tmp_path / "orbax"))
    jck.save(3, {"params": params, "step": 3})
    template = jax.tree.map(np.zeros_like, {"params": params, "step": 3})
    restored = jck.restore(template)
    tmodel = _model(seed=2)
    load_flax_params(tmodel, jax.tree.map(np.asarray, restored["params"]))
    want = np.asarray(jmodel.apply(params, jego, training=False))
    with torch.no_grad():
        got = tmodel(tego).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # and the carried-over model checkpoints and restores through the port
    ck = Checkpointer(str(tmp_path / "port"), device="cpu")
    ck.save(3, {"model": tmodel.state_dict(), "step": 3})
    again = _model(seed=3)
    again.load_state_dict(ck.restore()["model"])
    with torch.no_grad():
        assert torch.equal(again(tego), tmodel(tego))
