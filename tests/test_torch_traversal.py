"""The port's Traverser against the JAX package's: the same seed gives the
same batches, bit for bit (both are numpy on the host)."""

import numpy as np
import pytest

from graph_learn_tpu.core.traversal import Traverser as JaxTraverser
from graph_learn_tpu.errors import OutOfRangeError as JaxOutOfRangeError
from graph_learn_tpu_torch.core.traversal import Traverser
from graph_learn_tpu_torch.errors import InvalidArgumentError, OutOfRangeError


def _pulls(trav, eof, n):
    """n pulls as a list of (indices, count) or "EOF"."""
    out = []
    for _ in range(n):
        try:
            out.append(trav.next())
        except eof:
            out.append("EOF")
    return out


@pytest.mark.parametrize("strategy", ["by_order", "shuffle", "random"])
@pytest.mark.parametrize("size,batch", [(23, 5), (20, 5), (3, 8), (1, 1)])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal_the_jax_traverser_exactly(strategy, size, batch, seed):
    mine = Traverser(size, batch, strategy=strategy, seed=seed)
    ref = JaxTraverser(size, batch, strategy=strategy, seed=seed)
    # more than two epochs of pulls, EOFs included
    n = 2 * (-(-size // batch) + 1) + 3
    got, want = _pulls(mine, OutOfRangeError, n), _pulls(
        ref, JaxOutOfRangeError, n)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
            continue
        assert g[1] == w[1]
        assert g[0].dtype == w[0].dtype and g[0].shape == (batch,)
        np.testing.assert_array_equal(g[0], w[0])
    assert mine.epoch == ref.epoch
    if strategy == "random":
        assert "EOF" not in got and mine.epoch == 0
    else:
        assert got.count("EOF") >= 2 and mine.epoch == got.count("EOF")


def test_partial_last_batch_is_padded_circularly_with_its_true_count():
    trav = Traverser(7, 5, strategy="by_order")
    first, n1 = trav.next()
    last, n2 = trav.next()
    assert (n1, n2) == (5, 2)
    np.testing.assert_array_equal(first, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(last, [5, 6, 5, 6, 5])
    with pytest.raises(OutOfRangeError):
        trav.next()
    # the error reset the cursor: the next epoch starts over
    assert trav.epoch == 1
    np.testing.assert_array_equal(trav.next()[0], first)


def test_shuffle_draws_a_fresh_permutation_each_epoch():
    trav = Traverser(12, 4, strategy="shuffle", seed=3)
    epochs = []
    for _ in range(2):
        seen = np.concatenate([trav.next()[0] for _ in range(3)])
        assert sorted(seen.tolist()) == list(range(12))
        epochs.append(seen)
        with pytest.raises(OutOfRangeError):
            trav.next()
    assert not np.array_equal(epochs[0], epochs[1])


@pytest.mark.parametrize("kwargs", [dict(size=0, batch_size=4),
                                    dict(size=4, batch_size=0),
                                    dict(size=4, batch_size=2,
                                         strategy="sorted")])
def test_bad_arguments_raise(kwargs):
    with pytest.raises(InvalidArgumentError):
        Traverser(**kwargs)
