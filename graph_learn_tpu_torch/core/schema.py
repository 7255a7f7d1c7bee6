"""Data-source schema: ``Decoder`` (numeric attributes, labels, weights).

The subset of ``graph_learn_tpu/core/schema.py`` that the serving slice
reads.  Numeric attributes (``"float"``, and ``"int"`` read as a number)
become one dense float column each, in attribute order, as in the JAX
package.  Hashed, bucketed and multi-value attributes and timestamps are
not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

from graph_learn_tpu_torch.errors import InvalidArgumentError


class Decoder:
    """Schema of a node or edge source."""

    def __init__(self,
                 weighted: bool = False,
                 labeled: bool = False,
                 timestamped: bool = False,
                 attr_types: Optional[Sequence[str]] = None,
                 attr_dims: Optional[Sequence[Optional[int]]] = None):
        if timestamped:
            raise InvalidArgumentError(
                "timestamped sources are not yet ported")
        attr_types = list(attr_types or [])
        if attr_dims and any(attr_dims):
            raise InvalidArgumentError(
                "embedded attributes (attr_dims) are not yet ported")
        for t in attr_types:
            if t not in ("float", "int"):
                raise InvalidArgumentError(
                    "attr type %r is not yet ported (numeric 'float' and "
                    "'int' only)" % (t,))
        self.weighted = bool(weighted)
        self.labeled = bool(labeled)
        self.timestamped = False
        self.attr_types = attr_types
        self.attributed = bool(attr_types)

    @property
    def float_attr_num(self) -> int:
        return len(self.attr_types)

    @property
    def int_attr_num(self) -> int:
        return 0

    @property
    def multival_attr_num(self) -> int:
        return 0

    def __repr__(self):
        return ("Decoder(weighted=%s, labeled=%s, float_attrs=%d)"
                % (self.weighted, self.labeled, self.float_attr_num))
