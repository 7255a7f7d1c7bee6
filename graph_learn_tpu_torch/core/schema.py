"""Data-source schema: ``Decoder`` (numeric attributes, labels, weights,
timestamps), ``Mask``, ``NodeFrom`` and ``mask_type``.

The subset of ``graph_learn_tpu/core/schema.py`` that the port reads
(``Mask``, ``NodeFrom`` and ``mask_type`` are copies of ``:23-58``).  Numeric attributes (``"float"``, and ``"int"`` read as a number)
become one dense float column each, in attribute order, as in the JAX
package.  ``timestamped`` marks a source whose rows carry an int64 time
(``core/schema.py:90-112`` of the JAX package).  Hashed, bucketed and
multi-value attributes are not ported yet and raise.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

from graph_learn_tpu_torch.errors import InvalidArgumentError


class Mask(enum.Enum):
    """Train/val/test split selector: a masked split is a virtual node type
    named by prefixing the type (reference python/utils.py:44-63)."""

    NONE = 0
    TRAIN = 1
    VAL = 2
    TEST = 3

    def decorate(self, type_name: str) -> str:
        if self == Mask.NONE:
            return type_name
        return "MASK" + "*" * self.value + type_name


class NodeFrom(enum.Enum):
    """Seed space selector for ``V()``: NODE iterates a node table or set,
    EDGE_SRC / EDGE_DST the distinct src / dst nodes of an EDGE type."""

    NODE = 0
    EDGE_SRC = 1
    EDGE_DST = 2


def mask_type(type_name: str, mask: "Mask | str | None") -> str:
    if mask is None:
        return type_name
    if isinstance(mask, str):
        mask = Mask[mask.upper()]
    return mask.decorate(type_name)


class Decoder:
    """Schema of a node or edge source."""

    def __init__(self,
                 weighted: bool = False,
                 labeled: bool = False,
                 timestamped: bool = False,
                 attr_types: Optional[Sequence[str]] = None,
                 attr_dims: Optional[Sequence[Optional[int]]] = None):
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
        self.timestamped = bool(timestamped)
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
        return ("Decoder(weighted=%s, labeled=%s, timestamped=%s, "
                "float_attrs=%d)" % (self.weighted, self.labeled,
                                     self.timestamped, self.float_attr_num))
