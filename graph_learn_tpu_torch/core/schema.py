"""Data-source schema: ``Decoder``, ``AttrDef``, ``FeatureSpec``, ``Mask``,
``NodeFrom`` and ``mask_type``.

A copy of ``graph_learn_tpu/core/schema.py`` (``Mask``, ``NodeFrom`` and
``mask_type`` of ``:23-58``, ``AttrDef``, ``Decoder`` and ``FeatureSpec``
of ``:61-210``).  Every attribute resolves to one of three dense column
arrays: embedding ids (bucketed ``("int", b)``, hashed ``"string"`` /
``("string", b)``, or any attribute given an embedding dim), numeric
floats (``"float"``, and ``"int"`` read as a number), and multi-value
hashed strings (``("string", b, True)``, padded to ``multival_max_len``
with a length).  ``timestamped`` marks a source whose rows carry an int64
time (``core/schema.py:90-112`` of the JAX package).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple, Union

from graph_learn_tpu_torch.errors import InvalidArgumentError

AttrType = Union[str, Tuple]


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


@dataclasses.dataclass(frozen=True)
class AttrDef:
    """One resolved attribute column."""

    index: int  # position in attr_types
    type_name: str  # "int" | "float" | "string"
    bucket_size: Optional[int]  # hash bucket count, None = no hashing
    is_multival: bool  # comma-separated multi-value string
    dim: Optional[int]  # embedding dim (None/0 -> numeric passthrough)

    @property
    def is_numeric(self) -> bool:
        return (not self.is_multival and self.dim in (None, 0)
                and self.type_name in ("int", "float"))

    @property
    def is_embedding(self) -> bool:
        return not self.is_numeric


class Decoder:
    """Schema of a node or edge source.

    - ``attr_types``: "int" | "float" | "string" | ("int", bucket) |
      ("string", bucket) | ("string", bucket, True) (multi-value);
    - ``attr_dims``: per-attribute embedding dim (None: numeric for "int"
      and "float"; an embedding column of 8 for the others);
    - ``attr_delimiter`` joins the attributes of one row in a source
      string, ``multival_max_len`` caps a multi-value column's items;
    - ``weighted`` / ``labeled`` / ``timestamped`` flags.

    ``int_attrs`` are the embedding-id columns (neither numeric nor
    multi-value), ``float_attrs`` the numeric ones and ``multival_attrs``
    the multi-value ones, each in attribute order.
    """

    def __init__(self,
                 weighted: bool = False,
                 labeled: bool = False,
                 timestamped: bool = False,
                 attr_types: Optional[Sequence[AttrType]] = None,
                 attr_delimiter: str = ":",
                 attr_dims: Optional[Sequence[Optional[int]]] = None,
                 multival_max_len: int = 8):
        self.weighted = bool(weighted)
        self.labeled = bool(labeled)
        self.timestamped = bool(timestamped)
        self.attr_delimiter = attr_delimiter
        self.multival_max_len = multival_max_len
        attr_types = list(attr_types or [])
        attr_dims = list(attr_dims) if attr_dims else [None] * len(attr_types)
        if len(attr_dims) != len(attr_types):
            raise InvalidArgumentError(
                "attr_dims size must equal attr_types size, got %d vs %d"
                % (len(attr_dims), len(attr_types)))
        self.attr_types = attr_types
        self.attr_dims = attr_dims
        self.attrs: List[AttrDef] = [
            self._resolve(i, t, d)
            for i, (t, d) in enumerate(zip(attr_types, attr_dims))]
        self.attributed = bool(self.attrs)
        self.int_attrs = [a for a in self.attrs
                          if not a.is_multival and a.is_embedding]
        self.float_attrs = [a for a in self.attrs if a.is_numeric]
        self.multival_attrs = [a for a in self.attrs if a.is_multival]

    @staticmethod
    def parse(attr_type: AttrType) -> Tuple[str, Optional[int], bool]:
        """One attr_types entry -> (type_name, bucket, multival)."""
        if isinstance(attr_type, str):
            return attr_type, None, False
        if isinstance(attr_type, (tuple, list)):
            items = list(attr_type) + [None] * (3 - len(attr_type))
            return items[0], items[1], bool(items[2])
        raise InvalidArgumentError("invalid attr_type %r" % (attr_type,))

    def _resolve(self, index: int, attr_type: AttrType,
                 dim: Optional[int]) -> AttrDef:
        type_name, bucket, multival = self.parse(attr_type)
        if type_name not in ("int", "float", "string"):
            raise InvalidArgumentError("unknown attr type %r" % type_name)
        if type_name == "float" and (bucket or multival):
            raise InvalidArgumentError("float attrs take no bucket/multival")
        if multival and type_name != "string":
            raise InvalidArgumentError("multival only supported for string")
        return AttrDef(index, type_name, bucket, multival, dim)

    @property
    def int_attr_num(self) -> int:
        return len(self.int_attrs)

    @property
    def float_attr_num(self) -> int:
        return len(self.float_attrs)

    @property
    def multival_attr_num(self) -> int:
        return len(self.multival_attrs)

    @property
    def has_property(self) -> bool:
        return (self.weighted or self.labeled or self.timestamped
                or self.attributed)

    def feature_spec(self) -> "FeatureSpec":
        return FeatureSpec(self)

    def __repr__(self):
        return ("Decoder(weighted=%s, labeled=%s, timestamped=%s, attrs=%r)"
                % (self.weighted, self.labeled, self.timestamped, self.attrs))


class FeatureSpec:
    """The numeric, embedding and multi-value column descriptors of a
    decoder, in attribute order, for feature columns."""

    def __init__(self, decoder: Decoder):
        self.decoder = decoder
        self.numeric: List[AttrDef] = decoder.float_attrs
        self.embeddings: List[AttrDef] = decoder.int_attrs
        self.multivals: List[AttrDef] = decoder.multival_attrs

    @property
    def total_dim(self) -> int:
        """Numeric columns plus the embedding dims given (a column without
        one counts 0 here, as in the JAX package)."""
        d = len(self.numeric)
        for a in self.embeddings + self.multivals:
            d += a.dim or 0
        return d
