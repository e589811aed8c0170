"""Generator-backed design spaces: the cross product as a STREAM.

``DesignSpace.product`` materializes every ``DesignPoint`` up front, which
caps it at ~10^5 points. The joint space this repo has grown (placement
lattice x precision x arch/pe x node) is 10^6-10^8 points — ``LazySpace``
describes the same row-major cross product without ever holding it:

    space = DesignSpace.product_iter(
        "joint", workload="detnet", arch="simba",
        placement=placements, node=(45, 28, 7))
    for sub in space.chunks(4096):       # bounded DesignSpaces
        table = ev.evaluate_table(sub)

Identical iteration order to the eager ``product`` (nested loops over the
axes in declaration order, ``Bind`` values merging their bound fields), so
the streaming parity tests can compare positionally. ``where``/``map``
compose lazily; an unfiltered product additionally supports O(1) random
access (``point_at``), which is what lets the chunked columnar pricer
(``repro_torch.search.stream``) materialize ONLY frontier survivors.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, Tuple

from repro_torch.core.space import (DesignPoint, DesignSpace, _as_axis,
                                    check_axes, product_kwargs)


class LazySpace:
    """Lazy row-major cross product over named axes with composable ops.

    No de-duplication happens during iteration (aliased axis values yield
    their duplicates); ``materialize()`` returns an eager, de-duplicated
    ``DesignSpace``. ``len``/``point_at`` are exact for pure products and
    products composed with ``map``; a ``where`` filter makes the size
    data-dependent, so those raise and iteration is the only protocol.
    """

    def __init__(self, name: str, axes: Dict[str, Any],
                 ops: Tuple[Tuple[str, Callable], ...] = ()):
        self.name = name
        self.axes: Dict[str, Tuple[Any, ...]] = {
            k: _as_axis(v) for k, v in axes.items()}
        check_axes(self.axes)
        for k, vals in self.axes.items():
            if not vals:
                raise ValueError(f"axis {k!r} is empty")
        self._ops = tuple(ops)

    # --- composition --------------------------------------------------------
    def where(self, *predicates: Callable[[DesignPoint], bool]) -> "LazySpace":
        new = LazySpace.__new__(LazySpace)
        new.name, new.axes = self.name, self.axes
        new._ops = self._ops + tuple(("where", p) for p in predicates)
        return new

    def map(self, fn: Callable[[DesignPoint], DesignPoint]) -> "LazySpace":
        new = LazySpace.__new__(LazySpace)
        new.name, new.axes = self.name, self.axes
        new._ops = self._ops + (("map", fn),)
        return new

    # --- geometry -----------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(v) for v in self.axes.values())

    @property
    def is_product(self) -> bool:
        """True iff this is a PURE cross product (no where/map): the shape
        fully determines every point, enabling the compiled chunk pricer."""
        return not self._ops

    @property
    def is_filtered(self) -> bool:
        return any(kind == "where" for kind, _ in self._ops)

    def __len__(self) -> int:
        if self.is_filtered:
            raise TypeError(
                f"len({self.name!r}): size of a where-filtered LazySpace is "
                f"data-dependent; iterate or materialize() instead")
        n = 1
        for s in self.shape:
            n *= s
        return n

    def point_at(self, i: int) -> DesignPoint:
        """Random access into the row-major product (O(axes), no iteration).
        Valid for unfiltered spaces; ``map`` ops are applied."""
        if self.is_filtered:
            raise TypeError(
                f"{self.name!r}.point_at: a where-filtered LazySpace has no "
                f"stable indexing; iterate instead")
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"point {i} of {n}")
        combo = []
        for size, vals in zip(reversed(self.shape),
                              reversed(list(self.axes.values()))):
            combo.append(vals[i % size])
            i //= size
        p = DesignPoint(**product_kwargs(self.axes, tuple(reversed(combo))))
        for _, fn in self._ops:      # only map ops exist here
            p = fn(p)
        return p

    # --- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[DesignPoint]:
        for combo in itertools.product(*self.axes.values()):
            p = DesignPoint(**product_kwargs(self.axes, combo))
            for kind, fn in self._ops:
                if kind == "map":
                    p = fn(p)
                elif not fn(p):
                    break
            else:
                yield p

    def chunks(self, n: int) -> Iterator[DesignSpace]:
        """Bounded eager sub-spaces of <= n points each, in stream order
        (axes metadata carried so ``axis()`` works on every chunk)."""
        if n <= 0:
            raise ValueError(f"chunks({n}): need a positive chunk size")
        it = iter(self)
        for k in itertools.count():
            buf = list(itertools.islice(it, n))
            if not buf:
                return
            yield DesignSpace(buf, name=f"{self.name}[{k}]", axes=self.axes)

    def materialize(self) -> DesignSpace:
        """Eager, de-duplicated ``DesignSpace`` holding every point."""
        return DesignSpace(list(self), name=self.name, axes=self.axes)

    def __repr__(self):
        ax = ", ".join(f"{k}[{len(v)}]" for k, v in self.axes.items())
        ops = "".join(f".{kind}(...)" for kind, _ in self._ops)
        size = "?" if self.is_filtered else str(len(self))
        return f"LazySpace({self.name!r}, {size} points, axes: {ax}){ops}"
