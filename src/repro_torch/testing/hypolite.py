"""Deterministic fallback for the subset of `hypothesis` the test suite uses,
the port's copy of ``repro.testing.hypolite`` (the same draws).

Where the real ``hypothesis`` package is unavailable, aliasing this module
into ``sys.modules["hypothesis"]`` lets the property-based tests still
*execute* — each ``@given`` runs against a deterministic sample of the
strategy space (endpoints first, then seeded pseudo-random draws) instead
of being skipped.

Supported surface: ``given``, ``settings(max_examples=, deadline=)``, and
``strategies.integers/floats/sampled_from/booleans``.
"""
from __future__ import annotations

import functools
import inspect
import random
import types

DEFAULT_MAX_EXAMPLES = 20


class _Strategy:
    """A value source: deterministic edge cases first, then seeded draws."""

    def __init__(self, edges, draw):
        self._edges = list(edges)
        self._draw = draw

    def sample(self, i: int, rng: random.Random):
        if i < len(self._edges):
            return self._edges[i]
        return self._draw(rng)


def integers(min_value: int, max_value: int) -> _Strategy:
    edges = sorted({min_value, max_value, (min_value + max_value) // 2})
    return _Strategy(edges, lambda r: r.randint(min_value, max_value))


def floats(min_value: float, max_value: float, **_ignored) -> _Strategy:
    edges = [min_value, max_value, (min_value + max_value) / 2.0]
    return _Strategy(edges, lambda r: r.uniform(min_value, max_value))


def sampled_from(elements) -> _Strategy:
    elements = list(elements)
    return _Strategy(elements, lambda r: r.choice(elements))


def booleans() -> _Strategy:
    return _Strategy([False, True], lambda r: r.random() < 0.5)


def settings(max_examples: int = DEFAULT_MAX_EXAMPLES, deadline=None,
             **_ignored):
    def deco(fn):
        fn._hypolite_max_examples = max_examples
        return fn

    return deco


def given(*arg_strats, **kw_strats):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            n = getattr(wrapper, "_hypolite_max_examples",
                        getattr(fn, "_hypolite_max_examples",
                                DEFAULT_MAX_EXAMPLES))
            rng = random.Random(f"hypolite:{fn.__module__}.{fn.__qualname__}")
            for i in range(n):
                drawn = [s.sample(i, rng) for s in arg_strats]
                kdrawn = {k: s.sample(i, rng) for k, s in kw_strats.items()}
                fn(*args, *drawn, **kwargs, **kdrawn)

        # tolerate @settings applied either above or below @given
        if hasattr(fn, "_hypolite_max_examples"):
            wrapper._hypolite_max_examples = fn._hypolite_max_examples
        # Hide strategy-filled parameters from pytest (it would otherwise
        # try to resolve them as fixtures); leave real fixtures visible.
        sig = inspect.signature(fn)
        params = list(sig.parameters.values())
        params = params[len(arg_strats):]
        params = [p for p in params if p.name not in kw_strats]
        del wrapper.__wrapped__
        wrapper.__signature__ = sig.replace(parameters=params)
        return wrapper

    return deco


strategies = types.SimpleNamespace(
    integers=integers, floats=floats, sampled_from=sampled_from,
    booleans=booleans)
