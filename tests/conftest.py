"""Shared test configuration.

Provides a tiny deterministic stand-in for ``hypothesis`` when the real
package is unavailable (CI installs it from requirements-dev.txt; the dev
container image does not ship it).  The stub runs each ``@given`` test on a
fixed number of pseudo-random examples — far weaker than real hypothesis
(no shrinking, no failure database), but it keeps the property tests
executable everywhere instead of failing at collection.
"""

from __future__ import annotations

import inspect
import random
import sys
import types

try:  # pragma: no cover - prefer the real thing when present
    import hypothesis  # noqa: F401
except ImportError:
    def _install_stub() -> None:
        mod = types.ModuleType("hypothesis")
        st = types.ModuleType("hypothesis.strategies")

        class Strategy:
            def __init__(self, sample):
                self._sample = sample

            def example_from(self, rnd):
                return self._sample(rnd)

        def integers(min_value=0, max_value=100):
            return Strategy(lambda rnd: rnd.randint(min_value, max_value))

        def floats(min_value=0.0, max_value=1.0, allow_nan=None,
                   allow_infinity=None, width=64):
            return Strategy(lambda rnd: rnd.uniform(min_value, max_value))

        def booleans():
            return Strategy(lambda rnd: rnd.random() < 0.5)

        def sampled_from(seq):
            items = list(seq)
            return Strategy(lambda rnd: rnd.choice(items))

        def just(value):
            return Strategy(lambda rnd: value)

        def composite(fn):
            def call(*args, **kwargs):
                def sample(rnd):
                    def draw(strategy):
                        return strategy.example_from(rnd)

                    return fn(draw, *args, **kwargs)

                return Strategy(sample)

            return call

        def settings(max_examples=20, deadline=None, **_ignored):
            def deco(fn):
                fn._stub_max_examples = max_examples
                return fn

            return deco

        def given(*arg_strategies, **kw_strategies):
            if arg_strategies:
                raise NotImplementedError(
                    "hypothesis stub supports keyword @given arguments only")

            def deco(fn):
                sig = inspect.signature(fn)
                remaining = [p for name, p in sig.parameters.items()
                             if name not in kw_strategies]

                def wrapper(*args, **kwargs):
                    n = (getattr(wrapper, "_stub_max_examples", None)
                         or getattr(fn, "_stub_max_examples", None) or 20)
                    rnd = random.Random(0)
                    for _ in range(n):
                        drawn = {k: s.example_from(rnd)
                                 for k, s in kw_strategies.items()}
                        fn(*args, **{**kwargs, **drawn})

                wrapper.__name__ = fn.__name__
                wrapper.__doc__ = fn.__doc__
                # pytest must not mistake the drawn parameters for fixtures
                wrapper.__signature__ = sig.replace(parameters=remaining)
                return wrapper

            return deco

        st.integers = integers
        st.floats = floats
        st.booleans = booleans
        st.sampled_from = sampled_from
        st.just = just
        st.composite = composite
        mod.given = given
        mod.settings = settings
        mod.strategies = st
        mod.__stub__ = True
        sys.modules["hypothesis"] = mod
        sys.modules["hypothesis.strategies"] = st

    _install_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where no CUDA device is visible")
