"""Shared test configuration.

Registers the ``slow`` marker and, when the real ``hypothesis`` package is
absent (the pinned container does not ship it), installs a minimal
deterministic stand-in: ``@given`` sweeps each strategy's boundary values
plus seeded random draws, so the property tests still exercise a spread of
inputs without the dependency.
"""
import functools
import random
import sys
import types


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running multi-device test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


try:
    import hypothesis  # noqa: F401
except ImportError:

    class _Strategy:
        def __init__(self, lo=None, hi=None, choices=None, is_float=False):
            self.lo, self.hi = lo, hi
            self.choices = choices
            self.is_float = is_float

        def draw(self, rng, i):
            if self.choices is not None:
                if i < len(self.choices):
                    return self.choices[i]
                return rng.choice(self.choices)
            if i == 0:
                return self.lo
            if i == 1:
                return self.hi
            if self.is_float:
                return rng.uniform(self.lo, self.hi)
            return rng.randint(self.lo, self.hi)

    def _integers(min_value, max_value):
        return _Strategy(lo=min_value, hi=max_value)

    def _floats(min_value, max_value, **_):
        return _Strategy(lo=min_value, hi=max_value, is_float=True)

    def _sampled_from(elements):
        return _Strategy(choices=list(elements))

    def _given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kw):
                n = getattr(wrapper, "_max_examples",
                            getattr(fn, "_max_examples", 20))
                n = min(n, 25)
                rng = random.Random(0)
                for i in range(n):
                    draw = {name: s.draw(rng, i)
                            for name, s in strategies.items()}
                    fn(*args, **kw, **draw)
            # pytest must not see the strategy params as fixtures
            if hasattr(wrapper, "__wrapped__"):
                del wrapper.__wrapped__
            return wrapper
        return deco

    def _settings(max_examples=20, deadline=None, **_):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    _mod = types.ModuleType("hypothesis")
    _mod.given = _given
    _mod.settings = _settings
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.sampled_from = _sampled_from
    _mod.strategies = _st
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _st
