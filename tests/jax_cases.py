"""Runs a test function of the JAX package's suite against the port.

``jax_cases(module, names)`` lists the cases of the named test functions
of ``module`` (a ``tests/test_*.py`` module), one per combination of
their ``parametrize`` marks; ``run_jax_case`` calls one with names of
the module replaced (``monkeypatch``) by the port's counterparts, and
with modules of the JAX package that the function imports inside its
body replaced in ``sys.modules`` by the port's, so the JAX package's own
assertions hold the port.
"""

import inspect
import itertools
import sys


def jax_cases(module, names):
    """[(id, name, kwargs)] for every parametrised case of ``names``."""
    cases = []
    for name in names:
        fn = getattr(module, name)
        grids = []
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            argnames, values = mark.args[:2]
            argnames = [a.strip() for a in argnames.split(",")] \
                if isinstance(argnames, str) else list(argnames)
            grids.append([dict(zip(argnames, v if len(argnames) > 1
                                   else (v,))) for v in values])
        for combo in itertools.product(*grids):
            kwargs = {k: v for d in combo for k, v in d.items()}
            tag = "-".join(str(v) for v in kwargs.values())
            cases.append((f"{name}[{tag}]" if tag else name, name, kwargs))
    return cases


def run_jax_case(module, name, kwargs, monkeypatch, replacements=None,
                 modules=None, **fixtures):
    """Call ``module.name(**kwargs)`` with ``replacements`` ({name:
    object}) patched into the module, ``modules`` ({dotted name: port
    module}) patched into ``sys.modules`` (so ``from motcpp_tpu.x import
    y`` inside the function reads the port's ``y``), and the fixtures it
    asks for from ``fixtures``."""
    for attr, value in (replacements or {}).items():
        monkeypatch.setattr(module, attr, value)
    for dotted, value in (modules or {}).items():
        monkeypatch.setitem(sys.modules, dotted, value)
    fn = getattr(module, name)
    wanted = inspect.signature(fn).parameters
    fn(**kwargs, **{p: fixtures[p] for p in wanted if p not in kwargs})
