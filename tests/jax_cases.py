"""Runs a test function of the JAX package's suite against the port,
and gives the port's tests the JAX package's native parser.

``jax_cases(module, names)`` lists the cases of the named test functions
of ``module`` (a ``tests/test_*.py`` module), one per combination of
their ``parametrize`` marks; ``run_jax_case`` calls one with names of
the module replaced (``monkeypatch``) by the port's counterparts, and
with modules of the JAX package that the function imports inside its
body replaced in ``sys.modules`` by the port's, so the JAX package's own
assertions hold the port.

``jax_native_parser`` is the fixture through which every port test
reaches the JAX package's native IO (``motcpp_tpu.utils.native_io``):
a test file imports it (``from jax_cases import jax_native_parser``) and
a test that reads or writes through the JAX package's dataset, writer or
CLI asks for it (``tests/test_torch_golden.py`` fails otherwise).
"""

import inspect
import itertools
import sys

import pytest


@pytest.fixture
def jax_native_parser(monkeypatch, tmp_path):
    """The JAX package's native parser, built into a library of this test
    and loaded from it. ``native_io`` builds ``native/libmotcpp_io.so``
    in place at first use and keeps a failed load for the rest of the
    process, so under several workers one process can open another's
    half-written library and then parse with the Python fallback, which
    rounds otherwise. A library no other process writes is complete once
    its build returns."""
    from motcpp_tpu.utils import native_io

    monkeypatch.setattr(native_io, "_SO", tmp_path / "libmotcpp_io.so")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_tried", False)
    assert native_io.available(), "the JAX package's native parser did not build"
    return native_io


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
