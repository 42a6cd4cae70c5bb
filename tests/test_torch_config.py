"""Port parity: tracker configs and the version flags of motcpp_tpu_torch
against the JAX package's.

The port reads ``configs/trackers/*.yaml`` with its own reader of the
YAML subset the configs use (the card's machine has no PyYAML); on every
shipped config and on a set of edge lines its dict equals
``yaml.safe_load``'s, and outside the subset it raises ValueError. The
loaded configs, their kwargs and their seeded search-space draws equal
the JAX package's exactly. This file imports PyYAML; the port never does.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import motcpp_tpu
import motcpp_tpu.config as jax_config
import motcpp_tpu_torch
import test_data
import torch_threads  # noqa: F401  (torch at one thread)
from jax_cases import jax_cases, run_jax_case
from motcpp_tpu_torch import config

# the packages export a function named version, which hides the module
jax_version = importlib.import_module("motcpp_tpu.version")
version = importlib.import_module("motcpp_tpu_torch.version")

ROOT = Path(__file__).resolve().parent.parent
NAMES = sorted(p.stem for p in (ROOT / "configs" / "trackers").glob("*.yaml"))

# YAML 1.1 resolution traps and the other forms of the subset
EDGE_LINES = [
    "a: 1e-5", "a: 1.0e-5", "a: 1e5", "a: 1.5e+3", "a: 1.5e3", "a: .5",
    "a: -.5", "a: 1.", "a: 0.", "a: 1_0.5", "a: -1.5", "a: +0.25",
    "a: yes", "a: on", "a: off", "a: True", "a: FALSE",
    "a: y", "a: n", "a: ~", "a: null", "a: Null", "a:", "a: # comment",
    "a: 0x10", "a: 0xFF", "a: -0x1f", "a: 1_000", "a: 09", "a: 0o17",
    "a: -0", "a: +1", "a: 0:30", "a: 1.5:30", "a: x # c",
    "a: x#c", "a: x,y", "a: -x", "a: :x", "a: x:y", "a:   spaced value   ",
    'a: ""', "a: ''", "a: 'it''s'", 'a: "q\\"x\\n\\t\\\\"', 'a: "x" # c',
    "a: [10, 61, 10]", "a: []", "a: [~, 1]", "a: [1, .5, 1e-3, 1.0e-3]",
    "a: [a b, 'c', \"d\"] # c", "yes: 1", "a: 2001-12-14x",
    "---\na: 1", "# only a comment\n", "",
    "a:\n  type: uniform\n  default: 0.1\n  range: [0.1, 0.3]\nb: 2",
    "a:\n  # note\n  type: choice  # c\n  choices: [\"iou\", giou]\n\nb: x",
    "a: [1, 0x10, yes]",
]
OUTSIDE = [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x",
    "a:\n  - 1", "- 1", "a: 1\n---\nb: 2", "a:\n  b:\n    c: 1",
    "a: x\n  y", "a: {b: 1}", "a: [1, [2]]", "a: [1,", "a: [1,]",
    "a: 1\na: 2", "a: b: c", "\ta: 1", "a:\n\tb: 1", "a: 2001-12-14",
    "a: <<", "a: =", "a: 'x' y", 'a: "x', "a: [1 #c]", "a: @x", "a: %x",
    "%YAML 1.1\n---\na: 1", "a: 1\n...", "a:b", "1: x", "a:\n  b: 1\n   c: 2",
    "a: -", "a: ? x", "a: [a: 1]", '"a": 1', 'a: "\\q"',
    # forms PyYAML resolves that the subset refuses rather than construct
    "a: .inf", "a: -.Inf", "a: .nan", "a: 010", "a: 0b101", "a: 1:30",
    "a: 1:30.5", "a: [1, 0b1]", 'a: "\\u00e9"', 'a: "\\x41"', 'a: "\\N"',
    "a: 1\r\nb: 2\r\n", "\ufeffa: 1",
]


@pytest.mark.parametrize("name", NAMES)
def test_reader_equals_safe_load_on_shipped_configs(name):
    text = (ROOT / "configs" / "trackers" / f"{name}.yaml").read_text()
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", EDGE_LINES)
def test_reader_equals_safe_load_on_edge_lines(text):
    got, want = config.parse_yaml(text), yaml.safe_load(text)
    # repr: 1 and 1.0 and True compare equal, their types must not differ
    assert repr(got) == repr(want)


@pytest.mark.parametrize("text", OUTSIDE)
def test_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        config.parse_yaml(text)


@pytest.mark.parametrize("name", NAMES)
def test_loaded_config_equals_the_jax_package(name):
    got = config.load_tracker_config(name)
    want = jax_config.load_tracker_config(name)
    assert repr(got.params) == repr(want.params)
    assert got.search_space == want.search_space
    assert got.as_kwargs() == want.as_kwargs()
    assert config.get_tracker_config_path(name) == \
        jax_config.get_tracker_config_path(name)
    assert repr(motcpp_tpu_torch.load_tracker_config(name).params) == \
        repr(motcpp_tpu.load_tracker_config(name).params)


def test_bytetrack_search_draws_equal_the_jax_package():
    """bytetrack.yaml is the one config with search nodes: 20 draws from
    one seeded Generator, as scripts/tune.py makes them."""
    got = config.load_tracker_config("bytetrack")
    want = jax_config.load_tracker_config("bytetrack")
    assert got.search_space
    g, w = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        assert repr(got.sample(g)) == repr(want.sample(w))


def test_sampling_semantics_equal_the_jax_package():
    """tests/test_data.py::test_search_space_sampling_semantics's config
    (uniform, stepped randint, choice, a fixed parameter): the same draws
    as the JAX package, and an unknown node type raises."""
    kw = dict(params={"a": 0.5, "b": 30, "c": "x", "fixed": 7},
              search_space={
                  "a": {"type": "uniform", "range": [0.1, 0.3]},
                  "b": {"type": "randint", "range": [10, 61, 10]},
                  "c": {"type": "choice", "range": ["x", "y", "z"]}})
    got, want = config.TrackerConfig(**kw), jax_config.TrackerConfig(**kw)
    g, w = np.random.default_rng(0), np.random.default_rng(0)
    draws = [got.sample(g) for _ in range(50)]
    assert draws == [want.sample(w) for _ in range(50)]
    assert len({d["b"] for d in draws}) > 2
    bad = config.TrackerConfig(search_space={"k": {"type": "loguniform",
                                                   "range": [1, 2]}})
    with pytest.raises(ValueError):
        bad.sample(g)


@pytest.mark.parametrize("case,name,kwargs", jax_cases(
    test_data, ["test_config_flat_and_tune_styles",
                "test_shipped_configs_load"]))
def test_jax_config_cases_pass_against_the_port(case, name, kwargs,
                                                monkeypatch, tmp_path):
    run_jax_case(test_data, name, kwargs, monkeypatch,
                 {"load_tracker_config": config.load_tracker_config,
                  "TrackerConfig": config.TrackerConfig}, tmp_path=tmp_path)


@pytest.mark.parametrize("name", NAMES)
def test_every_shipped_config_constructs_its_port_tracker(name):
    """The YAML kwargs are accepted verbatim by the port's create_tracker
    (as tests/test_data.py::test_every_shipped_yaml_constructs_its_tracker
    holds the JAX package's)."""
    kw = config.load_tracker_config(name).as_kwargs()
    tr = motcpp_tpu_torch.create_tracker(name, max_tracks=16, max_dets=8,
                                         device="cpu", **kw)
    out = tr.update(np.array([[100, 100, 200, 300, 0.9, 0]], np.float32),
                    np.zeros((480, 640, 3), np.uint8))
    assert out.shape[1] == 8


def test_importing_the_config_reader_leaves_yaml_out():
    code = ("import sys\n"
            "import motcpp_tpu_torch, motcpp_tpu_torch.config as c\n"
            "for n in ('sort', 'bytetrack'): c.load_tracker_config(n)\n"
            "motcpp_tpu_torch.load_tracker_config('botsort')\n"
            "sys.exit(1 if 'yaml' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_version_flags_equal_the_jax_package():
    import torch

    assert motcpp_tpu_torch.__version__ == motcpp_tpu.__version__
    assert motcpp_tpu_torch.version() == motcpp_tpu.version()
    assert (version.VERSION_MAJOR, version.VERSION_MINOR,
            version.VERSION_PATCH) == (jax_version.VERSION_MAJOR,
                                       jax_version.VERSION_MINOR,
                                       jax_version.VERSION_PATCH)
    assert version.has_cv2() == jax_version.has_cv2()
    assert version.has_cuda() == torch.cuda.is_available()
    assert not hasattr(version, "has_tpu")
