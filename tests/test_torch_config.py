"""The port's config system against the JAX package's: its YAML subset
reader against PyYAML on the shipped configs and on save_yaml dumps, its
writer read back by PyYAML, ConfigDict, the --section:key overrides
against update_config, and load_config's precedence."""
import glob
import os

import numpy as np
import pytest
import yaml

from neumesh_tpu import config as jcfg
from neumesh_tpu_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                           recursive=True))
# values of every type the reader resolves, in block maps and lists
VALUES = {
    "top": {"int": -3, "float": 0.0005, "exp": 1e-05, "big": 1e20,
            "inf": float("inf"), "ninf": float("-inf"), "bool": True,
            "no": False, "none": None, "str": "neumesh",
            "looks_like_float": "1e-5", "looks_like_bool": "yes",
            "empty": "", "quote": "it's", "hash": "a # b",
            "path": "../data/DTU/dtu_scan63", "colon": "a:b"},
    "lists": {"ints": [0, 1, 2], "mixed": [1, 2.5, "x", None, True],
              "empty": [], "strs": ["d0", "dh", "c0", "ch"]},
    "nested": {"deeper": {"deepest": {"k": 1}}, "emptymap": {}},
}


def _same(a, b):
    """Equality that takes nan for nan."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_pyyaml_on_the_shipped_configs(path):
    with open(path) as f:
        text = f.read()
    assert _same(tcfg.parse_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("source", ["values", "scan63"])
def test_reader_equals_pyyaml_on_save_yaml_dumps(tmp_path, source):
    data = (VALUES if source == "values"
            else jcfg.load_yaml(CONFIGS[0]).to_dict())
    path = str(tmp_path / "c.yaml")
    jcfg.save_yaml(data, path)
    with open(path) as f:
        text = f.read()
    assert _same(tcfg.parse_yaml(text), yaml.safe_load(text))
    assert _same(tcfg.load_yaml(path).to_dict(), data)
    # and the port's writer: PyYAML and the port read its dump back
    tcfg.save_yaml(data, path)
    with open(path) as f:
        text = f.read()
    assert _same(yaml.safe_load(text), data)
    assert _same(tcfg.parse_yaml(text), data)


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x", "a: !!str 1", "a: |\n  x\n  y", "a: >\n  x",
    "a: {b: 1}", "- a: 1", "a: 2001-12-14", "a: b\n  c", "a:\n- x\n-\n  - y",
    "a: [1, [2]]", "---\na: 1", "a: 'open", "a: 0x1F", "a: 012",
    "a:\n\tb: 1", "a: 1\n  b: 2"])
def test_reader_raises_outside_its_subset_with_the_line(text):
    with pytest.raises(tcfg.YAMLSubsetError, match=r"line \d+"):
        tcfg.parse_yaml(text)


def test_config_dict_raises_on_missing_keys_and_keeps_defaults():
    c = tcfg.ConfigDict({"a": {"b": 1}})
    assert c.a.b == 1 and isinstance(c.a, tcfg.ConfigDict)
    with pytest.raises(KeyError, match="missing config key"):
        _ = c.a.missing
    assert c.a.setdefault("d", 3) == 3 and c.a.d == 3
    assert c.get("x", {"y": 1}).y == 1
    assert c.to_dict() == {"a": {"b": 1, "d": 3}}


OVERRIDES = [
    ["--model:W", "128", "--model:use_pallas", "true",
     "--training:lr=0.001", "--data:downscale", "2"],
    ["--model:f32_layers", "[d0, dh]", "--model:new:deep", "3",
     "--training:speed_factor", "5", "--expname", "other",
     "--model:compute_dtype", "bf16", "--extra", "1.5e-3"],
    ["--model:bounded_near_far", "0", "--model:N_upsample_iters", "2",
     "--data:val_rayschunk", "64", "--model:max_candidates", "128",
     "--model:unset", "null"],
]


@pytest.mark.parametrize("unknown", OVERRIDES)
def test_overrides_equal_update_config(unknown):
    base = jcfg.load_yaml(CONFIGS[0]).to_dict()
    base["model"]["f32_layers"] = []
    base["model"]["max_candidates"] = None
    want = jcfg.update_config(jcfg.ConfigDict(base), list(unknown))
    got = tcfg.update_config(tcfg.ConfigDict(base), list(unknown))
    assert _same(got.to_dict(), want.to_dict())


def test_load_config_precedence_matches_jax(tmp_path):
    """CLI > --config yaml > defaults, argparse entries copied in, the
    render CLI's flags included."""
    from neumesh_tpu_torch.cli.render import create_render_args
    import render as jrender
    default = tmp_path / "default.yaml"
    default.write_text("model:\n  W: 64\n  D_color: 2\nextra: 1\n")
    argv = ["--config", CONFIGS[0], "--num_views", "3", "--model:W", "32",
            "--render_mode", "surface"]
    ja, ju = jrender.create_render_args(jcfg.create_args_parser()) \
        .parse_known_args(argv)
    ta, tu = create_render_args(tcfg.create_args_parser()) \
        .parse_known_args(argv + ["--device", "cpu"])
    want = jcfg.load_config(ja, ju, base_config_path=str(default))
    got = tcfg.load_config(ta, tu, base_config_path=str(default))
    got_d = got.to_dict()
    assert got_d.pop("device") == "cpu"
    assert _same(got_d, want.to_dict())
    assert got.model.W == 32 and got.model.D_color == 4 and got.extra == 1
    assert got.num_views == 3 and got.render_mode == "surface"
    with pytest.raises(ValueError, match="--config is required"):
        tcfg.load_config(create_render_args(tcfg.create_args_parser())
                         .parse_known_args([])[0])
