"""The port's render CLI against render.py in surface mode (per-ray
contexts, the secant at one ray a context on the fused route); the scene
and the comparison are test_torch_render_cli.py's."""
import pytest

from test_torch_render_cli import assert_pngs_agree, cli_scene, run_both

__all__ = ["cli_scene"]


@pytest.mark.parametrize("use_pallas", ["false", "true"])
def test_surface_cli_matches_render_py(cli_scene, tmp_path, monkeypatch,
                                       use_pallas):
    out = run_both(cli_scene, tmp_path, monkeypatch, "surface", use_pallas)
    assert_pngs_agree(out)
