"""field_fused_edit, the texture-edited shade in one launch: its plain
version against the bound editable's context-math shade
(RayBoundTextureEditable._shade) and the JAX package's bound editable, in
f32 and bf16, with one and two references, with and without the
rotation; contexts without an edited vertex shaded bit for bit as
field_fused's `full` plain version; the editable's route to it; its
shared-memory plan at the flagship width. The CUDA kernel is held against
the plain version on a card in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumesh_tpu.editing.texture_model import (
    TextureEditableNeuMesh as JEditable, make_editable_params)
from neumesh_tpu_torch.editing import texture_model
from neumesh_tpu_torch.editing.texture_model import TextureEditableNeuMesh
from neumesh_tpu_torch.ops import kernels
from neumesh_tpu_torch.utils.state import editable_from_jax
from test_torch_cuda import (FLAGSHIP_PRECISIONS, edit_inputs,
                             flagship_weights, torch_edit, torch_field)
from test_torch_editing_model import (T_Y180, _near_far, _rays, _samples,
                                      _scenes)

# 90 degrees about x: the second reference's frame
T_X90 = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0],
                  [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


def editable_refs(bf16: bool, n_refs: int, rotate: bool):
    """(JAX editable, its params, the port's editable): main seed 0, the
    references seed 1 then the main model itself, each with its own edit
    region and transferred codes."""
    (jm, p_main, tm), (jr, p_ref, tr) = _scenes(bf16)
    for m in (jm, tm, jr, tr):
        m.use_pallas = False
        m.use_fused_locate = False
    verts = np.asarray(jm.mesh_grid.vertices)
    masks = np.stack([(verts[:, 2] < -0.2) & (verts[:, 0] > 0.1),
                      (verts[:, 2] < -0.1) & (verts[:, 1] > 0.0)])[:n_refs]
    feats = [np.asarray(p_ref["color_features"])[::-1].copy(),
             np.asarray(p_main["color_features"])[::-1].copy()][:n_refs]
    T = [T_Y180, T_X90][:n_refs] if rotate else None
    jed = JEditable(jm, [jr, jm][:n_refs], masks, T_r_m_list=T)
    jp = make_editable_params(p_main, [p_ref, p_main][:n_refs], feats)
    ted = TextureEditableNeuMesh(tm, [tr, tm][:n_refs], masks, T)
    editable_from_jax(jax.tree.map(np.asarray, jp), ted)
    return jed, jp, ted


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("n_refs", [1, 2])
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_edit_plain_matches_the_shade_and_jax(dtype, n_refs, rotate,
                                              monkeypatch):
    """The bound editable's fused route (use_pallas: field_fused_edit's
    plain version on the CPU) against its context-math route on the same
    binding (f32 within 1e-5, bf16 within 2e-2: tests/test_torch_rayctx.py's
    bf16 tolerance) and against the JAX bound editable (1e-4 / 2e-2, as
    tests/test_torch_editing_model.py)."""
    jed, jp, ted = editable_refs(dtype is not None, n_refs, rotate)
    o, d = _rays()
    jn, jf = _near_far(o, d)
    pts, dirs = _samples(o, d, jn, jf)
    tb = ted.bind_rays(torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(jn), torch.from_numpy(jf))
    calls = []
    edit = kernels.field_fused_edit

    def counted(*a, **k):
        calls.append(len(a[7]))
        return edit(*a, **k)
    monkeypatch.setattr(kernels, "field_fused_edit", counted)
    x, v = torch.from_numpy(pts), torch.from_numpy(dirs)
    with torch.no_grad():
        ted.main_model.use_pallas = True
        try:
            sdf_f, rgb_f = tb.forward(x, v)
            # the unedited main model on its fused `full` route
            _, rgb_main = tb.bound.forward(x, v)
        finally:
            ted.main_model.use_pallas = False
        sdf_s, rgb_s = tb.forward(x, v)
    assert calls == [n_refs]
    sdf_j, rgb_j = jax.jit(lambda p, x, v: jed.bind_rays(
        p, *map(jnp.asarray, (o, d, jn, jf))).forward(p, x, v))(
            jp, jnp.asarray(pts), jnp.asarray(dirs))
    near = dict(atol=1e-5, rtol=0) if dtype is None else dict(atol=2e-2)
    jax_tol = dict(atol=1e-4, rtol=1e-4) if dtype is None else dict(atol=2e-2)
    for got, shade, want in ((sdf_f, sdf_s, sdf_j), (rgb_f, rgb_s, rgb_j)):
        np.testing.assert_allclose(got.numpy(), shade.numpy(), **near)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   **jax_tol)
    # the edit engaged on part of the bundle, the rest the main colour
    diff = (rgb_f - rgb_main).abs().amax(-1)
    assert float(diff.max()) > 1e-3 and float(diff.min()) == 0.0


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_contexts_without_edited_vertices_shade_as_full_bit_for_bit(dtype):
    """Contexts whose candidates carry no edit mask: sdf and rgb of the
    edited plain version equal field_fused's `full` plain version bit for
    bit; the edited contexts differ, and the painted count is the samples
    whose kNN picks hold an edited vertex, reference by reference."""
    inp = edit_inputs(seed=3, B=6, S=40, C=48, n_refs=2, clean=(1, 4))
    painted = torch.zeros(1, dtype=torch.int64)
    got = torch_edit(inp, dtype, painted=painted)
    full = torch_field(inp, "full", 8, dtype, ())
    clean, edited = [1, 4], [0, 2, 3, 5]
    for g, f in zip(got, [full[0], *full[4:7]]):
        assert torch.equal(g[clean], f[clean])
    assert not torch.equal(got[1][edited], full[4][edited])
    x = torch.from_numpy(inp["xyz"])
    _, W = kernels._interp_distance(x[..., 0:1], x[..., 1:2], x[..., 2:3],
                                    torch.from_numpy(inp["geo"]), inp["w1"],
                                    8, False)
    want = sum(int(((W * torch.from_numpy(r["mask"])[:, None]).sum(-1)
                    > 0).sum()) for r in inp["refs"])
    assert 0 < int(painted) == want


def test_field_fused_edit_refuses_more_references_than_its_cap():
    inp = edit_inputs(seed=5, B=2, S=10, C=24, n_refs=1)
    inp["refs"] = inp["refs"] * 5
    with pytest.raises(ValueError, match="at most 4"):
        torch_edit(inp, None)


# (use_pallas, the main model's nablas input, the references', references)
ROUTES = {"fused": (True, True, True, 1),
          "fused_at_the_cap": (True, True, True, 4),
          "above_the_cap": (True, True, True, 5),
          "use_pallas_off": (False, True, True, 1),
          "main_without_nablas": (True, False, True, 1),
          "reference_without_nablas": (True, True, False, 1)}


@pytest.mark.parametrize("case", list(ROUTES))
def test_edited_shade_route(case, monkeypatch):
    """The bound editable shades by one field_fused_edit call with
    use_pallas and nablas input on the main model and every reference and
    at most EDIT_REFS references; else by the sliced context math."""
    pallas, nablas, ref_nablas, n = ROUTES[case]
    (_, _, tm), (_, _, tr) = _scenes(False)
    verts = tm.mesh_grid.vertices.numpy()
    mask = np.repeat((verts[:, 0] > 0.1)[None], n, 0)
    ted = TextureEditableNeuMesh(tm, [tr] * n, mask)
    o, d = _rays()
    jn, jf = _near_far(o, d)
    tb = ted.bind_rays(torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(jn), torch.from_numpy(jf))
    routes = []

    def fused(x, *a, **k):
        routes.append("fused")
        return [torch.zeros(x.shape[:2])] * 4

    def shade(self, x, v, rows):
        routes.append("shade")
        return torch.zeros(x.shape[:2]), torch.zeros(x.shape)
    monkeypatch.setattr(kernels, "field_fused_edit", fused)
    monkeypatch.setattr(texture_model.RayBoundTextureEditable, "_shade",
                        shade)
    monkeypatch.setattr(tm, "use_pallas", pallas)
    monkeypatch.setattr(tm, "enable_nablas_input", nablas)
    monkeypatch.setattr(tr, "enable_nablas_input", ref_nablas)
    pts, dirs = _samples(o, d, jn, jf)
    sdf, rgb = tb.forward(torch.from_numpy(pts), torch.from_numpy(dirs))
    assert sdf.shape == pts.shape[:2] and rgb.shape == pts.shape
    want = "fused" if case.startswith("fused") else "shade"
    assert routes == [want]


@pytest.mark.parametrize("C", [1, 8, 70, 96, 128])
@pytest.mark.parametrize("prec", list(FLAGSHIP_PRECISIONS))
def test_edit_smem_plan_fits_at_flagship_width(prec, C):
    """kernels.tile_smem_plan("field_fused_edit", ...) (the mirror of
    field_fused_edit.cu's plan) at the flagship width, one and four
    references, at the A/B's tile shapes, the swap cell's (128 rays x 127
    samples a context) and the per-ray ones: every block within the 227 KB
    a block may use, warp-specialised with a ring of 2..8 slots."""
    dws, cws, kw = flagship_weights(prec)
    low = FLAGSHIP_PRECISIONS[prec][0] and torch.bfloat16
    for n in (1, 4):
        refs = [kernels.EditRef(torch.zeros(1, C, 33), tuple(cws),
                                torch.eye(3), low, kw["multires_ft"],
                                kw["multires_view"])] * n
        for B, S in ((512, 1024), (469, 16256), (4096, 1), (4096, 16),
                     (4096, 127), (7, 37), (1, 65)):
            xyz = torch.zeros(B, S, 3)
            plan = kernels.tile_smem_plan(
                "field_fused_edit", xyz, torch.zeros(B, 8, C),
                torch.zeros(B, C, 64), 0.1, dws, cws, xyz, refs,
                dtype=low, **kw)
            assert plan["fits"] and plan["bytes"] <= 227 * 1024, (B, S, plan)
            assert plan["ws"] and 2 <= plan["ring"] <= 8
