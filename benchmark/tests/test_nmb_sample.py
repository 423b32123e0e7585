"""What a render cell's check compares: the window keeps only the pixels
drawn from the seed before it, and the kNN shares hold the candidate ids
against every vertex of the mesh."""
import torch

from conftest import tiny_parts


def test_window_keeps_only_the_drawn_pixels():
    from benchmark import harness
    from benchmark.kinds import render
    w, cfg, traffic, check = tiny_parts("neumesh-surface-bf16")
    check.update(every=2, per_frame=16)
    d = harness.driver(traffic["kind"])(cfg, traffic, 99, torch.device("cpu"),
                                        check=check)
    d.window(0.0, limit=5)
    d.release()
    drawn = [b * 2 + int(d.pick[b]) for b in range(3)]
    assert len(d.kept) == sum(n < 5 for n in drawn)
    assert [k[0] for k in d.kept] == [d.views[n] for n in drawn if n < 5]
    for view, pix, tile, outs, ids in d.kept:
        assert len(pix) == len(tile) == 16
        assert all(v.shape[0] == 16 for v in outs.values())
        assert ids.shape[0] == 16 and ids.dtype == torch.int32
    # the same seed draws the same pixels
    assert (render.np.random.default_rng([99, 17]).integers(2, size=3)
            == d.pick[:3]).all()


def _mesh(n=400, seed=0):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(n, 3, generator=g)
    return 0.5 * v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def test_knn_shares_read_nought_with_every_vertex_a_candidate():
    from benchmark.kinds import render
    verts = _mesh()
    o = torch.tensor([[0.0, 0.0, -3.0], [0.1, -0.2, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.1, 1.0]])
    x, ok = render.near_mesh_points(verts, o, d, 0.1, 8)
    assert ok.any()
    foot = x[ok]
    near = torch.cdist(foot, verts).amin(-1)
    assert float(near.max()) < 0.1
    ids = torch.arange(len(verts)).expand(2, -1)
    assert render.knn_miss_shares(verts, ids, x, ok, 8) == (0.0, 0.0)


def test_knn_shares_see_a_lost_nearest_vertex():
    from benchmark.kinds import render
    verts = _mesh()
    o = torch.tensor([[0.0, 0.0, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    x, ok = render.near_mesh_points(verts, o, d, 0.2, 1)
    assert float(x[0, 0, 2]) < 0  # the near side of the sphere
    nearest = int(torch.cdist(x[0], verts).argmin())
    ids = torch.arange(len(verts))
    ids = torch.where(ids == nearest, torch.tensor(len(verts)), ids)[None]
    assert render.knn_miss_shares(verts, ids, x, ok, 8) == (1.0, 1.0)
