"""The plain reference against the program's CPU path at a small size:
the reference's frames and training steps agree with what the program
computes, before any chip run."""
import numpy as np
import pytest
import torch

from conftest import tiny_parts


def _driver(workload, seed):
    from benchmark import harness
    w, cfg, traffic, check = tiny_parts(workload)
    d = harness.driver(traffic["kind"])(cfg, traffic, seed,
                                        torch.device("cpu"), check=check)
    d.window(0.0, limit=2)
    d.release()
    return d, check


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 5])
def test_volume_frames_agree_with_the_program(seed):
    d, check = _driver("neumesh-volume-f32", seed)
    n = d.check(check)
    # exact f32 on both sides
    assert n["rgb_p50"] < 1e-5 and n["depth_p50"] < 1e-5, n
    assert n["rgb_over_0.05"] < 0.02, n


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 5])
def test_surface_frames_agree_with_the_program(seed):
    d, check = _driver("neumesh-surface-bf16", seed)
    n = d.check(check)
    # the program's hidden layers in bf16, the reference in f32
    assert n["mask_share"] < 0.01 and n["depth_p50"] < 1e-4, n
    assert n["rgb_p50"] < 1e-3 and n["normal_p50"] < 1e-3, n


@pytest.mark.parametrize("workload", ["neus-train", "neumesh-distill-train"])
@pytest.mark.parametrize("seed", [11, 2 ** 40 + 3])
def test_training_steps_agree_with_the_program(workload, seed):
    d, check = _driver(workload, seed)
    n = d.check(check)
    assert n["loss_rel"] < 1e-4 and n["grad_rel"] < 1e-2, n
    assert n["step_rel"] < 2e-2, n


def test_reference_render_of_a_sphere_sdf_hits_the_sphere():
    """The NeuS reference structure on an exact sphere sdf puts the depth
    of a ray through the centre at the sphere's surface."""
    from benchmark.reference import volume

    class Sphere:
        verts = torch.tensor([[0.0, 0.0, -0.5]])

        def density(self, x, ids):
            return torch.linalg.vector_norm(x, dim=-1) - 0.5

        def s(self):
            return torch.tensor(400.0)

        def full(self, x, ids, view):
            sdf = self.density(x, ids)
            return sdf, x, torch.full(x.shape, 0.25)

    o = torch.tensor([[0.0, 0.0, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    r = dict(N_samples=64, N_importance=64, N_upsample_iters=4,
             obj_bounding_radius=1.0)
    rgb, depth, acc = volume.render_rays(Sphere(), o, d,
                                         torch.zeros((1, 1), dtype=torch.long),
                                         r)
    assert abs(float(depth[0]) - 2.5) < 5e-3
    assert np.allclose(rgb.numpy(), 0.25 * float(acc[0]), atol=1e-5)
