"""Each fault a cell can have, planted in the program under a run that
skips only the look for a card, makes `correct` come out false: an answer
altered everywhere, one confined to a tenth of the rays, a surface with
no hits, a step that leaves its state unchanged, half the batch; the
unbroken run comes out true. And each cell's control, the reference at
the next lower precision put in the program's place, fails one of the
cell's limits."""
import pytest
import torch

from conftest import tiny_parts, tiny_run


def _scale_rgb(monkeypatch, factor):
    """An answer altered where it is produced: the field kernel's colour
    outputs scaled."""
    from neumesh_tpu_torch.ops import kernels
    orig = kernels.field_fused

    def altered(*a, **kw):
        out = orig(*a, **kw)
        if kw.get("want") == "full":
            out = out[:4] + [o * factor for o in out[4:]]
        return out
    monkeypatch.setattr(kernels, "field_fused", altered)


def _lose_tile_colour(monkeypatch):
    """A fault confined to part of the rays: the field kernel's colour
    outputs lost (black) in one tile context of ten."""
    from neumesh_tpu_torch.ops import kernels
    orig = kernels.field_fused

    def partial(*a, **kw):
        out = orig(*a, **kw)
        if kw.get("want") == "full":
            keep = (torch.arange(out[4].shape[0]) % 10 != 0).to(
                out[4].device)[:, None]
            out = out[:4] + [o * keep for o in out[4:]]
        return out
    monkeypatch.setattr(kernels, "field_fused", partial)


RENDER = ["neumesh-volume-f32", "neumesh-surface-bf16"]
TRAIN = ["neus-train"]


@pytest.mark.parametrize("workload", RENDER + TRAIN)
def test_run_is_correct_unbroken(workload):
    assert tiny_run(workload)["correct"]


@pytest.mark.parametrize("workload", RENDER)
def test_render_answer_altered_is_not_correct(monkeypatch, workload):
    _scale_rgb(monkeypatch, 1.01)
    assert not tiny_run(workload)["correct"]


@pytest.mark.parametrize("workload", RENDER)
def test_render_fault_in_one_tile_of_ten_is_not_correct(monkeypatch,
                                                        workload):
    _lose_tile_colour(monkeypatch)
    assert not tiny_run(workload)["correct"]


def test_surface_with_no_hits_is_not_correct(monkeypatch):
    from neumesh_tpu_torch.render import ray_casting
    orig = ray_casting.render_surface_image

    def blank(*a, **kw):
        rgb, depth, extras = orig(*a, **kw)
        extras = {k: torch.zeros_like(v) for k, v in extras.items()}
        return torch.zeros_like(rgb), depth, extras
    monkeypatch.setattr(ray_casting, "render_surface_image", blank)
    out = tiny_run("neumesh-surface-bf16")
    assert not out["correct"] and out["checked"]["no_hits"]["value"] == 1


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_train_faults_are_not_correct(monkeypatch, workload, fault):
    from neumesh_tpu_torch.train import optimizers, trainer
    if fault == "unchanged":
        monkeypatch.setattr(optimizers.Adam, "step", lambda self: None)
    elif fault == "half_batch":
        orig = trainer.Trainer.render_and_loss

        def half(self, mi, gt, rkw, N_rays, H, W, generator=None,
                 select_inds=None):
            return orig(self, mi, gt, rkw, N_rays, H, W, generator,
                        select_inds[..., :select_inds.shape[-1] // 2])
        monkeypatch.setattr(trainer.Trainer, "render_and_loss", half)
    else:
        orig = trainer.volume_render_rays

        def altered(*a, **kw):
            ret = orig(*a, **kw)
            return dict(ret, rgb=ret["rgb"] * 1.01)
        monkeypatch.setattr(trainer, "volume_render_rays", altered)
    assert not tiny_run(workload)["correct"]


@pytest.mark.parametrize("workload,mode", [
    ("neumesh-volume-f32", "tf32"), ("neumesh-surface-bf16", "fp8"),
    ("neus-train", "tf32")])
def test_control_fails_a_limit(workload, mode):
    from benchmark import harness
    w, cfg, traffic, check = tiny_parts(workload)
    d = harness.driver(traffic["kind"])(cfg, traffic, 5, torch.device("cpu"),
                                        check=check)
    d.window(0.0, limit=2)
    d.release()
    ok, _ = harness.judge(d.check(check), check["limits"])
    assert ok
    ok, rows = harness.judge(d.control(check, mode), check["limits"])
    assert not ok, rows
