"""The port's LPIPS (neumesh_tpu_torch.ops.lpips) against the JAX
package's on synthetic numpy-seeded VGG16 / lin weights (no real weights
ship with the repository): 1e-5 + 1e-4 rel; zero for identical images,
symmetric, batched, None offline, and a torchvision-layout state dict
written by torch.save loads (with and without lin heads)."""
import numpy as np
import pytest
import torch

from neumesh_tpu.ops import lpips as jlpips
from neumesh_tpu_torch.ops.lpips import (_CHANNELS, _VGG_CONVS,
                                         load_lpips_weights, lpips,
                                         lpips_available)

ATOL, RTOL = 1e-5, 1e-4


def synthetic_weights(seed=0):
    rng = np.random.default_rng(seed)
    convs = []
    in_c = 3
    for out_c, _ in _VGG_CONVS:
        convs.append({
            "w": rng.normal(size=(out_c, in_c, 3, 3)).astype(np.float32)
            * (1.0 / np.sqrt(in_c * 9)),
            "b": rng.normal(size=out_c).astype(np.float32) * 0.01,
        })
        in_c = out_c
    lins = [np.abs(rng.normal(size=c)).astype(np.float32) / c
            for c in _CHANNELS]
    return {"convs": convs, "lins": lins, "calibrated": False}


def images(seed, shape=(32, 32, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(size=shape) * 0.1, 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(32, 32, 3), (2, 24, 40, 3)])
def test_lpips_matches_jax(shape):
    w = synthetic_weights(1)
    a, b = images(2, shape)
    want = np.asarray(jlpips.lpips(w, a, b))
    got = lpips(w, a, b, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # tensors in: their device, the same values
    got_t = lpips(w, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got_t.numpy(), want, atol=ATOL, rtol=RTOL)


def test_lpips_zero_symmetric_sensitive_and_batched():
    w = synthetic_weights()
    a, b = images(3)
    c = np.random.default_rng(4).uniform(size=a.shape).astype(np.float32)
    np.testing.assert_allclose(lpips(w, a, a, device="cpu").numpy(), 0.0,
                               atol=1e-6)
    dab = float(lpips(w, a, b, device="cpu")[0])
    dba = float(lpips(w, b, a, device="cpu")[0])
    dac = float(lpips(w, a, c, device="cpu")[0])
    assert dab > 0
    np.testing.assert_allclose(dab, dba, rtol=1e-5)
    assert dac > dab
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    y = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    d = lpips(w, x, y, device="cpu")
    assert d.shape == (3,)
    np.testing.assert_allclose(d[1].item(),
                               lpips(w, x[1], y[1], device="cpu")[0].item(),
                               rtol=1e-5)


def test_lpips_unavailable_offline_and_raises_without_a_card(monkeypatch):
    monkeypatch.delenv("NEUMESH_LPIPS_VGG", raising=False)
    monkeypatch.delenv("NEUMESH_LPIPS_LIN", raising=False)
    assert load_lpips_weights() is None
    assert not lpips_available()
    if not torch.cuda.is_available():
        a, b = images(6, (8, 8, 3))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lpips(synthetic_weights(), a, b)


@pytest.mark.parametrize("with_lin", [False, True])
def test_lpips_loads_torch_state_dicts(tmp_path, monkeypatch, with_lin):
    """torchvision-layout vgg16 (and lpips lin heads) written by
    torch.save: the same weights as the JAX package's reader gives, from
    arguments and from the environment variables."""
    g = torch.Generator().manual_seed(0)
    sd, in_c = {}, 3
    for out_c, idx in _VGG_CONVS:
        sd[f"features.{idx}.weight"] = torch.randn(out_c, in_c, 3, 3,
                                                   generator=g) * 0.05
        sd[f"features.{idx}.bias"] = torch.randn(out_c, generator=g) * 0.01
        in_c = out_c
    vgg = str(tmp_path / "vgg16.pth")
    torch.save(sd, vgg)
    lin = None
    if with_lin:
        lin = str(tmp_path / "vgg.pth")
        torch.save({f"lin{k}.model.1.weight":
                    torch.rand(1, c, 1, 1, generator=g) / c
                    for k, c in enumerate(_CHANNELS)}, lin)
    w = load_lpips_weights(vgg_path=vgg, lin_path=lin)
    wj = jlpips.load_lpips_weights(vgg_path=vgg, lin_path=lin)
    assert w["calibrated"] == wj["calibrated"] == with_lin
    assert w["convs"][0]["w"].shape == (64, 3, 3, 3)
    for cw, cj in zip(w["convs"], wj["convs"]):
        np.testing.assert_array_equal(cw["w"], cj["w"])
        np.testing.assert_array_equal(cw["b"], cj["b"])
    for lw, lj in zip(w["lins"], wj["lins"]):
        np.testing.assert_array_equal(lw, lj)
    monkeypatch.setenv("NEUMESH_LPIPS_VGG", vgg)
    if lin:
        monkeypatch.setenv("NEUMESH_LPIPS_LIN", lin)
    else:
        monkeypatch.delenv("NEUMESH_LPIPS_LIN", raising=False)
    assert lpips_available()
    a, b = images(7, (16, 16, 3))
    np.testing.assert_allclose(
        lpips(load_lpips_weights(), a, b, device="cpu").numpy(),
        np.asarray(jlpips.lpips(wj, a, b)), atol=ATOL, rtol=RTOL)
    assert float(lpips(w, a, a, device="cpu")[0]) < 1e-6
