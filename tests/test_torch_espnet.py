"""The port's ESPNet modules, weight carry-across and folded-BN forward,
against the JAX package's Flax model and FusedESPNet (Pallas interpret)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from glomeruli_segmentation_tpu.convert import espnet_import as jax_import
from glomeruli_segmentation_tpu.models.espnet import create_espnet as flax_espnet
from glomeruli_segmentation_tpu.models.espnet_fused import (
    FusedESPNet as JaxFusedESPNet,
)
from glomeruli_segmentation_tpu_torch.convert import espnet_import as port_import
from glomeruli_segmentation_tpu_torch.models.espnet import create_espnet
from glomeruli_segmentation_tpu_torch.models.espnet_fused import FusedESPNet

CLASSES, P, Q = 5, 2, 2
H, W = 64, 128


def _flax(decoder: bool, seed: int = 0):
    """Random Flax variables with non-trivial BN statistics (numpy)."""
    model = flax_espnet(CLASSES, P, Q, decoder=decoder)
    variables = model.init(jax.random.key(seed), jnp.zeros((1, H, W, 3)))
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(
        lambda a: np.asarray(rng.uniform(0.5, 2.0, a.shape), np.float32),
        variables["batch_stats"])
    return model, {"params": jax.tree.map(np.asarray, variables["params"]),
                   "batch_stats": stats}


@pytest.fixture(scope="module", params=[True, False], ids=["full", "encoder"])
def net(request, tmp_path_factory):
    """(decoder, flax model, variables, .pth path written from the JAX
    package's export, input batch)."""
    decoder = request.param
    model, variables = _flax(decoder)
    path = tmp_path_factory.mktemp("ckpt") / "espnet.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                jax_import.variables_to_state_dict(variables).items()}, path)
    x = np.random.RandomState(1).randn(2, H, W, 3).astype(np.float32)
    return decoder, model, variables, str(path), x


def test_state_dict_from_flax_matches_jax_export(net):
    _, _, variables, _, _ = net
    want = jax_import.variables_to_state_dict(variables)
    got = port_import.state_dict_from_flax(variables)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_infer_architecture_matches_jax(net):
    _, _, _, path, _ = net
    sd = port_import.load_espnet_state_dict(path)
    want = jax_import.infer_architecture(
        {k: v.numpy() for k, v in sd.items()})
    assert port_import.infer_architecture(sd) == want == (
        CLASSES, P, Q, net[0])


def test_espnet_matches_flax(net):
    decoder, model, variables, path, x = net
    torch_net = create_espnet(CLASSES, P, Q, decoder=decoder)
    torch_net.load_state_dict(port_import.load_espnet_state_dict(path),
                              strict=True)
    torch_net.eval()
    with torch.no_grad():
        got = torch_net(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("fuse_level3", [True, False])
def test_fused_espnet_matches_jax(net, fuse_level3):
    decoder, _, variables, path, x = net
    want = np.asarray(JaxFusedESPNet(
        variables, CLASSES, P, Q, interpret=True,
        fuse_level3=fuse_level3)(jnp.asarray(x)))
    fused = FusedESPNet(port_import.load_espnet_state_dict(path),
                        fuse_level3=fuse_level3, device="cpu")
    got = fused(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_load_unwraps_training_checkpoint(net, tmp_path):
    _, _, _, path, _ = net
    sd = port_import.load_espnet_state_dict(path)
    wrapped = tmp_path / "checkpoint.pth.tar"
    torch.save({"epoch": 3, "state_dict": sd}, wrapped)
    again = port_import.load_espnet_state_dict(str(wrapped))
    assert list(again) == list(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


@pytest.mark.parametrize("decoder", [True, False])
def test_random_state_dict(decoder):
    a = port_import.random_state_dict(7, CLASSES, 1, 2, decoder=decoder)
    b = port_import.random_state_dict(7, CLASSES, 1, 2, decoder=decoder)
    c = port_import.random_state_dict(8, CLASSES, 1, 2, decoder=decoder)
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    model = create_espnet(CLASSES, 1, 2, decoder=decoder)
    model.load_state_dict(a, strict=True)
    assert port_import.infer_architecture(a) == (CLASSES, 1, 2, decoder)
    # calibrated BN statistics: a normalised crop gives O(1) logits that
    # vary over the image, not a near-uniform softmax
    rng = np.random.RandomState(0)
    x = rng.uniform(-40, 40, (1, 3, H, W)).astype(np.float32) / 30 / 255
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x))
    assert torch.isfinite(logits).all()
    assert logits.std() > 0.1
    assert len(torch.unique(logits.argmax(1))) > 1
