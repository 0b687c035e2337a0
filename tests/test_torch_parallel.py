"""The port's one-process device mesh (``parallel/mesh.py``), fold
parallelism (``parallel/fold_parallel.py``) and spatial stripes
(``parallel/spatial.py``) against the JAX package's on the CPU: the mesh
policies for 1 to 16 devices, the constructors on N logical ``cpu``
devices against the JAX ones on its virtual CPU devices
(``tests/conftest.py``), the fold combine against the sequential fold loop
and ``fold_parallel_argmax``, and the halo stripes against
``spatial_shard_forward``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.convert.espnet_import import (
    state_dict_to_variables,
)
from glomeruli_segmentation_tpu.models.espnet import ESPNet as JaxESPNet
from glomeruli_segmentation_tpu.parallel import fold_parallel as jax_fp
from glomeruli_segmentation_tpu.parallel import mesh as jax_mesh
from glomeruli_segmentation_tpu.parallel import spatial as jax_spatial
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.models.espnet import ESPNet
from glomeruli_segmentation_tpu_torch.parallel import fold_parallel
from glomeruli_segmentation_tpu_torch.parallel import mesh
from glomeruli_segmentation_tpu_torch.parallel import spatial
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


def _outcome(fn, *args, **kwargs):
    """A constructor's mesh shape, or its error's type and message up to
    the device wording (the JAX package says "jax device(s)")."""
    try:
        m = fn(*args, **kwargs)
    except ValueError as e:
        return "ValueError", str(e).split(" device(s)")[0].split(
            " jax")[0]
    return None if m is None else dict(m.shape)


def test_auto_policies_match_jax_for_1_to_16_devices():
    for n in range(1, 17):
        for batch in (8, 32, 48, 7):
            assert mesh.auto_data_parallel(batch, n) == \
                jax_mesh.auto_data_parallel(batch, n)
            for folds in (1, 2, 3, 5):
                assert mesh.resolve_auto_mesh(folds, batch, n) == \
                    jax_mesh.resolve_auto_mesh(folds, batch, n), (n, batch,
                                                                 folds)
    # the documented examples
    assert [mesh.resolve_auto_mesh(5, 48, n) for n in (8, 16, 12, 4)] == \
        [(8, 1), (8, 2), (6, 2), (4, 1)]
    # the default device count is the visible cards' (none here)
    assert mesh.resolve_auto_mesh(5, 32) == (0, 0) or torch.cuda.is_available()


def test_constructors_match_jax_on_eight_devices():
    """The JAX tests' 8 virtual CPU devices against 8 logical ``cpu``
    devices: the same shapes and the same refusals."""
    assert len(jax.devices()) == 8
    for n in range(1, 10):
        assert _outcome(mesh.make_mesh, n, devices=cpus(8)) == \
            _outcome(jax_mesh.make_mesh, n)
    for dp in (0, 1, 2, 3, 4, 8, -1, 9):
        for batch in (8, 32, 48, 6):
            assert _outcome(mesh.make_data_mesh, dp, batch,
                            devices=cpus(8)) == \
                _outcome(jax_mesh.make_data_mesh, dp, batch), (dp, batch)
    for fold, data, batch in ((4, 2, 8), (-1, 2, 8), (-1, 0, 8), (4, 2, 7),
                              (8, 2, 8), (4, -1, 8), (2, 1, 32), (5, 1, 4),
                              (0, 2, 8)):
        assert _outcome(mesh.make_fold_mesh, fold, data, batch,
                        devices=cpus(8)) == \
            _outcome(jax_mesh.make_fold_mesh, fold, data, batch)
    m = mesh.make_fold_mesh(4, 2, 8, devices=cpus(8))
    assert m.axis_names == ("fold", "data") and m.size == 8
    assert mesh.make_mesh(4, model_parallelism=2, devices=cpus(4)).shape \
        == dict(jax_mesh.make_mesh(4, model_parallelism=2).shape)
    # without a device list the mesh takes the visible cards: none here
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested a 2-device mesh but "
                                             "only 0"):
            mesh.make_mesh(2)


def test_shard_replicate_and_replicas():
    m = mesh.make_mesh(4, devices=cpus(4))
    batch = np.arange(8 * 3).reshape(8, 3)
    parts = mesh.shard_batch(m, batch)
    assert [p.tolist() for p in parts] == [batch[i:i + 2].tolist()
                                           for i in range(0, 8, 2)]
    copies = mesh.replicate(m, {"w": torch.ones(2), "b": [torch.zeros(1)]})
    assert len(copies) == 4 and copies[0] is copies[3]
    assert mesh.batch_sharding(m).spec == ("data",)
    assert mesh.replicated(m).spec == ()
    built = []
    reps = mesh.Replicas.build(cpus(4), lambda d: built.append(d) or d)
    assert built == [CPU] and reps.streams == [None] * 4
    out = reps.run(lambda rep, dev, a, b: (a.tolist(), b.tolist()),
                   batch, batch[:, 0])
    assert [o[1] for o in out] == [[0, 3], [6, 9], [12, 15], [18, 21]]
    assert reps.submit(lambda rep, dev, a: a.sum(), batch) == [
        a.sum() for a in np.split(batch, 4)]
    assert mesh.Replicas([CPU], [None], [None]).submit(
        lambda rep, dev, a: 7, batch) == 7
    with pytest.raises(ValueError, match="multiple of the data-axis size 4"):
        reps.run(lambda *a: None, batch[:6])


def _ensemble(n_folds, seed=0):
    """(port stacked state, JAX stacked variables, mean, std) of
    ``n_folds`` ESPNet(5, 1, 2) folds with calibrated BN statistics."""
    sds = [random_state_dict(seed + k, 5, p=1, q=2, calib_size=(32, 64))
           for k in range(n_folds)]
    stacked = fold_parallel.stack_states(sds)
    variables = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        state_dict_to_variables({k: v.numpy() for k, v in sd.items()})
        for sd in sds])
    rng = np.random.RandomState(seed)
    mean = rng.uniform(150, 220, (n_folds, 3)).astype(np.float32)
    std = rng.uniform(20, 45, (n_folds, 3)).astype(np.float32)
    return stacked, variables, mean, std


def _sequential_argmax(stacked, mean, std, x):
    """The sequential fold loop: ordered sum of the (1.0-weighted) fold
    softmaxes, then the argmax."""
    acc = None
    with torch.no_grad():
        for f in range(len(mean)):
            net = ESPNet(5, 1, 2)
            net.load_state_dict(fold_parallel.unstack(stacked, f))
            net.eval()
            xn = (x - torch.from_numpy(mean[f])) / torch.from_numpy(
                std[f]) / 255.0
            logits = net(xn.permute(0, 3, 1, 2).contiguous())
            probs = 1.0 * torch.softmax(logits.float(), dim=1)
            acc = probs if acc is None else acc + probs
    return torch.argmax(acc, dim=1).to(torch.uint8).numpy()


@pytest.mark.parametrize("n_folds,n_dev", [(5, 4), (3, 2), (2, 1), (6, 2)])
def test_fold_parallel_matches_sequential_and_jax(n_folds, n_dev):
    """5 folds over 4 devices (3 zero-weight pads), 3 over 2 (one pad), 2
    over 1, 6 over 2 (3 a device): the exact combine equals the
    sequential fold loop bit for bit and the JAX package's
    ``fold_parallel_argmax``; the partial-sum combine's argmax too."""
    stacked, variables, mean, std = _ensemble(n_folds, seed=n_folds)
    rng = np.random.RandomState(1)
    x = rng.uniform(0, 255, (2, 32, 64, 3)).astype(np.float32)
    expect = _sequential_argmax(stacked, mean, std, torch.from_numpy(x))
    assert len(np.unique(expect)) >= 2
    m = mesh.make_mesh(n_dev, devices=cpus(n_dev))
    model = ESPNet(5, 1, 2)
    got = fold_parallel.fold_parallel_argmax(m, model, stacked, mean, std, x)
    np.testing.assert_array_equal(got.numpy(), expect)
    want = np.asarray(jax_fp.fold_parallel_argmax(
        jax_mesh.make_mesh(n_dev), JaxESPNet(5, 1, 2), variables,
        jnp.asarray(mean), jnp.asarray(std), jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    got = fold_parallel.fold_parallel_argmax(m, model, stacked, mean, std,
                                             x, exact=False)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_fold_parallel_composes_with_a_data_axis():
    """A (data 2, fold 2) mesh: each column runs its batch shard through
    the fold slices; the class maps equal the sequential loop's on the
    whole batch.  A batch the data axis does not divide raises."""
    stacked, _, mean, std = _ensemble(3, seed=4)
    rng = np.random.RandomState(5)
    x = rng.uniform(0, 255, (4, 32, 64, 3)).astype(np.float32)
    m = mesh.Mesh(np.array([[CPU, CPU], [CPU, CPU]], dtype=object),
                  ("data", "fold"))
    ens = fold_parallel.FoldParallelEnsemble(
        m, ESPNet(5, 1, 2), stacked, mean, std, axis_name="fold",
        data_axis="data")
    assert [len(c) for c in ens.columns] == [2, 2]
    assert ens.fold_weights.tolist() == [1.0, 1.0, 1.0, 0.0]
    np.testing.assert_array_equal(
        ens(x).numpy(),
        _sequential_argmax(stacked, mean, std, torch.from_numpy(x)))
    np.testing.assert_array_equal(ens(torch.from_numpy(x)).numpy(),
                                  ens(x).numpy())
    with pytest.raises(ValueError, match="multiple of the 'data' axis"):
        ens(x[:3])


def test_pad_folds_matches_jax():
    stacked, variables, mean, std = _ensemble(5)
    state, mean_p, std_p, w = fold_parallel.pad_folds(
        stacked, torch.from_numpy(mean), torch.from_numpy(std), 8)
    _, jmean, jstd, jw = jax_fp.pad_folds(variables, jnp.asarray(mean),
                                          jnp.asarray(std), 8)
    np.testing.assert_array_equal(mean_p.numpy(), np.asarray(jmean))
    np.testing.assert_array_equal(std_p.numpy(), np.asarray(jstd))
    assert w.tolist() == np.asarray(jw).tolist() == [1.0] * 5 + [0.0] * 3
    assert all(v.shape[0] == 8 for v in state.values())
    key = "encoder.level1.conv.weight"
    assert torch.equal(state[key][6], stacked[key][0])
    _, m4, _, w4 = fold_parallel.pad_folds(
        stacked, torch.from_numpy(mean[:4]), torch.from_numpy(std[:4]), 2)
    assert m4.shape == (4, 3) and w4.tolist() == [1.0] * 4


@pytest.mark.parametrize("n_dev,overlap", [(8, 8), (2, 16), (1, 4)])
def test_spatial_shard_conv_exact_and_matches_jax(n_dev, overlap):
    """A 3x3 convolution's receptive field fits the margin: the striped
    result equals the whole-image convolution, and the JAX package's
    stripes within 1e-5."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 32, 4).astype(np.float32)
    kernel = rng.randn(3, 3, 4, 6).astype(np.float32)
    weight = torch.from_numpy(kernel).permute(3, 2, 0, 1).contiguous()

    def fn(img):
        return torch.nn.functional.conv2d(
            img.permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1)

    got = spatial.spatial_shard_forward(
        mesh.make_mesh(n_dev, devices=cpus(n_dev)), fn,
        torch.from_numpy(x), overlap=overlap)
    np.testing.assert_array_equal(got.numpy(), fn(torch.from_numpy(x)).numpy())

    def jfn(img):
        return jax.lax.conv_general_dilated(
            img, jnp.asarray(kernel), (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = jax_spatial.spatial_shard_forward(jax_mesh.make_mesh(n_dev), jfn,
                                             jnp.asarray(x), overlap=overlap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_spatial_shard_espnet_matches_jax():
    """The whole ESPNet over 4 stripes of 32 rows with 16-row halos: the
    seams are approximate (its receptive field passes the margin) in both
    packages alike, so the port's stripes equal the JAX package's within
    1e-5 of the largest logit."""
    sd = random_state_dict(3, 5, p=1, q=2, calib_size=(32, 64))
    net = ESPNet(5, 1, 2)
    net.load_state_dict(sd)
    net.eval()
    variables = state_dict_to_variables({k: v.numpy() for k, v in sd.items()})
    rng = np.random.RandomState(2)
    x = (rng.uniform(150, 230, (1, 128, 64, 3)).astype(np.float32) - 190) \
        / 30 / 255

    def fn(img):
        with torch.no_grad():
            return net(img.permute(0, 3, 1, 2).contiguous()).permute(
                0, 2, 3, 1)

    got = spatial.spatial_shard_forward(mesh.make_mesh(4, devices=cpus(4)),
                                        fn, torch.from_numpy(x), overlap=16)
    want = np.asarray(jax_spatial.spatial_shard_forward(
        jax_mesh.make_mesh(4), jax.jit(
            lambda i: JaxESPNet(5, 1, 2).apply(variables, i)),
        jnp.asarray(x), overlap=16))
    assert got.shape == want.shape == (1, 128, 64, 5)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="stripes"):
        spatial.spatial_shard_forward(mesh.make_mesh(3, devices=cpus(3)),
                                      fn, torch.from_numpy(x), overlap=4)
    with pytest.raises(ValueError, match="overlap"):
        spatial.spatial_shard_forward(mesh.make_mesh(4, devices=cpus(4)),
                                      fn, torch.from_numpy(x), overlap=33)
